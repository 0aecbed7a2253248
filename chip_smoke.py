#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root (no arguments needed; ``--seed`` picks the
stream)::

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device   -- the card's name and power limit (``nvidia-smi``);
2. build    -- the CUDA kernels are compiled from ``src/repro_torch/kernels/
               csrc`` (``nvcc``, ``sm_90a``) and loaded;
3. kernels  -- each of the four kernels against its plain PyTorch version
               on the card, at the main path's shapes and on edge cases
               (integers bit-exact, float32 within 3e-5), with its time, the
               plain version's time, one PyTorch library call's time where
               one computes the same function, and its bound;
4. main     -- ``StreamExecutor`` + ``KeyedWindowAdapter`` (fused,
               ``device_table``) over a 1,048,576-key sliding-window stream
               at a real state size (8 x 262,144 table rows on the card),
               with a shrink and a grow; launch counters prove the path ran
               the kernels; a second, traced run gives each of the six
               fused stages' share; the run is held bit-exact against the same
               stream in ops mode ``ref`` and against a numpy group-by of
               every pane assignment; a ``fused=False`` run of the first
               8 chunks drives ``table_lookup``;
5. small    -- spill, TTL and early firing at a small size: kernels vs
               plain, fused vs loop, and the card vs the CPU, bit-identical.

The last lines are a ``kernels`` JSON object, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM published peaks (dense, 700 W): HBM bytes/s and the
#: 32-bit non-tensor-core operation rate (the float32 rate of the data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
F32_TOL = 3e-5

# main-phase configuration: a Nexmark Query 5 style sliding "hot items"
# window, sum + count per key
N_KEYS = 1 << 20
CHUNK = 16384
N_CHUNKS = 36
DEGREE = 8
SCHEDULE = {12: 5, 24: 8}
NUM_SLOTS = 256
CAPACITY = 262144
MAX_PROBES = 16
SIZE, SLIDE, LATENESS = 131072, 32768, 4096
DISORDER = 1024
LOOP_CHUNKS = 8

KERNEL_META = {
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                    "src/repro/kernels/segment_reduce.py:115"),
    "scatter_add": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                    "src/repro/kernels/segment_reduce.py:160"),
    "table_lookup": ("src/repro_torch/kernels/csrc/hash_table.cu",
                     "src/repro/kernels/hash_table.py:111"),
    "batched_table_lookup": ("src/repro_torch/kernels/csrc/hash_table.cu",
                             "src/repro/kernels/hash_table.py:206"),
}


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps, warmup=1):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def make_stream(seed, keyed_stream):
    """1,048,576 distinct int64 keys; items pick one uniformly, values in
    [0, 100), one timestamp per item with +-1,024 disorder."""
    rng = np.random.default_rng(seed)
    universe = np.unique(rng.integers(-2 ** 63, 2 ** 63 - 1,
                                      size=N_KEYS + 4096, dtype=np.int64))
    universe = rng.permutation(universe)[:N_KEYS]
    check(len(universe) == N_KEYS, "key universe too small")
    n = CHUNK * N_CHUNKS
    keys = universe[rng.integers(0, N_KEYS, size=n)]
    values = rng.integers(0, 100, size=n)
    ts = np.arange(n, dtype=np.int64) + rng.integers(-DISORDER, DISORDER + 1,
                                                     size=n)
    return keyed_stream(keys, values, ts)


def pane_assignments(items):
    """Every (key, start, value) pane assignment of the sliding window, in
    numpy — the independent reference's input."""
    ts = items["ts"].astype(np.int64)
    panes = -(-SIZE // SLIDE)
    hi = (ts // SLIDE) * SLIDE
    starts = hi[:, None] - np.arange(panes, dtype=np.int64)[None, :] * SLIDE
    sel = (starts > (ts - SIZE)[:, None]).reshape(-1)
    rep = np.repeat(np.arange(len(ts)), panes)[sel]
    return (items["key"][rep].astype(np.int64), starts.reshape(-1)[sel],
            items["value"][rep].astype(np.int64))


def group_by(key, start, value):
    order = np.lexsort((start, key))
    k, s, v = key[order], start[order], value[order]
    new = np.ones(len(k), bool)
    new[1:] = (k[1:] != k[:-1]) | (s[1:] != s[:-1])
    g = np.flatnonzero(new)
    return (k[g], s[g], np.add.reduceat(v, g),
            np.diff(np.append(g, len(k))).astype(np.int64))


def sorted_rows(key, start, value, count):
    order = np.lexsort((start, key))
    return np.stack([key[order], start[order], value[order], count[order]])


# ---------------------------------------------------------------------------
# output comparison
# ---------------------------------------------------------------------------

def outputs_equal(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for ch in ("emissions", "late", "early"):
            if set(x[ch]) != set(y[ch]):
                return False
            for k in x[ch]:
                if x[ch][k].dtype != y[ch][k].dtype or \
                        not np.array_equal(x[ch][k], y[ch][k]):
                    return False
    return True


def states_equal(a, b):
    return set(a) == set(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(a[k], b[k]) for k in a
    )


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def phase_kernels(torch, items):
    from repro_torch.keyed import dedup_cells, expand_panes, hash_to_slot
    from repro_torch.keyed import WindowSpec
    from repro_torch.kernels import hash_table as ht
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    def t(a):
        return torch.as_tensor(a, device=dev)

    records = {}

    # -- the main path's shapes: chunk 0 of the stream ------------------------
    chunk = items[:CHUNK]
    spec = WindowSpec("sliding", size=SIZE, slide=SLIDE, lateness=LATENESS)
    a_key, a_val, _, _, a_start = expand_panes(
        spec, t(chunk["key"].copy()), t(chunk["value"].copy()),
        t(chunk["ts"].copy()), t(np.arange(CHUNK)),
    )
    cells, inv = dedup_cells(a_key, a_start)
    n_cells, n_rows = len(cells), len(a_key)
    order = torch.argsort(inv, stable=True)
    seg_ids = inv[order].to(torch.int32).contiguous()
    seg_vals = torch.stack([a_val, torch.ones_like(a_val)], 1)[order] \
        .to(torch.int32).contiguous()

    # -- segment_sum ----------------------------------------------------------
    errs = []
    got = sr.segment_sum(seg_vals, seg_ids, n_cells)
    want = ref.segment_sum_ref(seg_vals, seg_ids, n_cells)
    check(torch.equal(got, want), "segment_sum main shape")
    errs.append(0.0)
    # edge cases: ids >= S dropped, int32 wraparound, empty, float32
    e_ids = t(rng.integers(0, 70, 5000).astype(np.int32))
    e_vals = t(rng.integers(2 ** 31 - 200, 2 ** 31, (5000, 3)).astype(np.int32))
    check(torch.equal(sr.segment_sum(e_vals, e_ids, 50),
                      ref.segment_sum_ref(e_vals, e_ids, 50)),
          "segment_sum wraparound / dropped ids")
    empty = sr.segment_sum(torch.zeros((0, 2), dtype=torch.int32, device=dev),
                           torch.zeros(0, dtype=torch.int32, device=dev), 7)
    check(empty.shape == (7, 2) and not empty.any(), "segment_sum empty")
    f_vals = t(rng.standard_normal((5000, 2)).astype(np.float32))
    f_got = sr.segment_sum(f_vals, e_ids, 50)
    f_want = ref.segment_sum_ref(f_vals, e_ids, 50)
    f_err = float((f_got - f_want).abs().max())
    check(torch.allclose(f_got, f_want, atol=F32_TOL, rtol=F32_TOL),
          f"segment_sum float32 error {f_err}")
    errs.append(f_err)
    ms = cuda_ms(torch, lambda: sr.segment_sum(seg_vals, seg_ids, n_cells), 50)
    plain = cuda_ms(torch, lambda: ref.segment_sum_sorted(
        seg_vals, seg_ids, n_cells), 20)
    ids_l = seg_ids.to(torch.int64)
    lib = cuda_ms(torch, lambda: torch.zeros(
        (n_cells, 2), dtype=torch.int32, device=dev).index_add_(
            0, ids_l, seg_vals), 50)
    b_ms, b_by = bound(n_rows * 4 + n_rows * 2 * 4 + n_cells * 2 * 4,
                       n_rows * 2)
    records["segment_sum"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape=f"values [{n_rows},2] i32 -> [{n_cells},2]")

    # -- scatter_add: the table accumulate, int64 ------------------------------
    total = DEGREE * CAPACITY
    table = t(rng.integers(0, 1000, (total, 2)))
    rows_at = t(rng.choice(total, size=n_cells, replace=False)
                .astype(np.int32))
    partial = t(rng.integers(0, 400, (n_cells, 2)))
    got = sr.scatter_add_(table.clone(), rows_at, partial)
    want = ref.scatter_add_ref(table, rows_at, partial)
    check(torch.equal(got, want), "scatter_add main shape")
    # edge cases: ids >= C dropped, repeats, int64 and int32 wraparound,
    # float32, empty
    e_tab = t(rng.integers(2 ** 62, 2 ** 63 - 1, (64, 2)))
    e_ids = t(rng.integers(0, 80, 4000).astype(np.int32))
    e_rows = t(rng.integers(2 ** 61, 2 ** 62, (4000, 2)))
    check(torch.equal(sr.scatter_add_(e_tab.clone(), e_ids, e_rows),
                      ref.scatter_add_ref(e_tab, e_ids, e_rows)),
          "scatter_add int64 wraparound / dropped ids")
    i_tab = e_tab.to(torch.int32)
    i_rows = t(rng.integers(2 ** 30, 2 ** 31 - 1, (4000, 2)).astype(np.int32))
    check(torch.equal(sr.scatter_add_(i_tab.clone(), e_ids, i_rows),
                      ref.scatter_add_ref(i_tab, e_ids, i_rows)),
          "scatter_add int32 wraparound")
    f_tab = t(rng.standard_normal((64, 2)).astype(np.float32))
    f_rows = t(rng.standard_normal((4000, 2)).astype(np.float32))
    f_got = sr.scatter_add_(f_tab.clone(), e_ids, f_rows)
    f_want = ref.scatter_add_ref(f_tab, e_ids, f_rows)
    f_err = float((f_got - f_want).abs().max())
    check(torch.allclose(f_got, f_want, atol=F32_TOL, rtol=F32_TOL),
          f"scatter_add float32 error {f_err}")
    check(torch.equal(sr.scatter_add_(
        e_tab.clone(), torch.zeros(0, dtype=torch.int32, device=dev),
        torch.zeros((0, 2), dtype=torch.int64, device=dev)), e_tab),
        "scatter_add empty")
    work = table.clone()
    ms = cuda_ms(torch, lambda: sr.scatter_add_(work, rows_at, partial), 50)
    plain = cuda_ms(torch, lambda: ref.scatter_add_ref_(work, rows_at,
                                                        partial), 20)
    rows_l = rows_at.to(torch.int64)
    lib = cuda_ms(torch, lambda: work.index_add_(0, rows_l, partial), 50)
    b_ms, b_by = bound(n_cells * 4 + n_cells * 2 * 8 + 2 * n_cells * 2 * 8,
                       n_cells * 2)
    records["scatter_add"] = dict(
        max_abs_err=f_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape=f"table [{total},2] i64, {n_cells} rows")

    # -- the lookups: a steady-state table of ~23% load ------------------------
    c_keys, c_starts = cells[:, 0].contiguous(), cells[:, 1].contiguous()
    slot_table = t((np.arange(NUM_SLOTS) * DEGREE) // NUM_SLOTS)
    c_own = slot_table[hash_to_slot(c_keys, NUM_SLOTS)].to(torch.int32)
    occ = t(rng.random(total) < 0.23)
    tk = t(rng.integers(-2 ** 63, 2 ** 63 - 1, total, dtype=np.int64))
    tst = c_starts[t(rng.integers(0, n_cells, total))].clone()
    # ~12% of the cells are open already (hits), placed anywhere in their
    # owner's segment — not where their probe window would put them
    hit = rng.random(n_cells) < 0.12
    hit_idx = t(np.flatnonzero(hit))
    hit_rows = c_own[hit_idx].to(torch.int64) * CAPACITY \
        + t(rng.integers(0, CAPACITY, len(hit_idx)))
    tk[hit_rows] = c_keys[hit_idx]
    tst[hit_rows] = c_starts[hit_idx]
    occ[hit_rows] = True
    row_own = torch.arange(DEGREE, dtype=torch.int32, device=dev) \
        .repeat_interleave(CAPACITY)

    def lookup_pairs(out, n_tab):
        # cell-row pairs the full-scan kernel compares: a hit scans up to
        # its row, a miss the whole table
        o = out.to(torch.int64)
        return int(torch.where(o < n_tab, o + 1, n_tab).sum())

    def lookup_bound(n_cells, cell_bytes, n_tab, row_bytes, planes, pairs):
        # the function's bound: a hash join (or the probe window under the
        # table's invariant) reads each input once and does O(cells + rows)
        # compares, so bytes bound it; the full scan's compares, `planes`
        # 32-bit compares per cell-row pair, are reported apart
        b_ms, b_by = bound(n_cells * (cell_bytes + 4) + n_tab * row_bytes,
                           (n_cells + n_tab) * planes)
        return dict(bound_ms=b_ms, bound_by=b_by, scan_pairs=pairs,
                    scan_ops_ms=bound(0, pairs * planes)[0])

    got = ht.batched_table_lookup(c_own, c_keys, c_starts, row_own, tk, tst,
                                  occ)
    want = ref.batched_table_lookup_ref(c_own, c_keys, c_starts, row_own, tk,
                                        tst, occ)
    check(torch.equal(got, want), "batched_table_lookup main shape")
    _lookup_edges(torch, t, rng, ht, ref)
    pairs = lookup_pairs(got, total)
    ms = cuda_ms(torch, lambda: ht.batched_table_lookup(
        c_own, c_keys, c_starts, row_own, tk, tst, occ), 5)
    plain = cuda_ms(torch, lambda: ref.batched_table_lookup_ref(
        c_own, c_keys, c_starts, row_own, tk, tst, occ), 1, warmup=0)
    records["batched_table_lookup"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain,
        **lookup_bound(n_cells, 20, total, 21, 6, pairs),
        library_ms=None, hits=int((got < total).sum()),
        shape=f"{n_cells} cells x {total} rows")

    # per-shard lookup: shard 0's cells against its own segment
    s0 = torch.nonzero(c_own == 0).flatten()
    k0, st0 = c_keys[s0].contiguous(), c_starts[s0].contiguous()
    seg = slice(0, CAPACITY)
    got = ht.table_lookup(k0, st0, tk[seg], tst[seg], occ[seg])
    want = ref.table_lookup_ref(k0, st0, tk[seg], tst[seg], occ[seg])
    check(torch.equal(got, want), "table_lookup main shape")
    pairs = lookup_pairs(got, CAPACITY)
    ms = cuda_ms(torch, lambda: ht.table_lookup(k0, st0, tk[seg], tst[seg],
                                                occ[seg]), 10)
    plain = cuda_ms(torch, lambda: ref.table_lookup_ref(
        k0, st0, tk[seg], tst[seg], occ[seg]), 2)
    records["table_lookup"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain,
        **lookup_bound(len(s0), 16, CAPACITY, 17, 5, pairs),
        library_ms=None, hits=int((got < CAPACITY).sum()),
        shape=f"{len(s0)} cells x {CAPACITY} rows")
    for name, rec in records.items():
        say("kernels", kernel=name, **rec)
    return records


def _lookup_edges(torch, t, rng, ht, ref):
    """Misses, negative and extreme int64 keys, rows of another shard, an
    empty input, and a table that breaks the probe-window invariant
    (duplicate cells anywhere, unoccupied copies)."""
    dev = torch.device("cuda")
    i64 = np.iinfo(np.int64)
    n_tab = 3000
    tk = t(rng.choice(np.array([i64.min, i64.max, -1, 0, 1, -(2 ** 40)],
                               np.int64), n_tab))
    tst = t(rng.integers(-3, 3, n_tab))
    occ = t(rng.random(n_tab) < 0.7)
    row_own = t(rng.integers(0, 4, n_tab).astype(np.int32))
    ck = t(rng.choice(np.array([i64.min, i64.max, -1, 0, 1, 7], np.int64),
                      700))
    cs = t(rng.integers(-4, 4, 700))
    c_own = t(rng.integers(0, 5, 700).astype(np.int32))
    got = ht.table_lookup(ck, cs, tk, tst, occ)
    check(torch.equal(got, ref.table_lookup_ref(ck, cs, tk, tst, occ)),
          "table_lookup edge cases")
    check(bool((got == n_tab).any()) and bool((got < n_tab).any()),
          "table_lookup edge cases need hits and misses")
    got = ht.batched_table_lookup(c_own, ck, cs, row_own, tk, tst, occ)
    check(torch.equal(got, ref.batched_table_lookup_ref(
        c_own, ck, cs, row_own, tk, tst, occ)),
        "batched_table_lookup edge cases")
    z64 = torch.zeros(0, dtype=torch.int64, device=dev)
    z32 = torch.zeros(0, dtype=torch.int32, device=dev)
    check(len(ht.table_lookup(z64, z64, tk, tst, occ)) == 0,
          "table_lookup empty")
    check(len(ht.batched_table_lookup(z32, z64, z64, row_own, tk, tst,
                                      occ)) == 0,
          "batched_table_lookup empty")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def phase_main(torch, items):
    from repro_torch.keyed import (
        FUSED_STAGES,
        KeyedWindowAdapter,
        WindowSpec,
        dedup_cells,
        expand_panes,
    )
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.runtime import StreamExecutor

    spec = WindowSpec("sliding", size=SIZE, slide=SLIDE, lateness=LATENESS)
    chunks = [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]

    def adapter(fused=True):
        return KeyedWindowAdapter(
            spec, num_slots=NUM_SLOTS, impl="segment",
            backend="device_table", capacity=CAPACITY,
            max_probes=MAX_PROBES, fused=fused,
        )

    def drive(ad, n_chunks, tracer=None):
        ex = StreamExecutor(ad, degree=DEGREE, chunk_size=CHUNK,
                            tracer=tracer)
        t0 = time.perf_counter()
        outs = ex.run(chunks[:LOOP_CHUNKS])
        snap8 = ex.snapshot_barrier()
        if n_chunks > LOOP_CHUNKS:
            sched = {i - LOOP_CHUNKS: d for i, d in SCHEDULE.items()}
            outs += ex.run(chunks[LOOP_CHUNKS:n_chunks], schedule=sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return ex, outs, snap8, ex.snapshot_barrier(), wall

    # -- the fused main path on the kernels, tracing off -----------------------
    ops.use_kernels("auto")
    ad = adapter()
    ops.reset_launch_counts()
    ex, outs, snap8, final, wall = drive(ad, N_CHUNKS)
    fused_counts = ops.launch_counts()
    say("main", run="fused kernels", launches=fused_counts)
    for k in ("segment_sum", "batched_table_lookup", "scatter_add"):
        check(fused_counts[k] > 0, f"fused main path launched no {k}")
    active_b, alloc_b = ad._batched.plane_bytes()
    registry = MetricsRegistry()
    ad.export_health(registry)
    gauges = registry.snapshot()["gauges"]
    svc = np.array([c.service_time for c in ex.metrics.chunks]) * 1e3
    say("main", items=len(items), chunks=N_CHUNKS, wall_s=wall,
        items_per_s=len(items) / wall, chunk_ms_median=float(np.median(svc)),
        chunk_ms_max=float(svc.max()), chunk_samples=len(svc),
        plane_bytes_active=active_b, plane_bytes_allocated=alloc_b,
        resident_rows=gauges["keyed.plane.resident_rows"],
        spill_rows=gauges["keyed.plane.spill_rows"],
        resizes=ex.metrics.migration_volume())

    # -- the table's lookup on its live planes: the CUDA full-scan kernel
    # against the probe-window realization that ops mode ``ref`` runs (the
    # table holds its invariant, so both give the same rows) ----------------
    dev = torch.device("cuda")
    last = chunks[-1]
    a_key, _, _, _, a_start = expand_panes(
        spec, torch.as_tensor(last["key"].copy(), device=dev),
        torch.as_tensor(last["value"].copy(), device=dev),
        torch.as_tensor(last["ts"].copy(), device=dev),
        torch.arange(len(last), device=dev),
    )
    cells, _ = dedup_cells(a_key, a_start)
    c_keys, c_starts = cells[:, 0], cells[:, 1]
    c_own = ad._cell_owners(c_keys)
    table = ad._batched
    k_rows = table.lookup(c_own, c_keys, c_starts)
    k_ms = cuda_ms(torch, lambda: table.lookup(c_own, c_keys, c_starts), 5)
    ops.use_kernels("ref")
    try:
        p_rows = table.lookup(c_own, c_keys, c_starts)
        p_ms = cuda_ms(torch, lambda: table.lookup(c_own, c_keys, c_starts),
                       20)
    finally:
        ops.use_kernels("auto")
    check(torch.equal(k_rows, p_rows),
          "live-table lookup: kernel and probe window differ")
    say("main", lookup="live table", cells=len(c_keys),
        rows=table.total_rows, hits=int((k_rows >= 0).sum()),
        kernel_ms=k_ms, probe_window_ms=p_ms)

    # -- a traced run: per-stage shares (each span synchronizes the card) -----
    tracer = Tracer(recorder=None)
    t_ex, traced_outs, _, _, traced_wall = drive(adapter(), N_CHUNKS, tracer)
    check(outputs_equal(traced_outs, outs), "traced run differs")
    totals = tracer.total_by_name()
    chunk_s = totals["chunk"][1]
    shares = {s: totals.get(s, (0, 0.0))[1] / chunk_s for s in FUSED_STAGES}
    t_svc = np.array([c.service_time for c in t_ex.metrics.chunks]) * 1e3
    say("main", run="traced", wall_s=traced_wall,
        chunk_ms_median=float(np.median(t_svc)),
        tracing_overhead=float(np.median(t_svc) / np.median(svc)),
        stage_share=shares, stage_coverage=sum(shares.values()))

    # -- the per-shard loop over the first chunks: table_lookup ---------------
    ops.reset_launch_counts()
    _, loop_outs, loop_snap8, _, loop_wall = drive(adapter(fused=False),
                                                   LOOP_CHUNKS)
    loop_counts = ops.launch_counts()
    say("main", run="loop kernels", chunks=LOOP_CHUNKS, wall_s=loop_wall,
        launches=loop_counts)
    for k in ("segment_sum", "table_lookup", "scatter_add"):
        check(loop_counts[k] > 0, f"loop main path launched no {k}")
    check(outputs_equal(loop_outs, outs[:LOOP_CHUNKS]),
          "fused=False outputs differ from the fused run")
    check(states_equal(loop_snap8, snap8),
          "fused=False barrier snapshot differs from the fused run")

    # -- (b) the same stream on the plain versions, on the card ---------------
    ops.use_kernels("ref")
    try:
        _, ref_outs, ref_snap8, ref_final, ref_wall = drive(adapter(),
                                                            N_CHUNKS)
    finally:
        ops.use_kernels("auto")
    check(outputs_equal(ref_outs, outs), "kernel run differs from ref mode")
    check(states_equal(ref_snap8, snap8) and states_equal(ref_final, final),
          "kernel barrier snapshot differs from ref mode")
    say("main", run="ref mode", wall_s=ref_wall,
        kernel_over_ref_wall=wall / ref_wall, bit_identical=True)

    # -- (c) late count 0; emissions + open rows == numpy group-by ------------
    check(int(final["late_count"]) == 0, "main stream produced late items")
    check(all(len(o["late"]["key"]) == 0 for o in outs), "late records")
    em = {k: np.concatenate([o["emissions"][k] for o in outs])
          for k in ("key", "start", "value", "count")}
    got = sorted_rows(
        np.concatenate([em["key"], final["w_key"]]),
        np.concatenate([em["start"], final["w_start"]]),
        np.concatenate([em["value"], final["w_value"]]),
        np.concatenate([em["count"], final["w_count"]]),
    )
    want = sorted_rows(*group_by(*pane_assignments(items)))
    check(got.shape == want.shape and np.array_equal(got, want),
          "emissions + open rows differ from the numpy group-by")
    say("main", groupby_cells=int(want.shape[1]),
        emitted_cells=int(len(em["key"])), open_cells=int(len(final["w_key"])),
        bit_identical=True)
    return {"fused": fused_counts, "loop": loop_counts}


# ---------------------------------------------------------------------------
# phase 5: spill, TTL and early firing at a small size
# ---------------------------------------------------------------------------

def phase_small(torch):
    from repro_torch.keyed import (
        KeyedWindowAdapter,
        WindowSpec,
        synthetic_keyed_items,
    )
    from repro_torch.kernels import ops
    from repro_torch.runtime import StreamExecutor

    # (a) the reference benchmark's oracle configuration (its windows close
    # within a chunk, so it forces spill but no eviction and no late item);
    # (b) short chunks and a small lateness that force all three
    configs = {
        "oracle": dict(
            ch=256, nch=12, schedule={4: 3, 8: 7}, capacity=64, ttl=6,
            spec=WindowSpec("sliding", size=96, slide=32, lateness=16,
                            late_policy="side", early_every=2),
            items=dict(num_keys=64, disorder=8, seed=0),
            need=("t_spilled",),
        ),
        "evict": dict(
            ch=16, nch=24, schedule={8: 3, 16: 7}, capacity=16, ttl=4,
            spec=WindowSpec("sliding", size=48, slide=16, lateness=3,
                            late_policy="side", early_every=2),
            items=dict(num_keys=40, disorder=10, seed=0),
            need=("t_spilled", "t_evicted", "late_count"),
        ),
    }
    for label, cfg in configs.items():
        ch = cfg["ch"]
        items = synthetic_keyed_items(ch * cfg["nch"], **cfg["items"])
        chunks = [items[i: i + ch] for i in range(0, len(items), ch)]

        def run(device, fused=True, mode="auto"):
            ops.use_kernels(mode)
            try:
                ad = KeyedWindowAdapter(
                    cfg["spec"], num_slots=20, impl="segment",
                    backend="device_table", capacity=cfg["capacity"],
                    max_probes=4, ttl=cfg["ttl"], fused=fused, device=device,
                )
                ex = StreamExecutor(ad, degree=2, chunk_size=ch)
                outs = ex.run(chunks, schedule=cfg["schedule"])
                return outs, ex.state
            finally:
                ops.use_kernels("auto")

        ops.reset_launch_counts()
        kern = run("cuda")
        counts = ops.launch_counts()
        for k in cfg["need"]:
            check(int(kern[1][k]) > 0, f"small phase {label}: {k} is 0")
        check(any(len(o["early"]["key"]) for o in kern[0]),
              f"small phase {label}: no early firing")
        plain = run("cuda", mode="ref")
        loop = run("cuda", fused=False)
        cpu = run("cpu")
        for name, other in (("plain", plain), ("loop", loop), ("cpu", cpu)):
            check(outputs_equal(kern[0], other[0]),
                  f"small phase {label}: kernels vs {name} outputs differ")
            check(states_equal(kern[1], other[1]),
                  f"small phase {label}: kernels vs {name} snapshot differs")
        say("small", config=label, launches=counts,
            spilled=int(kern[1]["t_spilled"]),
            evicted=int(kern[1]["t_evicted"]),
            late=int(kern[1]["late_count"]),
            bit_identical=["plain", "loop", "cpu"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build, ops
        from repro_torch.keyed import keyed_stream
    except ImportError as e:
        print(f"FAIL: the repro_torch package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = nvidia_smi_line()
        name = torch.cuda.get_device_name(0)
        say("device", nvidia_smi=smi, torch_name=name,
            count=torch.cuda.device_count(), torch=torch.__version__,
            cuda=torch.version.cuda)

        t0 = time.perf_counter()
        _build.library()
        ptxas = [ln.strip() for ln in _build.BUILD_INFO["ptxas"].splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        say("build", seconds=time.perf_counter() - t0,
            compiled=_build.BUILD_INFO["compiled"], ptxas=ptxas)

        items = make_stream(args.seed, keyed_stream)
        records = phase_kernels(torch, items)
        counts = phase_main(torch, items)
        phase_small(torch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        ops.use_kernels("auto")

    kernels = []
    for k, (source, replaces) in KERNEL_META.items():
        rec = records[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts["fused"][k] + counts["loop"][k],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
