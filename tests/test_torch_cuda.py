"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, not at import).  This file imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers must be bit-exact; float32 sums are held to 3e-5 because the
atomics add in another order than the plain version.  The attention
kernels are held to 3e-5 in float32 and 2e-2 in bfloat16, the SSD scan to
2e-4 and 5e-2, the tolerances the reference holds its Pallas kernels to
(``tests/test_kernels.py``); bfloat16 flash also to one bfloat16 rounding
step of each value, and the bfloat16 scan to one step past its float32
tolerance, as ``chip_smoke.py`` holds them; the MoE gather, a copy, must be
bit-exact.  The flash backward is held to its plain version at 1e-4 of
each gradient's largest magnitude in float32 and 2e-2 and one rounding
step in bfloat16, the scan's backward at 2e-4 and 5e-2 and one rounding
step, the gather's backward bit for bit, each with two calls
bit-identical; only decode attention raises under grad.  The distributed
keyed plane's workers run on the card too (``test_dist_plane_*``), held to
the in-process plane bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import hash_table as tht
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels import ssd_scan as tss
from repro_torch.keyed import KeyedWindowAdapter, WindowSpec, synthetic_keyed_items
from repro_torch.runtime import StreamExecutor

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
I64 = np.iinfo(np.int64)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, a):
    return torch.as_tensor(np.asarray(a), device=dev)


def _lookup_case(dev, rng, n, capacity, n_w, max_probes):
    """Cells and stacked planes of ``n_w`` segments that break the
    invariant (keys from a small pool of extreme and negative values, so a
    cell has copies anywhere, live and stale), with about half the cells
    also written into a random probe of their own window, live or stale;
    the first two cells' owners lie outside the segments (-1 and n_w),
    which the function answers with misses."""
    from repro_torch.keyed import cell_hash

    pool = np.array([I64.min, I64.max, -1, 0, 1, -(2 ** 40), 2 ** 33 + 5],
                    np.int64)
    total = n_w * capacity
    ck = _on(dev, rng.choice(np.append(pool, 12345), n))
    cs = _on(dev, rng.integers(-2, 3, n) * 7)
    own = _on(dev, rng.integers(0, n_w, n).astype(np.int32))
    tk = _on(dev, rng.choice(pool, total))
    ts = _on(dev, rng.integers(-2, 2, total) * 7)
    occ = _on(dev, rng.random(total) < 0.6)
    put = torch.nonzero(_on(dev, rng.random(n) < 0.5)).flatten()
    probe = _on(dev, rng.integers(0, max_probes, len(put)))
    rows = own[put].long() * capacity + torch.remainder(
        cell_hash(ck[put], cs[put], capacity) + probe, capacity)
    tk[rows], ts[rows] = ck[put], cs[put]
    occ[rows] = _on(dev, rng.random(len(put)) < 0.8)
    own[:2] = _on(dev, np.array([-1, n_w], np.int32))
    return own, ck, cs, tk, ts, occ


def test_segment_sum(dev):
    rng = np.random.default_rng(0)
    ids = _on(dev, rng.integers(0, 60, 5000).astype(np.int32))
    vals = _on(dev, rng.integers(2 ** 31 - 99, 2 ** 31, (5000, 2))
               .astype(np.int32))
    assert torch.equal(tsr.segment_sum(vals, ids, 50),
                       tref.segment_sum_ref(vals, ids, 50))
    f = _on(dev, rng.standard_normal((5000, 2)).astype(np.float32))
    torch.testing.assert_close(tsr.segment_sum(f, ids, 50),
                               tref.segment_sum_ref(f, ids, 50), **F32)


def test_scatter_add(dev):
    rng = np.random.default_rng(1)
    table = _on(dev, rng.integers(2 ** 62, I64.max, (40, 2)))
    ids = _on(dev, rng.integers(0, 45, 3000).astype(np.int32))
    rows = _on(dev, rng.integers(2 ** 60, 2 ** 62, (3000, 2)))
    assert torch.equal(tsr.scatter_add_(table.clone(), ids, rows),
                       tref.scatter_add_ref(table, ids, rows))
    small = table.to(torch.int32)
    rows32 = rows.to(torch.int32)
    assert torch.equal(tsr.scatter_add_(small.clone(), ids, rows32),
                       tref.scatter_add_ref(small, ids, rows32))


def _sorted_case(dev, case, rng):
    """(sorted int32 ids, S) on the card: the keyed main path's shape
    (about 65,536 pane rows into 65,044 cells), runs at the kernel's 512-row
    tile edges, and a hot cell holding half of 1,048,576 rows."""
    tile = tsr.SORTED_TILE
    if case == "keyed":
        S = 65044  # every cell has a row, 492 have two
        ids = np.sort(np.concatenate([np.arange(S),
                                      rng.integers(0, S, 65536 - S)]))
    elif case == "tile edges":
        # runs ending one row before, at and after each edge, one run of
        # exactly one tile, one of 2 tiles + 1, and a ragged last tile
        lengths = [tile - 1, 1, tile, 1, 2 * tile + 1, tile - 2, 3, tile + 1]
        ids = np.repeat(np.arange(0, 3 * len(lengths), 3), lengths)
        S = int(ids.max()) + 2
    elif case == "out of range at both ends":
        ids = np.sort(rng.integers(-600, 1500, 3 * tile + 5))
        S = 1000
    elif case == "skewed":
        n = 1 << 20
        cold = np.sort(rng.integers(0, 200_000, n // 2))
        ids = np.sort(np.concatenate([cold, np.full(n // 2, 70_001)]))
        S = 200_000
    else:
        raise AssertionError(case)
    return _on(dev, ids.astype(np.int32)), S


@pytest.mark.parametrize("case", ["keyed", "tile edges",
                                  "out of range at both ends", "skewed"])
def test_segment_sum_sorted_vs_plain(dev, case):
    """The reduce-by-key kernel: int32 bit-exact against the plain
    prefix-sum version (values near 2^31, so the sums wrap), at d = 2 (the
    keyed path's) and d = 3; float32 within
    3e-5 of the plain scatter (both sum short runs exactly or nearly), or,
    for the hot cell's 524,288 rows, within the kernel's rounding: at most
    32 float32 adds between a value and the sum (4 in the thread, 7 in the
    tile's scan, the look-back's windows and its 7-step tree), so within
    32 * 2^-24 of the sum of magnitudes; and a second float32 call
    bit-identical to the first."""
    rng = np.random.default_rng(7)
    ids, S = _sorted_case(dev, case, rng)
    n = len(ids)
    vals = _on(dev, rng.integers(2 ** 31 - 99, 2 ** 31, (n, 2))
               .astype(np.int32))
    got = tsr.segment_sum_sorted(vals, ids, S)
    assert torch.equal(got, tref.segment_sum_sorted(vals, ids, S))
    assert torch.equal(got, tref.segment_sum_ref(vals, ids, S))
    # d = 3: one column per pass, rows read one value at a time
    wide = _on(dev, rng.integers(-2 ** 31, 2 ** 31, (n, 3)).astype(np.int32))
    assert torch.equal(tsr.segment_sum_sorted(wide, ids, S),
                       tref.segment_sum_sorted(wide, ids, S))
    f = _on(dev, rng.standard_normal((n, 2)).astype(np.float32))
    first = tsr.segment_sum_sorted(f, ids, S)
    assert torch.equal(first, tsr.segment_sum_sorted(f, ids, S))
    if case == "skewed":
        exact = tref.segment_sum_ref(f.double(), ids, S)
        mags = tref.segment_sum_ref(f.double().abs(), ids, S)
        assert ((first.double() - exact).abs()
                <= 32 * 2.0 ** -24 * mags + 1e-30).all()
    else:
        torch.testing.assert_close(first, tref.segment_sum_ref(f, ids, S),
                                   **F32)


def test_segment_sum_sorted_is_one_launch(dev):
    """On CUDA tensors ``ops.segment_sum_sorted`` runs one device kernel,
    the reduce-by-key, and no fill; empty inputs launch none of ours."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(8)
    ids, S = _sorted_case(dev, "keyed", rng)
    vals = _on(dev, rng.integers(0, 100, (len(ids), 2)).astype(np.int32))
    ops.segment_sum_sorted(vals, ids, S)  # the workspace's first allocation
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.segment_sum_sorted(vals, ids, S)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [(e.key, e.count) for e in kernels] == [(kernels[0].key, 1)]
    assert "segment_sum_sorted" in kernels[0].key
    assert ops.launch_counts()["segment_sum"] == 1
    empty = ops.segment_sum_sorted(vals[:0], ids[:0], 5)
    assert empty.shape == (5, 2) and not empty.any()
    assert ops.launch_counts()["segment_sum"] == 1


@pytest.mark.parametrize("case", ["distinct", "repeats and dropped",
                                  "unaligned rows"])
def test_scatter_add_row_per_thread(dev, case):
    """One thread per row: the window table's int64 accumulate at distinct
    rows (the main path's), repeats with ids outside [0, C) dropped, and
    rows at an 8-byte offset (the generic column loop); int64 and int32
    both wrap, bit-exact against the plain version."""
    rng = np.random.default_rng(9)
    if case == "distinct":
        C, n = 8 * 262144, 65044
        ids = rng.choice(C, n, replace=False)
    else:
        C, n = 3000, 20000
        ids = rng.integers(-50, C + 50, n)
    ids = _on(dev, ids.astype(np.int32))
    table = _on(dev, rng.integers(2 ** 62, I64.max, (C, 2)))
    rows = _on(dev, rng.integers(2 ** 61, 2 ** 62, (n, 2)))
    if case == "unaligned rows":
        flat = torch.empty(2 * n + 1, dtype=torch.int64, device=dev)
        flat[1:] = rows.flatten()
        rows = flat[1:].view(n, 2)
        assert rows.data_ptr() % 16
    assert torch.equal(tsr.scatter_add_(table.clone(), ids, rows),
                       tref.scatter_add_ref(table, ids, rows))
    small, rows32 = table.to(torch.int32), rows.to(torch.int32)
    assert torch.equal(tsr.scatter_add_(small.clone(), ids, rows32),
                       tref.scatter_add_ref(small, ids, rows32))
    f_tab = _on(dev, rng.standard_normal((C, 3)).astype(np.float32))
    f_rows = _on(dev, rng.standard_normal((n, 3)).astype(np.float32))
    torch.testing.assert_close(tsr.scatter_add_(f_tab.clone(), ids, f_rows),
                               tref.scatter_add_ref(f_tab, ids, f_rows),
                               **F32)


@pytest.mark.parametrize("max_probes,capacity", [
    (1, 40), (16, 40), (33, 40), (16, 4096)])
def test_lookups(dev, max_probes, capacity):
    """The probe-window kernel against its plain version, bit-exact, on
    tables that break the invariant (both compute the same probe-window
    function there); at capacity 40 most windows wrap the segment's end,
    and 33 probes take the kernel's 16-lane loop three passes."""
    rng = np.random.default_rng(max_probes + capacity)
    own, ck, cs, tk, ts, occ = _lookup_case(dev, rng, 3000, capacity, 5,
                                            max_probes)
    total = 5 * capacity
    before = ops.launch_counts()
    got = tht.batched_table_lookup(own, ck, cs, tk, ts, occ, capacity,
                                   max_probes)
    assert torch.equal(got, tref.batched_table_lookup_ref(
        own, ck, cs, tk, ts, occ, capacity, max_probes))
    assert bool((got == total).any()) and bool((got < total).any())
    assert bool((got[:2] == total).all())
    seg = slice(0, capacity)
    got = tht.table_lookup(ck, cs, tk[seg], ts[seg], occ[seg], max_probes)
    assert torch.equal(got, tref.table_lookup_ref(
        ck, cs, tk[seg], ts[seg], occ[seg], max_probes))
    assert bool((got < capacity).any())
    after = ops.launch_counts()
    assert after["batched_table_lookup"] == before["batched_table_lookup"] + 1
    assert after["table_lookup"] == before["table_lookup"] + 1


@pytest.mark.parametrize("capacity", [1, 37, 262144, 10_000_019])
def test_lookup_home_equals_cell_hash(dev, capacity):
    """The kernel's own home is ``cell_hash``: the last cell of each home
    is written at row ``cell_hash(key, start)``, and a one-probe lookup
    finds exactly the cells that hold their row; extreme and negative keys
    and starts included."""
    from repro_torch.keyed import cell_hash

    rng = np.random.default_rng(capacity)
    ck = _on(dev, np.append(rng.integers(I64.min, I64.max, 20000,
                                         dtype=np.int64),
                            [I64.min, I64.max, -1, 0, -5]))
    cs = _on(dev, np.append(rng.integers(-(2 ** 40), 2 ** 40, 20000),
                            [I64.max, I64.min, -1, 0, 7]))
    home = cell_hash(ck, cs, capacity)
    tk = torch.zeros(capacity, dtype=torch.int64, device=dev)
    ts = torch.zeros(capacity, dtype=torch.int64, device=dev)
    last = torch.full((capacity,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, home, torch.arange(len(ck), device=dev), "amax")
    rows = torch.nonzero(last >= 0).flatten()
    tk[rows], ts[rows] = ck[last[rows]], cs[last[rows]]
    occ = torch.ones(capacity, dtype=torch.bool, device=dev)
    kept = (tk[home] == ck) & (ts[home] == cs)
    got = tht.table_lookup(ck, cs, tk, ts, occ, 1).long()
    assert torch.equal(got, torch.where(kept, home, capacity))
    assert int(kept.sum()) >= min(capacity, 1000)


def test_hashes_on_the_card_equal_numpy(dev):
    """The int64-wrapping product and the unsigned remainder give the
    numpy uint64 rows on the card too, negative and extreme keys included."""
    from repro_torch.keyed import cell_hash, hash_to_slot

    rng = np.random.default_rng(2)
    keys = np.append(rng.integers(I64.min, I64.max, 4000, dtype=np.int64),
                     [I64.min, I64.max, -1, 0, -5])
    starts = rng.integers(-(2 ** 40), 2 ** 40, len(keys))
    for m in (1, 20, 1000, 262144, 2 ** 40 + 3):
        np.testing.assert_array_equal(
            hash_to_slot(_on(dev, keys), m).cpu().numpy(),
            hash_to_slot(keys, m).astype(np.int64))
        np.testing.assert_array_equal(
            cell_hash(_on(dev, keys), _on(dev, starts), m).cpu().numpy(),
            cell_hash(keys, starts, m))


def test_wrappers_refuse_bad_inputs(dev):
    ids = torch.zeros(4, dtype=torch.int64, device=dev)  # must be int32
    with pytest.raises(ValueError, match="int32"):
        tsr.segment_sum(torch.ones((4, 2), dtype=torch.int32, device=dev),
                        ids, 3)
    strided = torch.ones((4, 4), dtype=torch.int32, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tsr.segment_sum(strided, ids.to(torch.int32), 3)


@pytest.mark.parametrize("fused", [True, False])
def test_plane_on_the_card_equals_plain_and_cpu(dev, fused):
    """The keyed plane with forced spill, TTL, early firing and a resize:
    the kernel run equals the plain run on the card and the CPU run, and
    launched its kernels."""
    spec = WindowSpec("sliding", size=48, slide=16, lateness=3,
                      late_policy="side", early_every=2)
    items = synthetic_keyed_items(16 * 12, num_keys=40, disorder=10, seed=0)
    chunks = [items[i: i + 16] for i in range(0, len(items), 16)]

    def run(device, mode="auto"):
        ops.use_kernels(mode)
        try:
            ad = KeyedWindowAdapter(spec, num_slots=20, backend="device_table",
                                    capacity=16, max_probes=4, ttl=4,
                                    fused=fused, device=device)
            ex = StreamExecutor(ad, degree=2, chunk_size=16)
            return ex.run(chunks, schedule={6: 7}), ex.state
        finally:
            ops.use_kernels("auto")

    ops.reset_launch_counts()
    kern = run(dev)
    counts = ops.launch_counts()
    lookup = "batched_table_lookup" if fused else "table_lookup"
    assert counts[lookup] > 0 and counts["scatter_add"] > 0
    assert counts["segment_sum"] > 0
    for other in (run(dev, "ref"), run("cpu")):
        for a, b in zip(kern[0], other[0]):
            for ch in a:
                for k in a[ch]:
                    np.testing.assert_array_equal(a[ch][k], b[ch][k])
        for k in kern[1]:
            np.testing.assert_array_equal(kern[1][k], other[1][k])


def test_supervised_run_on_the_card_equals_the_cpu(dev, tmp_path):
    """``Supervisor`` over the device-table plane with spill, TTL and early
    firing: a checkpoint every 2 chunks, a failure before chunk 3, a restore,
    a shrink and a grow.  The run on the card equals the same run on the
    CPU (outputs, final state, events), and the replay launched the keyed
    kernels."""
    from repro_torch.runtime import BoundedSource, FailurePlan, Supervisor

    spec = WindowSpec("tumbling", size=30, lateness=5, late_policy="side",
                      early_every=2)
    items = synthetic_keyed_items(16 * 6, num_keys=7, disorder=5, seed=3)

    def run(device, name):
        src = BoundedSource(items)
        ad = KeyedWindowAdapter(spec, num_slots=10, backend="device_table",
                                capacity=8, max_probes=2, ttl=4,
                                device=device)
        ex = StreamExecutor(ad, degree=3, chunk_size=16)
        sup = Supervisor(
            ex, lambda i: (src.seek(i * 16), src.take(16))[1], 6,
            ckpt_dir=str(tmp_path / name), ckpt_every=2,
            failure_plan=FailurePlan(fail_at=3, recover_after=2))
        outs = sup.run()
        return ([outs[i] for i in range(6)], ex.state,
                [(e.chunk_index, e.kind) for e in sup.events])

    ops.reset_launch_counts()
    card = run(dev, "card")
    counts = ops.launch_counts()
    for k in ("segment_sum", "scatter_add", "batched_table_lookup"):
        assert counts[k] > 6, k     # more than one per chunk: the replay
    cpu = run("cpu", "host")
    assert card[2] == cpu[2]
    assert {"failure", "restore", "shrink", "grow"} <= {k for _, k in card[2]}
    for a, b in zip(card[0], cpu[0]):
        for ch in a:
            for k in a[ch]:
                assert a[ch][k].dtype == b[ch][k].dtype
                np.testing.assert_array_equal(a[ch][k], b[ch][k])
    for k in cpu[1]:
        np.testing.assert_array_equal(card[1][k], cpu[1][k], err_msg=k)


def test_checkpoint_of_card_tensors_restores_onto_the_card(dev, tmp_path):
    """Card tensors are copied to the host before a non-blocking save
    returns and come back on the card, in their dtype; a CPU tensor and a
    numpy leaf of the template stay where they were."""
    from repro_torch.checkpoint import checkpoint as ckpt

    gen = torch.Generator(device=dev).manual_seed(3)
    tree = {"w": torch.randn(64, 32, generator=gen, device=dev),
            "ids": torch.arange(100, device=dev),
            "mask": torch.arange(7, device=dev) % 2 == 0,
            "cpu": torch.ones(3), "host": np.arange(5)}
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy()
            for k, v in tree.items()}
    writer = ckpt.save(str(tmp_path), 7, tree, blocking=False)
    tree["w"].mul_(2.0)
    tree["ids"].zero_()
    writer.join()
    template = {"w": torch.empty(64, 32, device=dev),
                "ids": torch.empty(100, dtype=torch.int64, device=dev),
                "mask": torch.empty(7, dtype=torch.bool, device=dev),
                "cpu": torch.empty(3), "host": np.zeros(5, np.int64)}
    got, _ = ckpt.restore(str(tmp_path), 7, template)
    for k in ("w", "ids", "mask", "cpu"):
        assert got[k].device == template[k].device, k
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert isinstance(got["host"], np.ndarray)
    np.testing.assert_array_equal(got["host"], want["host"])


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def _tol(dtype):
    return BF16 if dtype == torch.bfloat16 else F32


def _bf16_steps(got, want):
    """Largest difference in units of one bfloat16 rounding step of each
    value (``3e-5 + 2^-7 |x|``): the kernel and its plain version both do
    float32 math and round once, so they may differ by one step."""
    want = want.float()
    return float(((got.float() - want).abs()
                  / (F32["atol"] + 2.0 ** -7 * want.abs())).max())


def _flash_inputs(dev, dtype, B, Hq, Hkv, Sq, Skv, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, Hq, Sq, hd), (B, Hkv, Skv, hd),
                          (B, Hkv, Skv, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,window,softcap,causal", [
    (2, 4, 2, 100, 100, 64, 24, 50.0, True),    # ragged Sq, window, GQA
    (1, 8, 2, 200, 200, 128, 0, 0.0, True),
    (1, 4, 4, 65, 65, 128, 64, 30.0, True),     # one row past a tile
    (2, 4, 1, 5, 70, 64, 0, 50.0, False),
    (1, 32, 16, 300, 300, 128, 128, 50.0, True),  # Gemma2's heads
    # one row past a 128-row q tile of the bf16 kernel
    (1, 4, 2, 129, 129, 128, 0, 0.0, True),
    (1, 2, 1, 257, 257, 64, 0, 50.0, True),
    # the window's lower edge inside a 64-row kv tile
    (1, 4, 2, 300, 300, 128, 65, 50.0, True),
    (1, 2, 2, 400, 400, 64, 127, 0.0, True),
    # B = 2, tiles that cross the end of one (b, h)'s rows
    (2, 4, 2, 200, 200, 128, 0, 30.0, True),
    (1, 32, 16, 1000, 1000, 128, 300, 50.0, True),  # Gemma2, 1,000 tokens
    # head_dim 256 (the CUDA-core kernel in both dtypes): PaliGemma's 8 q
    # heads over 1, a ragged tile with a window and a softcap
    (1, 8, 1, 300, 300, 256, 0, 0.0, True),
    (2, 4, 2, 129, 129, 256, 64, 50.0, True),
    (1, 2, 1, 5, 70, 256, 0, 30.0, False),
])
def test_flash_attention_vs_plain(dev, dtype, B, Hq, Hkv, Sq, Skv, hd,
                                  window, softcap, causal):
    q, k, v = _flash_inputs(dev, dtype, B, Hq, Hkv, Sq, Skv, hd, Sq)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.launch_counts()["flash_attention"]
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == torch.bfloat16:
        assert _bf16_steps(got, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,prefix_len", [
    (1, 4, 2, 300, 64, 64),       # P on a 64-row kv tile's edge
    (2, 4, 2, 300, 64, 100),      # P inside a tile, past the first q tile
    (1, 8, 1, 1000, 128, 200),    # the wgmma route at bf16, P = 200
    (1, 4, 2, 129, 128, 128),     # P on an edge, one row past a q tile
    (1, 2, 2, 300, 128, 280),     # kv tiles far above the diagonal
    (1, 8, 1, 600, 256, 256),     # PaliGemma's heads, P on a tile edge
    (1, 8, 1, 300, 256, 101),
    (1, 4, 4, 77, 64, 1),
    (1, 4, 2, 150, 128, 150),     # P = S: no mask at all
])
def test_flash_prefix_lm_vs_plain(dev, dtype, B, Hq, Hkv, S, hd,
                                  prefix_len):
    """The prefix-LM mask ``k <= q or k < P`` on both routes (bfloat16 at
    head_dim 64/128 is the wgmma kernel, the rest the float32-FMA one), one
    launch, against the plain version."""
    q, k, v = _flash_inputs(dev, dtype, B, Hq, Hkv, S, S, hd, prefix_len)
    kw = dict(causal=True, prefix_len=prefix_len, softcap=30.0 * (hd == 64))
    before = ops.launch_counts()["flash_attention"]
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == torch.bfloat16:
        assert _bf16_steps(got, want) <= 1.0
    causal = tref.flash_attention_ref(q, k, v, causal=True,
                                      softcap=kw["softcap"])
    rows = min(prefix_len, S) - 1     # the last row whose keys the prefix adds
    if 0 < rows:
        assert (got[:, :, :rows].float() - causal[:, :, :rows].float()
                ).abs().max() > 1e-2


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 128, "flash_forward_wgmma"),
    (torch.float32, 128, "flash_forward"),
    (torch.bfloat16, 256, "flash_forward"),
])
def test_flash_attention_routes_by_dtype(dev, dtype, hd, kernel):
    """bfloat16 runs the tensor-core kernel; float32 keeps the float32-FMA
    kernel, one launch, within 3e-5 (TF32 could not hold that); head_dim
    256 runs the float32-FMA kernel in bfloat16 too.  The profile window
    holds one warm launch: the inputs are made, and the library's build or
    load, the kernel's first (lazily loading) launch and a first profiler
    session happen before it."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _flash_inputs(dev, dtype, 1, 8, 4, 300, 300, hd, 7)
    kw = dict(causal=True, window=100, softcap=50.0)
    with profile(activities=[ProfilerActivity.CUDA]):
        tfa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    before = ops.launch_counts()["flash_attention"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tfa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    flash = [n for n in names if "flash_forward" in n]
    assert len(flash) == 1 and (kernel + "<") in flash[0], names
    torch.testing.assert_close(
        got.float(), tref.flash_attention_ref(q, k, v, **kw).float(),
        **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,window,softcap", [
    (32, 16, 128, 4097, 50.0), (8, 2, 64, 0, 0.0), (4, 4, 128, 9, 30.0),
    (8, 1, 256, 0, 0.0), (16, 1, 64, 300, 30.0),
])
def test_decode_attention_per_slot_lengths_vs_plain(dev, dtype, Hq, Hkv, hd,
                                                    window, softcap):
    """One length per slot, a slot at 1 and one at the full cache."""
    S = 5000
    gen = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn((5, Hq, hd), generator=gen, device=dev).to(dtype)
    ck, cv = (torch.randn((5, Hkv, S, hd), generator=gen, device=dev)
              .to(dtype) for _ in range(2))
    valid = torch.tensor([1, 9, 4100, 333, S], dtype=torch.int32, device=dev)
    kw = dict(softcap=softcap, window=window)
    got = tda.decode_attention(q, ck, cv, valid, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), tref.decode_attention_ref(q, ck, cv, valid, **kw).float(),
        **_tol(dtype))
    scalar = tda.decode_attention(q, ck, cv, 77, **kw)
    torch.testing.assert_close(
        scalar.float(), tref.decode_attention_ref(q, ck, cv, 77, **kw).float(),
        **_tol(dtype))


def _decode_inputs(dev, dtype, B, Hq, Hkv, S, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, Hq, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))


def _split_decode_holds(dev, q, ck, cv, valid, **kw):
    """One launch per call, within the tolerance of the plain version (bf16
    also within one rounding step), and a second call bit-identical (the
    merge's fixed split order, the counters back at zero)."""
    valid = torch.tensor(valid, dtype=torch.int32, device=dev)
    before = ops.launch_counts()["decode_attention"]
    got = tda.decode_attention(q, ck, cv, valid, **kw)
    again = tda.decode_attention(q, ck, cv, valid, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 2
    assert torch.equal(got, again)
    want = tref.decode_attention_ref(q, ck, cv, valid, **kw)
    torch.testing.assert_close(got.float(), want.float(), **_tol(q.dtype))
    if q.dtype == torch.bfloat16:
        assert _bf16_steps(got, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_split_decode_groups_vs_plain(dev, dtype, hd, group):
    """Every register instance (q heads per kv head 1, 2, 4, 8) at every
    head dim, and a group of 16 (two blocks of 8 per kv head): a slot at
    1, at the edges of the whole cache's run length, past two runs and at
    the whole cache; with no window, and with a window whose first admitted
    row (where the runs start) is off a tile boundary."""
    B, Hkv, S = 6, 4, 3000
    q, ck, cv = _decode_inputs(dev, dtype, B, group * Hkv, Hkv, S, hd,
                               group + hd)
    size = q.element_size()
    run = tda.split_length(
        S, tda.num_splits(B, Hkv * tda.chunks(group * Hkv, Hkv), S, hd,
                          size), tda.tile_rows(hd, size))
    valid = [1, run - 1, run, run + 1, 2 * run + 3, S]
    _split_decode_holds(dev, q, ck, cv, valid, softcap=30.0, window=0)
    _split_decode_holds(dev, q, ck, cv, valid, softcap=0.0, window=run + 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 4097, 263])
def test_split_decode_at_the_serving_split(dev, dtype, window):
    """Gemma2-27B's 32/16 heads at softcap 50 over a cache whose whole
    length the wrapper cuts into runs of 256 rows: lengths at a run's
    edges, valid_len 1 and valid_len S in one batch; window 263 starts the
    runs of the longer slots off a tile boundary."""
    B, S = 6, 5000
    q, ck, cv = _decode_inputs(dev, dtype, B, 32, 16, S, 128, window)
    size = q.element_size()
    run = tda.split_length(S, tda.num_splits(B, 16, S, 128, size),
                           tda.tile_rows(128, size))
    assert run == tda.SPLIT_ROWS
    _split_decode_holds(dev, q, ck, cv, [run - 1, run, run + 1, 1, S, 4100],
                        softcap=50.0, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,window", [(64, 0), (128, 0), (256, 40)])
def test_decode_valid_len_zero_is_the_mean_of_v(dev, dtype, hd, window):
    """A slot with no admitted row (valid_len 0, or with a window one whose
    window ends past the cache) gets what the plain version and the
    reference give, the mean of V over all S rows, beside a normal slot;
    a second call is bit-identical."""
    q, ck, cv = _decode_inputs(dev, dtype, 3, 4, 2, 600, hd, hd)
    valid = [0, 300, 600 + window] if window else [0, 300, 0]
    _split_decode_holds(dev, q, ck, cv, valid, softcap=30.0, window=window)
    got = tda.decode_attention(q, ck, cv, torch.tensor(
        valid, dtype=torch.int32, device=dev), softcap=30.0, window=window)
    mean = cv[0].float().mean(dim=1).repeat_interleave(2, dim=0)
    torch.testing.assert_close(got[0].float(), mean, **_tol(dtype))


def test_launch_helper_raises_on_a_refused_launch(dev):
    """The shared launch helper raises with the entry point's CUDA error
    (here the decode entry refusing 0 splits before it launches)."""
    from repro_torch.kernels import _build

    q, ck, cv = _decode_inputs(dev, torch.float32, 1, 2, 1, 64, 64, 0)
    valid = torch.ones(1, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="attn_decode_forward launch "
                                           "failed: CUDA error 1"):
        _build.launch("attn_decode_forward", 0, q.data_ptr(), ck.data_ptr(),
                      cv.data_ptr(), valid.data_ptr(), out.data_ptr(),
                      out.data_ptr(), valid.data_ptr(), 1, 2, 1, 64, 64, 0,
                      0, 0.0, 0)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """An unsupported head_dim, q heads that are no multiple of the kv
    heads, mixed dtypes, float16 and a strided tensor raise before anything
    launches."""
    counts = ops.launch_counts()
    q = torch.zeros((1, 2, 8, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_attention(q[:, :, 0].contiguous(), q, q, 3)
    odd = torch.zeros((1, 6, 64), device=dev)
    cache = torch.zeros((1, 4, 8, 64), device=dev)
    with pytest.raises(ValueError, match="does not fit"):
        tda.decode_attention(odd, cache, cache, 3)
    x = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(x.transpose(1, 2), x, x)
    assert ops.launch_counts() == counts


def test_engine_on_the_card_equals_ref_mode_and_cpu(dev):
    """A small float32 model at head_dim 64: the engine with the kernels
    gives the tokens of ops mode ``ref`` on the card and of the CPU run,
    and launched one flash kernel per layer per prefill and one decode
    kernel per layer per step."""
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(configs.get("gemma2-27b").reduced(),
                              num_heads=4, num_kv_heads=2, head_dim=64,
                              d_model=128, sliding_window=16)
    cpu = TT.init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 17, 41)]

    def serve(device, mode="auto"):
        params = TT.Transformer(cfg, device=device)
        params.load_state_dict(cpu.state_dict())
        ops.use_kernels(mode)
        try:
            eng = ServingEngine(cfg, params, num_slots=3, s_max=64,
                                device=device)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.step()
            eng.resize(2)
            eng.run_to_completion()
            return [r.generated for r in reqs], eng
        finally:
            ops.use_kernels("auto")

    ops.reset_launch_counts()
    kern, eng = serve(dev)
    counts = ops.launch_counts()
    n_prefills = len(prompts) + eng.resize_events[0]["requeued"]
    assert counts["flash_attention"] == cfg.num_layers * n_prefills
    assert counts["decode_attention"] == cfg.num_layers * eng.steps
    assert kern == serve(dev, "ref")[0]
    assert kern == serve("cpu")[0]


# ---------------------------------------------------------------------------
# the Mamba-2 scan and the MoE gather
# ---------------------------------------------------------------------------

SSD_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
           torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


def _scan_inputs(dev, dtype, B, H, S, P, N, dt_shift=0.0):
    """Model layouts: x and dt transposed from [B, S, H, ...], one B/C group
    expanded over the heads with stride 0; dt = softplus(randn - dt_shift)."""
    gen = torch.Generator(device=dev).manual_seed(S)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(B, S, H, P, scale=0.5).to(dtype).transpose(1, 2)
    dt = torch.nn.functional.softplus(randn(B, S, H) - dt_shift) \
        .transpose(1, 2)
    A = -torch.exp(randn(H, scale=0.3))
    Bm = randn(B, S, N, scale=0.3).to(dtype)[:, None].expand(B, H, S, N)
    Cm = randn(B, S, N, scale=0.3).to(dtype)[:, None].expand(B, H, S, N)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,P,N", [
    (1, 48, 1, 64, 128),       # one token
    (2, 4, 300, 64, 128),      # no chunk divides 300
    (1, 3, 129, 8, 16),        # a slice of P wider than P
    (1, 2, 64, 96, 256),       # the largest state, three P slices
])
def test_ssd_scan_vs_plain(dev, dtype, B, H, S, P, N):
    x, dt, A, Bm, Cm = _scan_inputs(dev, dtype, B, H, S, P, N)
    before = ops.launch_counts()["ssd_scan"]
    y, h = tss.ssd_scan(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    assert y.dtype == dtype and y.shape == (B, H, S, P)
    assert h.dtype == torch.float32 and h.shape == (B, H, N, P)
    want_y, want_h = tref.ssd_scan_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(h, want_h, **SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [(1, 8192), (2, 4097)])
def test_ssd_scan_carries_the_state_across_chunks(dev, dtype, B, S):
    """Mamba2-780M's heads with dt = softplus(randn - 5), 3e-4 to 0.1 as in
    a trained model: the state carried across a whole 64-position chunk
    moves y far past the tolerance, so a kernel that dropped or mis-scaled
    its carry ``exp(total) h`` between chunks fails."""
    x, dt, A, Bm, Cm = _scan_inputs(dev, dtype, B, 48, S, 64, 128,
                                    dt_shift=5.0)
    y, h = tss.ssd_scan(x, dt, A, Bm, Cm)
    want_y, want_h = tref.ssd_scan_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(h, want_h, **SSD_TOL[dtype])
    # from one whole chunk past the half on, the second half scanned alone
    # differs from the full scan only by the state carried across a chunk
    half = S // 2
    alone, _ = tref.ssd_scan_ref(x[:, :, half:], dt[:, :, half:], A,
                                 Bm[:, :, half:], Cm[:, :, half:])
    assert not torch.allclose(alone[:, :, 64:].float(),
                              want_y[:, :, half + 64:].float(),
                              **SSD_TOL[dtype])


def _within_one_bf16_step(got, want):
    """bfloat16 y within one rounding step of each value of the plain
    version's (which rounds once too), past the float32 tolerance of two
    orders of summation: the kernel's split operands keep its products near
    float32."""
    got, want = got.float(), want.float()
    assert float(((got - want).abs()
                  / (2e-4 + 2 ** -7 * want.abs())).max()) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [-1, 0, 1, "2c+1"])
@pytest.mark.parametrize("per_head", [False, True])
def test_ssd_scan_at_the_chunk_edges(dev, dtype, edge, per_head):
    """S at the kernel's chunk - 1, the chunk, + 1 and 2 x + 1, over 9 heads
    (a full group of 8 and one more), with one B/C group shared by every
    head (head stride 0: one score tile per chunk) or B/C per head, at a
    trained model's small dt."""
    c = tss.CHUNK[dtype]
    S = 2 * c + 1 if edge == "2c+1" else c + edge
    x, dt, A, Bm, Cm = _scan_inputs(dev, dtype, 2, 9, S, 64, 128,
                                    dt_shift=5.0)
    if per_head:
        gen = torch.Generator(device=dev).manual_seed(S + 1)
        Bm, Cm = ((torch.randn((2, 9, S, 128), generator=gen, device=dev)
                   * 0.3).to(dtype) for _ in range(2))
    assert tss.shared_group(Bm, Cm) != per_head
    y, h = tss.ssd_scan(x, dt, A, Bm, Cm)
    want_y, want_h = tref.ssd_scan_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(h, want_h, **SSD_TOL[dtype])
    if dtype == torch.bfloat16:
        _within_one_bf16_step(y, want_y)


def test_ssd_scan_mamba2_layer_twice_bit_identical(dev):
    """One Mamba2-780M layer of 8,192 tokens in bfloat16 (48 heads of 64,
    state 128, one shared group): within tolerance and one rounding step of
    the plain version, and a second call gives the same bits (no atomics,
    a fixed order of sums)."""
    args = _scan_inputs(dev, torch.bfloat16, 1, 48, 8192, 64, 128,
                        dt_shift=5.0)
    y, h = tss.ssd_scan(*args)
    y2, h2 = tss.ssd_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    want_y, want_h = tref.ssd_scan_ref(*args)
    torch.testing.assert_close(y.float(), want_y.float(),
                               **SSD_TOL[torch.bfloat16])
    torch.testing.assert_close(h, want_h, **SSD_TOL[torch.bfloat16])
    _within_one_bf16_step(y, want_y)


def test_ssd_scan_refuses_what_it_does_not_take(dev):
    counts = ops.launch_counts()
    x = torch.zeros((1, 2, 8, 16), device=dev)
    dt = torch.zeros((1, 2, 8), device=dev)
    A = torch.zeros(2, device=dev)
    b = torch.zeros((1, 2, 8, 300), device=dev)
    with pytest.raises(ValueError, match="state size"):
        tss.ssd_scan(x, dt, A, b, b)
    b = torch.zeros((1, 2, 8, 16), device=dev)
    with pytest.raises(ValueError, match="float32 or"):
        tss.ssd_scan(x.half(), dt, A, b.half(), b.half())
    with pytest.raises(ValueError, match="float32"):
        tss.ssd_scan(x, dt.bfloat16(), A, b, b)
    strided = torch.zeros((1, 2, 16, 8), device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="last axis"):
        tss.ssd_scan(strided, dt, A, b, b)
    assert ops.launch_counts() == counts


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 2048),
                                     (torch.float32, 2048),
                                     (torch.float32, 3), (torch.bfloat16, 5)])
def test_moe_gather_bit_exact(dev, dtype, d):
    """16-byte units, and 4- and 2-byte ones for rows of 12 and 10 bytes;
    the dummy token, a negative one and one past it read zeros."""
    gen = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn((300, d), generator=gen, device=dev).to(dtype)
    tok = torch.randint(0, 301, (1000,), generator=gen, device=dev,
                        dtype=torch.int32)
    tok[:3] = torch.tensor([300, -1, 1 << 30], dtype=torch.int32)
    before = ops.launch_counts()["moe_gather"]
    got = tmd.moe_gather(x, tok)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gather"] == before + 1
    assert torch.equal(got, tref.moe_gather_ref(x, tok))
    assert not got[:3].any()


def test_mamba_and_moe_engines_on_the_card_equal_ref_mode_and_cpu(dev):
    """Reduced float32 Mamba2 and DeepSeekMoE: the engine with the kernels
    gives the tokens of ops mode ``ref`` on the card and of the CPU run,
    with one scan per Mamba layer per prefill and one gather per MoE layer
    per prefill and decode step."""
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    from repro_torch.models.config import MAMBA, MOE
    from repro_torch.serving import Request, ServingEngine

    rng = np.random.default_rng(1)
    for name in ("mamba2-780m", "deepseek-moe-16b"):
        # head_dim 64 keeps the reduced models small
        cfg = dataclasses.replace(configs.get(name).reduced(), head_dim=64,
                                  d_model=128)
        cpu = TT.init_params(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 30, 17, 70)]

        def serve(device, mode="auto"):
            params = TT.Transformer(cfg, device=device)
            params.load_state_dict(cpu.state_dict())
            ops.use_kernels(mode)
            try:
                eng = ServingEngine(cfg, params, num_slots=3, s_max=96,
                                    device=device)
                reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(prompts)]
                for r in reqs:
                    eng.submit(r)
                eng.step()
                eng.resize(2)
                eng.run_to_completion()
                return [r.generated for r in reqs], eng
            finally:
                ops.use_kernels("auto")

        ops.reset_launch_counts()
        kern, eng = serve(dev)
        counts = ops.launch_counts()
        specs = cfg.layer_specs()
        n_prefills = len(prompts) + eng.resize_events[0]["requeued"]
        n_mamba = sum(s.mixer == MAMBA for s in specs)
        n_moe = sum(s.mlp == MOE for s in specs)
        assert counts["ssd_scan"] == n_mamba * n_prefills
        assert counts["moe_gather"] == n_moe * (n_prefills + eng.steps)
        assert kern == serve(dev, "ref")[0]
        assert kern == serve("cpu")[0]


# ---------------------------------------------------------------------------
# the five state access patterns through StreamExecutor on the card
# ---------------------------------------------------------------------------

def _pattern_adapter(case):
    """A fresh adapter for ``case`` and its int32 stream (a chunk of 16,
    degrees 2 -> 4 -> 8 -> 2, as ``tests/runtime_checks.py``)."""
    from repro_torch.core import patterns as P
    from repro_torch.runtime import (AccumulatorAdapter, PartitionedAdapter,
                                     SeparateAdapter, SuccessiveAdapter)

    rng = np.random.default_rng(5)
    xs = rng.integers(-1000, 1000, 128).astype(np.int32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    if case.startswith("S2"):
        ownership = case.split()[1]
        pat = P.PartitionedState(
            f=lambda x, s: x * 2 + s, ns=lambda x, s: s * 3 + x,
            h=lambda x: (x * 7) % 16, num_slots=16, ownership=ownership)
        return PartitionedAdapter(pat, np.arange(16, dtype=np.int32)), xs
    if case == "S3":
        pat = P.AccumulatorState(f=lambda x, v: v * 2 - x, g=lambda x: x,
                                 combine=lambda a, b: a + b,
                                 zero=lambda: i32(0))
        return AccumulatorAdapter(pat, flush_every=2), xs
    if case == "S4":
        pat = P.SuccessiveApproximationState(
            c=lambda x, s: x < s, s_prime=lambda x, s: torch.minimum(x, s))
        return SuccessiveAdapter(pat, i32(2_000), sync_every=2), xs
    pat = P.SeparateTaskState(f=lambda x: x * x, s=lambda y, s: s * 31 + y)
    return SeparateAdapter(pat, i32(1)), xs


def _flat(out):
    if isinstance(out, dict):
        return {k: _flat(v) for k, v in out.items()}
    assert isinstance(out, torch.Tensor)
    return out.cpu().numpy()


@pytest.mark.parametrize("case", ["S2 block", "S2 slotmap", "S3", "S4",
                                  "S5"])
def test_pattern_on_the_card_equals_the_cpu(dev, case):
    """Each SPMD adapter through ``StreamExecutor`` on the card, with a grow
    and a shrink, equals the same run on the CPU bit for bit: outputs,
    final state, resizes; the state is a card tensor throughout."""
    import functools

    from repro_torch.runtime import default_mesh_factory

    def run(factory):
        adapter, xs = _pattern_adapter(case)
        ex = StreamExecutor(adapter, degree=2, chunk_size=16,
                            mesh_factory=factory)
        outs = []
        for i in range(8):
            if i in (2, 4, 6):
                ex.set_degree({2: 4, 4: 8, 6: 2}[i])
            outs.append(_flat(ex.process(xs[i * 16:(i + 1) * 16])))
            assert ex.state.device.type == factory(1, "w").device.type
        return outs, ex.state.cpu().numpy(), [
            (r.protocol, r.handoff_items) for r in ex.metrics.resizes]

    card = run(default_mesh_factory)
    cpu = run(functools.partial(default_mesh_factory, device="cpu"))
    assert card[2] == cpu[2]
    np.testing.assert_array_equal(card[1], cpu[1])
    for a, b in zip(card[0], cpu[0]):
        if isinstance(b, dict):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_serial_run_on_the_card_equals_the_cpu(dev):
    """S1's ``run`` on a card mesh: the fold on the card, equal to the CPU's
    bit for bit, int32 wrapping alike."""
    from repro_torch.core import SerialState, WorkerMesh

    xs = np.random.default_rng(6).integers(-1000, 1000, 300).astype(np.int32)
    pat = SerialState(f=lambda x, s: x * 10 - s // 3,
                      ns=lambda x, s: s * 1000003 + x % 7)
    s0 = torch.tensor(5, dtype=torch.int32)
    ys, s = pat.run(WorkerMesh(4), "workers", xs, s0)
    ys_cpu, s_cpu = pat.run(WorkerMesh(4, device="cpu"), "workers", xs, s0)
    assert ys.is_cuda and ys.dtype == torch.int32
    np.testing.assert_array_equal(ys.cpu().numpy(), ys_cpu.numpy())
    assert int(s) == int(s_cpu)


def test_partitioned_state_stays_on_the_card(dev):
    """S2's state vector is placed on the card once and stays there: over
    three numpy chunks the host synchronizes with the card exactly three
    times, by CUDA's sync debug mode: the chunks' copies to the card (a
    copy back to the host or a value read back would add more; the
    executor's explicit synchronize is not counted)."""
    import warnings

    adapter, xs = _pattern_adapter("S2 block")
    ex = StreamExecutor(adapter, degree=4, chunk_size=16)
    ex.process(xs[:16])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            for i in (1, 2, 3):
                ex.process(xs[i * 16:(i + 1) * 16])
                assert ex.state.is_cuda
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in got
             if "synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 3, syncs


# ---------------------------------------------------------------------------
# training: the flash backward, lse, the guard, a train step
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap, prefix_len), one case
#: per mask mode; "rows without keys" has rows that admit no key (from row
#: 40 on)
BWD_CASES = {
    "causal": (2, 4, 4, 130, 130, 64, True, 0, 0.0, 0),
    "sliding softcap GQA": (1, 8, 2, 200, 200, 128, True, 50, 30.0, 0),
    "prefix-LM hd 256": (1, 4, 1, 150, 150, 256, True, 0, 0.0, 37),
    "bidirectional": (1, 4, 4, 97, 97, 64, False, 0, 10.0, 0),
    "cross": (2, 4, 2, 70, 150, 128, False, 0, 0.0, 0),
    "rows without keys": (1, 2, 1, 60, 30, 64, True, 11, 0.0, 0),
    # bf16: three 128-row kv blocks of the wgmma plan, GQA 4, a ragged Sq
    "GQA ragged prefix-LM": (1, 8, 2, 333, 333, 64, True, 0, 0.0, 100),
}
#: float32 gradients within this share of each one's largest magnitude
#: (sums of up to Sq or Skv products in another order), bfloat16 within
#: 2e-2 of it and one rounding step of each value (chip_smoke.py's limits)
GRAD_REL = 1e-4


def _bwd_inputs(dev, dtype, case, seed=0):
    b, hq, hkv, sq, skv, hd = case[:6]
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)
    return r(b, hq, sq, hd), r(b, hkv, skv, hd), r(b, hkv, skv, hd), \
        r(b, hq, sq, hd)


def _mask_kw(case):
    return dict(zip(("causal", "window", "softcap", "prefix_len"), case[6:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(BWD_CASES))
def test_flash_backward_vs_plain(dev, dtype, mode):
    case, kw = BWD_CASES[mode], _mask_kw(BWD_CASES[mode])
    q, k, v, do = _bwd_inputs(dev, dtype, case)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    o = tfa.flash_attention(q, k, v, lse=lse, **kw)
    before = ops.launch_counts()["flash_attention_backward"]
    got = tfa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    assert ops.launch_counts()["flash_attention_backward"] == before + 1
    again = tfa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    want = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                 # no atomics: same bits
        assert g.dtype == dtype
        gf, wf = g.float(), w.float()
        scale = float(wf.abs().max())
        err = (gf - wf).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= GRAD_REL * scale
        else:
            assert float(err.max()) <= 2e-2 * scale
            assert bool((err <= GRAD_REL * scale
                         + 2.0 ** -7 * wf.abs()).all())


@pytest.mark.parametrize("dtype,hd,kernels", [
    (torch.bfloat16, 64, ("flash_bwd_dkdv_wgmma<", "flash_bwd_dq_wgmma<")),
    (torch.bfloat16, 128, ("flash_bwd_dkdv_wgmma<", "flash_bwd_dq_wgmma<")),
    (torch.float32, 128, ("flash_bwd_dkdv<", "flash_bwd_dq<")),
    (torch.bfloat16, 256, ("flash_bwd_dkdv<", "flash_bwd_dq<")),
])
def test_flash_backward_routes_by_dtype(dev, dtype, hd, kernels):
    """bfloat16 at head_dim 64 and 128 runs the two wgmma kernels; float32,
    and head_dim 256 in either dtype, the float32-FMA kernels; each call
    launches D and those two, counted once.  The profile window holds one
    warm call (the build, the first launch and a first profiler session
    come before it)."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _flash_inputs(dev, dtype, 1, 8, 2, 300, 300, hd, 9)
    do = torch.randn_like(q)
    kw = dict(causal=True, window=100, softcap=50.0)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    o = tfa.flash_attention(q, k, v, lse=lse, **kw)
    with profile(activities=[ProfilerActivity.CUDA]):
        tfa.flash_attention_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    before = ops.launch_counts()["flash_attention_backward"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tfa.flash_attention_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_backward"] == before + 1
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    bwd = sorted(n for n in names if "flash_bwd" in n)
    assert len(bwd) == 3, names
    assert any("flash_bwd_delta<" in n for n in bwd), bwd
    for kernel in kernels:
        assert sum(kernel in n for n in bwd) == 1, (kernel, bwd)
    want = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= (GRAD_REL if dtype == torch.float32 else 2e-2) \
            * float(w.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(BWD_CASES))
def test_flash_lse_vs_plain_logsumexp(dev, dtype, mode):
    case, kw = BWD_CASES[mode], _mask_kw(BWD_CASES[mode])
    q, k, v, _ = _bwd_inputs(dev, dtype, case, seed=1)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    o = tfa.flash_attention(q, k, v, lse=lse, **kw)
    want = tref.flash_attention_lse_ref(q, k, **kw)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isinf(lse), ~finite)
    torch.testing.assert_close(lse[finite], want[finite], atol=1e-4,
                               rtol=1e-6)
    plain = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(o.float(), plain.float(),
                               **(F32 if dtype == torch.float32 else BF16))
    if mode == "rows without keys":
        assert bool((~finite[..., 40:]).all())   # the mean of V there


def test_flash_attention_autograd_uses_the_backward_kernel(dev):
    """``ops.flash_attention`` under grad: one forward with lse, and the
    gradient by the backward kernel, equal to autograd through the plain
    version; without grad the forward launches with no lse."""
    case = BWD_CASES["sliding softcap GQA"]
    kw = _mask_kw(case)
    q, k, v, do = _bwd_inputs(dev, torch.float32, case, seed=2)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    c0 = ops.launch_counts()
    got = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v),
                              do)
    c1 = ops.launch_counts()
    assert c1["flash_attention"] - c0["flash_attention"] == 1
    assert c1["flash_attention_backward"] \
        - c0["flash_attention_backward"] == 1
    ops.use_kernels("ref")
    try:
        want = torch.autograd.grad(ops.flash_attention(q, k, v, **kw),
                                   (q, k, v), do)
    finally:
        ops.use_kernels("auto")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, **kw)
    assert out.grad_fn is None
    assert ops.launch_counts()["flash_attention_backward"] \
        == c1["flash_attention_backward"]


def test_kernels_without_backward_raise_under_grad(dev):
    """The guard: on the card, with grad on and an input that requires
    grad, only decode attention (serving's kernel, which has no backward)
    raises rather than return an output without a gradient, and runs under
    no_grad; the scan, the gather and the combine carry gradients."""
    q = torch.randn(2, 2, 64, device=dev, requires_grad=True)
    cache = torch.randn(2, 1, 16, 64, device=dev)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, cache, cache, 3)
    with torch.no_grad():
        ops.decode_attention(q, cache, cache, 3)
    x = torch.randn(6, 64, device=dev, requires_grad=True)
    rows = torch.tensor([0, 6, 3], dtype=torch.int32, device=dev)
    assert ops.moe_gather(x, rows, max_rows_per_token=1).grad_fn is not None
    out = torch.randn(4, 64, device=dev, requires_grad=True)
    tok = torch.tensor([0, 1, 1, 2], device=dev)
    assert ops.moe_combine(out, tok, torch.ones(4, device=dev), 3,
                           max_rows_per_token=2).grad_fn is not None
    xs = torch.randn(1, 2, 70, 64, device=dev, requires_grad=True)
    args = (torch.rand(1, 2, 70, device=dev), -torch.rand(2, device=dev),
            torch.randn(1, 2, 70, 16, device=dev),
            torch.randn(1, 2, 70, 16, device=dev))
    y, _ = ops.ssd_scan(xs, *args)
    assert y.grad_fn is not None
    with torch.no_grad():
        assert ops.moe_gather(x, rows).shape == (3, 64)
        ops.ssd_scan(xs, *args)
    assert ops.moe_gather(x.detach(), rows).grad_fn is None


def test_serving_launches_unchanged_by_lse(dev):
    """Serving passes no lse: a prefill of a small float32 model launches
    one flash forward per layer and no backward."""
    from repro_torch import configs
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(
        configs.get("paper-synthetic").reduced(), d_model=128, num_heads=2,
        num_kv_heads=2, head_dim=64)
    model = TT.init_params(cfg, 0, device=dev)
    caches = TT.init_caches(cfg, 1, 64, device=dev)
    ops.reset_launch_counts()
    TT.prefill_forward(model, {"tokens": torch.arange(
        40, device=dev)[None] % cfg.vocab_size}, cfg, caches)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers
    assert counts["flash_attention_backward"] == 0


def test_train_step_kernel_mode_equals_ref_mode(dev):
    """A 2-layer float32 MiniCPM-2B at full width, one train step on a
    short batch: ops mode ``kernel`` against ``ref`` on the same weights
    (chip_smoke.py's check (ii) for training, at 512 tokens): the loss to
    1e-5, each gradient leaf to 1e-4 of its largest magnitude, the
    parameters after the AdamW step to its learning rate."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import accumulate_grads
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(configs.get("minicpm-2b"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32",
                              remat=True)
    batch = SyntheticLM(vocab=cfg.padded_vocab, seq_len=256, batch=1,
                        microbatches=2, seed=0, device=dev).batch_at(0)
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=8)
    got = {}
    for mode in ("kernel", "ref"):
        ops.use_kernels(mode)
        try:
            ops.reset_launch_counts()
            p = TT.init_params(cfg, 0, device=dev)
            loss, grads = accumulate_grads(p, batch, cfg)
            adamw.apply_updates(p, grads, adamw.init_state(p), opt_cfg)
            got[mode] = (float(loss), grads, dict(p.named_parameters()),
                         ops.launch_counts())
        finally:
            ops.use_kernels("auto")
    (lk, gk, pk, ck), (lr_, gr, pr, cr) = got["kernel"], got["ref"]
    assert ck["flash_attention"] == 2 * 2 * 2      # layers x mb x remat
    assert ck["flash_attention_backward"] == 2 * 2
    assert cr["flash_attention"] == cr["flash_attention_backward"] == 0
    assert abs(lk - lr_) <= 1e-5 * abs(lr_)
    for n in gk:
        assert float((gk[n] - gr[n]).abs().max()) \
            <= 1e-4 * float(gr[n].abs().max()), n
        assert float((pk[n] - pr[n]).abs().max()) <= 1e-3, n


# ---------------------------------------------------------------------------
# the backward kernels of the scan and the gather
# ---------------------------------------------------------------------------

#: (B, H, S, P, N, per-head B/C, dt shift, with dh_final): Mamba2-780M's
#: layer, one token, tails no chunk divides, B/C per head, a trained
#: model's small dt (the carry decides), a final-state gradient, a small N
#: and P, and the largest state
SCAN_BWD_CASES = {
    "mamba2 layer": (1, 48, 1024, 64, 128, False, 0.0, False),
    "one token": (1, 48, 1, 64, 128, False, 0.0, True),
    "ragged tail": (2, 5, 300, 64, 128, False, 0.0, True),
    "per-head B/C": (1, 6, 257, 64, 128, True, 5.0, True),
    "small dt": (1, 9, 2049, 64, 128, False, 5.0, False),
    "narrow": (2, 3, 70, 8, 16, False, 0.0, True),
    "largest state": (1, 2, 200, 40, 256, True, 0.0, True),
}


def _scan_bwd_inputs(dev, dtype, case, seed=0):
    """The scan's inputs in the model's layouts, B/C in their group layout
    [B, 1 or H, S, N], and the output gradients."""
    b, h, s, p, n, per_head, shift, with_dh = case
    gen = torch.Generator(device=dev).manual_seed(seed + s)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(b, s, h, p, scale=0.5).to(dtype).transpose(1, 2)
    dt = torch.nn.functional.softplus(randn(b, s, h) - shift).transpose(1, 2)
    A = -torch.exp(randn(h, scale=0.3))
    g = h if per_head else 1
    Bm = randn(b, s, g, n, scale=0.3).to(dtype).transpose(1, 2)
    Cm = randn(b, s, g, n, scale=0.3).to(dtype).transpose(1, 2)
    dy = randn(b, s, h, p).to(dtype).transpose(1, 2)
    dh = randn(b, h, n, p) if with_dh else None
    return (x, dt, A, Bm, Cm), dy, dh


def _grads_close(got, want, dtype, rel):
    """Each gradient within ``rel`` (float32) or 5e-2 and one bfloat16
    rounding step (bfloat16) of its largest magnitude."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        gf, wf = g.float(), w.float()
        scale = float(wf.abs().max()) or 1.0
        err = (gf - wf).abs()
        if g.dtype == torch.bfloat16:
            assert float(err.max()) <= 5e-2 * scale
            assert bool((err <= rel * scale + 2.0 ** -7 * wf.abs()).all())
        else:
            assert float(err.max()) <= rel * scale, (float(err.max()), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SCAN_BWD_CASES))
def test_ssd_scan_backward_vs_plain(dev, dtype, case):
    """The backward kernels against ``ref.ssd_scan_backward_ref`` at the
    kernel's chunk: float32 within 2e-4 of each gradient's largest
    magnitude, bfloat16 within 5e-2 of it and one rounding step of each
    value; a second call gives the same bits; one launch a call."""
    args, dy, dh = _scan_bwd_inputs(dev, dtype, SCAN_BWD_CASES[case])
    heads = args[0].shape[1]
    states = tss.ssd_scan(*args[:3], tss.heads_view(args[3], heads),
                          tss.heads_view(args[4], heads),
                          keep_states=True)[2]
    before = ops.launch_counts()["ssd_scan_backward"]
    got = tss.ssd_scan_backward(*args, dy, dh, states=states)
    again = tss.ssd_scan_backward(*args, dy, dh, states=states)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan_backward"] == before + 2
    want = tref.ssd_scan_backward_ref(*args, dy, dh, chunk=tss.CHUNK[dtype])
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _grads_close(got, want, dtype, 2e-4)


def test_ssd_scan_backward_refuses_what_it_does_not_take(dev):
    """A head wider than 64, a group count other than 1 or H, dy unlike x,
    states of other inputs, and the gather's bound missing under grad:
    refused before any launch."""
    args, dy, dh = _scan_bwd_inputs(dev, torch.float32,
                                    SCAN_BWD_CASES["narrow"])
    x, dt, A, Bm, Cm = args
    heads = x.shape[1]
    states = tss.ssd_scan(x, dt, A, tss.heads_view(Bm, heads),
                          tss.heads_view(Cm, heads), keep_states=True)[2]
    counts = ops.launch_counts()
    wide = torch.zeros((1, 2, 8, 96), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tss.ssd_scan_backward(wide, dt[:1, :2, :8], A[:2], Bm[:1, :, :8],
                              Cm[:1, :, :8], wide, states=states)
    two = torch.zeros((2, 2, 70, 16), device=dev)
    with pytest.raises(ValueError, match="1 or H"):
        tss.ssd_scan_backward(x, dt, A, two, two, dy, states=states)
    with pytest.raises(ValueError, match="dy must be like x"):
        tss.ssd_scan_backward(x, dt, A, Bm, Cm, dy.bfloat16(), states=states)
    with pytest.raises(ValueError, match="states"):
        tss.ssd_scan_backward(x, dt, A, Bm, Cm, dy, states=states[:-256])
    xg = torch.randn(6, 64, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="max_rows_per_token"):
        ops.moe_gather(xg, torch.zeros(3, dtype=torch.int32, device=dev))
    assert ops.launch_counts() == counts


def test_scan_and_gather_autograd_use_the_backward_kernels(dev):
    """``ops.ssd_scan`` and ``ops.moe_gather`` under grad: the forward
    kernel once, the backward kernel once, and the gradients of ops mode
    ``ref`` (a shared group's summed over the heads)."""
    args, dy, dh = _scan_bwd_inputs(dev, torch.float32,
                                    SCAN_BWD_CASES["ragged tail"])
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    tok = torch.randint(0, 41, (120,), device=dev, dtype=torch.int32)
    xg = torch.randn(40, 24, device=dev, requires_grad=True)
    dout = torch.randn(120, 24, device=dev)
    got = {}
    for mode in ("auto", "ref"):
        ops.use_kernels(mode)
        try:
            c0 = ops.launch_counts()
            y, hf = ops.ssd_scan(*leaves)
            gs = torch.autograd.grad((y * dy).sum() + (hf * dh).sum(),
                                     leaves)
            gg = torch.autograd.grad(ops.moe_gather(
                xg, tok, max_rows_per_token=120), xg, dout)
            c1 = ops.launch_counts()
        finally:
            ops.use_kernels("auto")
        got[mode] = (gs, gg, {k: c1[k] - c0[k] for k in c1})
    counts = got["auto"][2]
    for k in ("ssd_scan", "ssd_scan_backward", "moe_gather",
              "moe_gather_backward"):
        assert counts[k] == 1 and got["ref"][2][k] == 0, (k, counts)
    assert got["auto"][0][3].shape == args[3].shape   # [B, 1, S, N]
    _grads_close(got["auto"][0], got["ref"][0], torch.float32, 2e-4)
    torch.testing.assert_close(got["auto"][1][0], got["ref"][1][0],
                               rtol=1e-6, atol=1e-6)


def _gather_case(dev, tokens, rows, k, dummies, seed):
    """A buffer of rows naming each token at most k times, ``dummies`` of
    them the dummy ``tokens``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    picks = torch.arange(tokens, device=dev).repeat_interleave(k)[
        torch.randperm(tokens * k, generator=gen, device=dev)]
    tok = torch.full((rows,), tokens, dtype=torch.int32, device=dev)
    live = torch.randperm(rows, generator=gen, device=dev)[:rows - dummies]
    tok[live] = picks[:rows - dummies].to(torch.int32)
    return tok


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 2048),
                                     (torch.float32, 2048),
                                     (torch.float32, 3), (torch.bfloat16, 5)])
def test_moe_gather_backward_bit_exact(dev, dtype, d):
    """16-byte units and single elements: bit-exact against the plain
    version (the same float32 additions in the same order), within one
    rounding step of a float32 ``index_add_``, a second call the same
    bits; a sequence of only dummy rows gives zeros."""
    tokens, k = 300, 6
    tok = _gather_case(dev, tokens, 2000, k, 300, d)
    gen = torch.Generator(device=dev).manual_seed(d + 1)
    dout = torch.randn((2000, d), generator=gen, device=dev).to(dtype)
    before = ops.launch_counts()["moe_gather_backward"]
    got = tmd.moe_gather_backward(dout, tok, tokens, max_rows_per_token=k)
    again = tmd.moe_gather_backward(dout, tok, tokens, max_rows_per_token=k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gather_backward"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, tref.moe_gather_backward_ref(
        dout, tok, tokens, max_rows_per_token=k))
    live = tok < tokens
    yard = torch.zeros((tokens, d), device=dev).index_add_(
        0, tok[live].long(), dout[live].float())
    err = (got.float() - yard).abs()
    assert bool((err <= 1e-5 + 2.0 ** -7 * yard.abs()).all())
    dummies = torch.full((64,), tokens, dtype=torch.int32, device=dev)
    assert not tmd.moe_gather_backward(dout[:64], dummies, tokens,
                                       max_rows_per_token=k).any()


def test_ssm_and_moe_train_step_kernel_mode_equals_ref_mode(dev):
    """Reduced float32 Mamba2-780M and DeepSeekMoE-16B at d_model 128 (the
    scan at head_dim 64), one train step of two microbatches: ops mode
    ``kernel`` against ``ref`` on the same weights; the scan's and the
    gather's backward kernels launch once per layer and microbatch (the
    forward twice, remat); loss 1e-5, each gradient leaf 2e-4 (the scan's
    leaves) or 1e-4 of its largest magnitude, the parameters after the
    step to the learning rate."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import accumulate_grads
    from repro_torch.models import transformer as TT
    from repro_torch.models.config import MAMBA, MOE
    from repro_torch.optim import adamw

    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=8)
    for name in ("mamba2-780m", "deepseek-moe-16b"):
        cfg = dataclasses.replace(configs.get(name).reduced(), head_dim=64,
                                  d_model=128, remat=True)
        specs = cfg.layer_specs()
        n_mamba = sum(s.mixer == MAMBA for s in specs)
        n_moe = sum(s.mlp == MOE for s in specs)
        batch = SyntheticLM(vocab=cfg.padded_vocab, seq_len=200, batch=1,
                            microbatches=2, seed=0, device=dev).batch_at(0)
        got = {}
        for mode in ("kernel", "ref"):
            ops.use_kernels(mode)
            try:
                ops.reset_launch_counts()
                p = TT.init_params(cfg, 0, device=dev)
                loss, grads = accumulate_grads(p, batch, cfg)
                adamw.apply_updates(p, grads, adamw.init_state(p), opt_cfg)
                got[mode] = (float(loss), grads,
                             {n: t.detach() for n, t in p.named_parameters()},
                             ops.launch_counts())
            finally:
                ops.use_kernels("auto")
        (lk, gk, pk, ck), (lr_, gr, pr, cr) = got["kernel"], got["ref"]
        assert ck["ssd_scan"] == n_mamba * 2 * 2
        assert ck["ssd_scan_backward"] == n_mamba * 2
        assert ck["moe_gather"] == n_moe * 2 * 2
        assert ck["moe_gather_backward"] == n_moe * 2
        assert n_mamba + n_moe > 0
        assert all(v == 0 for v in cr.values())
        assert abs(lk - lr_) <= 1e-5 * abs(lr_)
        for n in gk:
            rel = 2e-4 if ".mixer." in n and n_mamba else 1e-4
            assert float((gk[n] - gr[n]).abs().max()) \
                <= rel * float(gr[n].abs().max()), n
            assert float((pk[n] - pr[n]).abs().max()) <= 2e-3, n


# The distributed plane's tests come last: their worker processes make CUDA
# contexts of their own, and in a run of this file with them placed before
# the profiler tests above, a torch.profiler window opened after them held
# no device event.
@pytest.mark.parametrize("transport", ["shm", "pipe"])
def test_dist_plane_on_the_card_equals_in_process(dev, tmp_path, transport):
    """The distributed plane with its workers on the card (spill, TTL,
    early firing, a grow 2 -> 3 and a shrink back, the scatter-ahead
    overlap): every chunk's outputs and the barrier snapshot equal the
    in-process plane's on the card, the workers launched the three keyed
    kernels, and closing it leaves no worker alive."""
    from repro_torch.dist import DistributedKeyedPlane
    from repro_torch.kernels import _build

    _build.library()  # build once here, not in each worker
    spec = WindowSpec("sliding", size=48, slide=16, lateness=3,
                      late_policy="side", early_every=2)
    items = synthetic_keyed_items(16 * 12, num_keys=40, disorder=10, seed=0)
    chunks = [items[i: i + 16] for i in range(0, len(items), 16)]
    table = dict(num_slots=20, backend="device_table", capacity=16,
                 max_probes=4, ttl=4, device=dev)
    schedule = {4: 3, 8: 2}
    ref = StreamExecutor(KeyedWindowAdapter(spec, fused=False, **table),
                         degree=2, chunk_size=16)
    want = ref.run(chunks, schedule=schedule)
    ad = DistributedKeyedPlane(spec, prespawn=3, transport=transport,
                               blackbox_dir=str(tmp_path / "bb"), **table)
    try:
        ex = StreamExecutor(ad, degree=2, chunk_size=16, pipeline=True)
        got = ex.run(chunks, schedule=schedule)
        for a, b in zip(got, want):
            for ch in ("emissions", "early", "late"):
                for k in b[ch]:
                    assert a[ch][k].dtype == b[ch][k].dtype
                    np.testing.assert_array_equal(a[ch][k], b[ch][k])
        snap, ref_snap = ex.snapshot_barrier(), ref.snapshot_barrier()
        for k in ref_snap:
            np.testing.assert_array_equal(snap[k], ref_snap[k], err_msg=k)
        for k in ("segment_sum", "table_lookup", "scatter_add"):
            assert ad.kernel_launches.get(k, 0) > 0, k
        assert not any(ad.fault_events.values())
        hosts = [h for h in ad._pool if h is not None]
    finally:
        ad.close()
    assert hosts and not any(h.proc.is_alive() for h in hosts)


def test_dist_plane_refuses_fork_for_the_card(dev):
    """A forked child cannot initialize CUDA once the coordinator has."""
    from repro_torch.dist import DistributedKeyedPlane

    with pytest.raises(ValueError, match="fork"):
        DistributedKeyedPlane(WindowSpec("tumbling", size=8), num_slots=4,
                              start_method="fork", device=dev)
