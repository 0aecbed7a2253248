"""The dry-run's cost count on the CPU: ``kernels/costs.py``, the kernel
wrappers on ``meta`` inside ``ops.cost_count``, ``launch/cost_analysis.py``
and the counting mesh of ``launch/mesh.py``.

* (i) Each closed form against a brute count at small shapes: products
  against ``FlopCounterMode``'s count of the plain version (exactly when
  nothing is masked; masked attention by its admitted pairs counted from
  the plain version's mask, the scan by the chunks' causal pairs), bytes
  against the sum of the inputs' and outputs' bytes (the rows a decode, a
  gather or a lookup reads).
* (ii) Each entry on ``meta`` inside ``ops.cost_count`` (its CUDA wrapper,
  which allocates as on the card and reports the launch instead of making
  it) gives the shapes and dtypes its plain version gives on the CPU (the
  token table in the kernel's int32), reports one launch, and, under grad,
  the gradients' shapes; it refuses what the kernel refuses; outside a
  count a ``meta`` entry takes the plain version as before.  The attention
  shapes are at head_dim 64, the kernels' smallest.
* (iii) ``analyze_step``'s peak on functions whose live set is known,
  arguments and in-place updates of them not counted.
* (vi) The dry-run's records carry ``costs`` and ``memory_analysis``;
  ``collective_bytes_per_chip`` is the sum of its breakdown and 0 on one
  chip; a second rank's coordinates give rank 0's counts.

The counting mesh's wire bytes against live gloo ranks, and rank 0's
products against the reference's ``hlo_analysis``, are checks of the
multi-rank runs (``test_torch_mesh_*.py``).
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.kernels import costs, ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ShapeConfig

GEN = torch.Generator().manual_seed(34)


def randn(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=GEN).to(dtype)


def flops_of(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# (i) closed forms against brute counts
# ---------------------------------------------------------------------------

ATTN = [(2, 4, 2, 24, 24, 16), (1, 2, 2, 17, 30, 32)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,hd", ATTN)
def test_flash_unmasked_products_and_bytes(b, hq, hkv, sq, skv, hd):
    q, k, v = randn(b, hq, sq, hd), randn(b, hkv, skv, hd), \
        randn(b, hkv, skv, hd)
    cost = costs.flash_attention_cost(b, hq, hkv, sq, skv, hd, 4,
                                      causal=False)
    o = ref.flash_attention_ref(q, k, v, causal=False)
    assert cost.products == flops_of(
        lambda: ref.flash_attention_ref(q, k, v, causal=False))
    assert cost.bytes == nbytes(q, k, v, o)
    lse = torch.empty(b, hq, sq)
    assert costs.flash_attention_cost(
        b, hq, hkv, sq, skv, hd, 4, causal=False, lse=True).bytes \
        == nbytes(q, k, v, o, lse)
    dout = randn(b, hq, sq, hd)
    back = costs.flash_attention_backward_cost(b, hq, hkv, sq, skv, hd, 4,
                                               causal=False)
    grads = ref.flash_attention_backward_ref(q, k, v, o, lse, dout,
                                             causal=False)
    assert back.products == flops_of(
        lambda: ref.flash_attention_backward_ref(q, k, v, o, lse, dout,
                                                 causal=False))
    assert back.bytes == nbytes(q, k, v, o, dout, lse, *grads)


@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=True, window=5),
                                  dict(causal=True, prefix_len=7),
                                  dict(causal=False, window=4)])
def test_flash_masked_products_by_admitted_pairs(mask):
    b, hq, hkv, sq, skv, hd = 2, 4, 2, 20, 26, 16
    q, k = randn(b, hq, sq, hd), randn(b, hkv, skv, hd)
    _, _, admitted = ref._flash_scores(q, k, mask["causal"],
                                       mask.get("window", 0), 0.0,
                                       mask.get("prefix_len", 0))
    pairs = int(admitted.sum())
    assert costs.admitted_pairs(sq, skv, mask["causal"],
                                mask.get("window", 0),
                                mask.get("prefix_len", 0)) == pairs
    fwd = costs.flash_attention_cost(b, hq, hkv, sq, skv, hd, 2, **mask)
    back = costs.flash_attention_backward_cost(b, hq, hkv, sq, skv, hd, 2,
                                               **mask)
    assert fwd.products == 4 * hd * b * hq * pairs
    assert back.products == 10 * hd * b * hq * pairs
    assert fwd.flops - fwd.products == costs.ATTN_POINTWISE * b * hq * pairs


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("partial", [False, True])
def test_decode_products_and_bytes(window, partial):
    b, hq, hkv, s, hd = 3, 8, 2, 40, 32
    q, ck, cv = randn(b, hq, hd), randn(b, hkv, s, hd), randn(b, hkv, s, hd)
    valid = torch.tensor([40, 17, 1])
    _, _, admitted = ref._decode_scores(q, ck, cv, valid, 0, 0.0, window)
    rows = int(admitted[:, 0].sum())       # per kv head, over the slots
    assert costs.decode_rows(valid.numpy(), window, s) == rows
    cost = costs.decode_attention_cost(b, hq, hkv, s, hd, 4, rows,
                                       partial=partial)
    assert cost.products == 4 * hd * hq * rows
    if partial:
        out = ref.decode_attention_partial_ref(q, ck, cv, valid, 0,
                                               window=window)
    else:
        out = (ref.decode_attention_ref(q, ck, cv, valid, window=window),)
    read = 2 * rows * hkv * hd * 4        # the admitted rows of K and V
    assert cost.bytes == read + nbytes(q, *out)
    if not window:   # every row admitted: the plain version's products
        full = torch.full((b,), s)
        whole = costs.decode_attention_cost(b, hq, hkv, s, hd, 4, b * s)
        assert whole.products == flops_of(
            lambda: ref.decode_attention_ref(q, ck, cv, full))
        assert whole.bytes == nbytes(q, ck, cv, out[0])


@pytest.mark.parametrize("s,chunk,groups", [(128, 64, 1), (128, 128, 4),
                                            (100, 64, 1)])
def test_scan_products_by_causal_pairs_and_bytes(s, chunk, groups):
    b, h, p, n = 1, 4, 16, 8
    x, dt, A = randn(b, h, s, p), torch.rand(b, h, s), -torch.rand(h)
    Bm, Cm, dy = randn(b, groups, s, n), randn(b, groups, s, n), \
        randn(b, h, s, p)
    nc = -(-s // chunk)
    # the plain version computes every chunk's c x c pairs densely (a tail
    # chunk padded): its upper triangle is what the kernel skips
    dense = flops_of(lambda: ref.ssd_scan_ref(
        x, dt, A, ss.heads_view(Bm, h), ss.heads_view(Cm, h), chunk=chunk))
    skipped = b * h * (nc * chunk * chunk - costs.ssd_pairs(s, chunk))
    if s % chunk == 0:
        cost = costs.ssd_scan_cost(b, h, s, p, n, groups, 4, chunk)
        assert cost.products == dense - 2 * skipped * (n + p)
        # the backward's plain version also recomputes the forward's chunk
        # states (N P a position and head), which the kernel reads from
        # the forward's workspace
        back = costs.ssd_scan_backward_cost(b, h, s, p, n, groups, 4, chunk)
        plain = flops_of(lambda: ref.ssd_scan_backward_ref(
            x, dt, A, Bm, Cm, dy, chunk=chunk))
        assert back.products == plain - 2 * skipped * (3 * n + 2 * p) \
            - 2 * b * h * s * n * p
    y, hs = ref.ssd_scan_ref(x, dt, A, ss.heads_view(Bm, h),
                             ss.heads_view(Cm, h))
    grads = ref.ssd_scan_backward_ref(x, dt, A, Bm, Cm, dy)
    assert costs.ssd_scan_cost(b, h, s, p, n, groups, 4, chunk).bytes \
        == nbytes(x, dt, A, Bm, Cm, y, hs)
    assert costs.ssd_scan_backward_cost(b, h, s, p, n, groups, 4,
                                        chunk).bytes \
        == nbytes(x, dt, A, Bm, Cm, dy, *grads)
    assert costs.ssd_work(b, h, s, p, n, chunk) \
        == costs.ssd_scan_cost(b, h, s, p, n, groups, 4, chunk).products


def test_moe_and_keyed_bytes():
    t, r, d, k = 10, 24, 16, 3
    x = randn(t, d, dtype=torch.bfloat16)
    tok = torch.randint(0, t + 1, (r,), generator=GEN).to(torch.int32)
    out = ref.moe_gather_ref(x, tok)
    assert costs.moe_gather_cost(r, d, 2).bytes == nbytes(tok, out) + nbytes(
        out)                                  # the rows read, then written
    table = ref.token_rows_table(tok, t, k).to(torch.int32)
    assert costs.token_rows_table_cost(r, t, k).bytes == nbytes(tok, table)
    dx = ref.moe_gather_backward_ref(out, tok, t, max_rows_per_token=k)
    back = costs.moe_gather_backward_cost(t, r, d, k, 2)
    assert back.bytes == nbytes(out, table, dx)
    assert back.flops == out.numel()
    vals = torch.randint(0, 9, (r, 2), generator=GEN).to(torch.int32)
    ids = torch.sort(torch.randint(0, 7, (r,), generator=GEN)).values \
        .to(torch.int32)
    sums = ref.segment_sum_sorted(vals, ids, 7)
    seg = costs.segment_sum_cost(r, 2, 7, 4)
    assert seg.bytes == nbytes(vals, ids, sums) and seg.flops == vals.numel()
    tab = torch.zeros(7, 2, dtype=torch.int64)
    rows = vals.to(torch.int64)
    assert costs.scatter_add_cost(r, 2, 8).bytes \
        == nbytes(ids, rows) + 2 * nbytes(rows)   # each target read, written
    # a lookup reads each cell, writes its row, reads its probe window
    n, cap, probes = 5, 64, 4
    lk = costs.table_lookup_cost(n, cap, probes)
    assert lk.bytes == n * (16 + 4) + n * probes * 17
    assert costs.table_lookup_cost(n, 8, probes).bytes == n * 20 + 8 * 17
    assert costs.batched_table_lookup_cost(n, cap, probes).bytes \
        == n * 24 + n * probes * 17
    assert lk.flops == n * probes * 5
    del tab


def test_bounds_unchanged():
    """The bounds chip_smoke.py reports, from the same formulas."""
    assert costs.bound(3.35e9, 0) == (1.0, "bytes")
    assert costs.bound(0, 67e9) == (1.0, "operations")
    assert costs.attention_bound(1000, 2, 64, 0)[0] == pytest.approx(
        1000 * 2 * 4 * 64 / 989e12 * 1e3)
    ms, by = costs.flash_backward_bound(100, 8, 1, 64, 64, 256, 2)
    want = 2 * (3 * 8 * 64 * 256 + 2 * 64 * 256) + 4 * 8 * 64 \
        + 2 * (8 * 64 * 256 + 2 * 64 * 256)
    assert (ms, by) == (want / 3.35e12 * 1e3, "bytes")
    ms, by, nb, ops_n = costs.scan_backward_bound(1, 24, 4096, 64, 128, 1, 2)
    assert ops_n == 10 * 24 * 4096 * 128 * 64 and by == "bytes"
    assert costs.roofline_ms(989e12, 0) == 1e3


# ---------------------------------------------------------------------------
# (ii) the wrappers on meta
# ---------------------------------------------------------------------------

def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _entries():
    b, hq, hkv, s, hd = 2, 4, 2, 20, 64
    q, k, v = randn(b, hq, s, hd), randn(b, hkv, s, hd), randn(b, hkv, s, hd)
    qd, valid = randn(b, hq, hd), torch.tensor([20, 7])
    x, dt, A = randn(1, 4, 70, 16), torch.rand(1, 4, 70), -torch.rand(4)
    Bm, Cm = randn(1, 1, 70, 8), randn(1, 1, 70, 8)
    xt, tok = randn(10, 16), torch.randint(0, 11, (24,), generator=GEN)
    vals = torch.randint(0, 9, (24, 2), generator=GEN).to(torch.int32)
    ids = torch.sort(torch.randint(0, 7, (24,), generator=GEN)).values
    keys = torch.randint(0, 5, (6,), generator=GEN)
    tkeys = torch.randint(0, 5, (16,), generator=GEN)
    occ = torch.ones(16, dtype=torch.bool)
    return {
        "flash_attention": (ops.flash_attention, (q, k, v),
                            dict(window=5)),
        "decode_attention": (ops.decode_attention, (qd, k, v, valid), {}),
        "decode_attention_partial": (ops.decode_attention_partial,
                                     (qd, k, v, valid, 3), {}),
        "ssd_scan": (ops.ssd_scan, (x, dt, A, Bm, Cm), {}),
        "moe_gather": (ops.moe_gather, (xt, tok), {}),
        "token_rows_table": (ops.token_rows_table, (tok, 10, 3), {}),
        "segment_sum": (ops.segment_sum_sorted, (vals, ids, 7), {}),
        "scatter_add": (ops.scatter_add, (torch.zeros(7, 2), ids,
                                          vals.float()), {}),
        "table_lookup": (ops.table_lookup, (keys, keys, tkeys, tkeys, occ,
                                            4), {}),
        "batched_table_lookup": (ops.batched_table_lookup,
                                 (keys % 2, keys, keys, tkeys, tkeys, occ, 8,
                                  4), {}),
    }


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("entry", sorted(_entries()))
def test_shape_only_route_matches_plain(entry):
    fn, args, kw = _entries()[entry]
    plain = _flat(fn(*args, **kw))
    margs = tuple(_meta(a) if isinstance(a, torch.Tensor) else a
                  for a in args)
    seen = []
    with ops.cost_count(lambda e, cost, note: seen.append((e, cost))):
        got = _flat(fn(*margs, **kw))
    assert [e for e, _ in seen] == [entry]
    for g, p in zip(got, plain, strict=True):
        assert g.is_meta and g.shape == p.shape
        if entry == "token_rows_table":   # the kernel's table is int32
            assert (g.dtype, p.dtype) == (torch.int32, torch.int64)
        else:
            assert g.dtype == p.dtype
    # outside a count a meta tensor takes the plain version, as before
    before = _flat(fn(*margs, **kw)) if entry not in (
        "segment_sum", "token_rows_table", "table_lookup",
        "batched_table_lookup", "scatter_add", "moe_gather") else None
    if before is not None:
        assert [t.shape for t in before] == [t.shape for t in plain]


def test_count_refuses_what_the_kernel_refuses():
    """A head_dim the kernels are not built for raises in a count, as it
    does on the card; the plain version takes it."""
    q = torch.empty(1, 2, 8, 16, device="meta")
    with ops.cost_count(lambda *a: None):
        with pytest.raises(ValueError, match="head_dim"):
            ops.flash_attention(q, q, q)
        ops.use_kernels("ref")
        try:
            assert ops.flash_attention(q, q, q).shape == q.shape
        finally:
            ops.use_kernels("auto")


def test_meta_outside_a_count_is_the_plain_version():
    q, k = torch.empty(1, 2, 8, 16, device="meta"), \
        torch.empty(1, 2, 8, 16, device="meta")
    with FlopCounterMode(display=False) as counter:
        ops.flash_attention(q, k, k, causal=False)
    assert counter.get_total_flops() == 4 * 16 * 2 * 8 * 8


@pytest.mark.parametrize("entry", ["flash_attention", "ssd_scan",
                                   "moe_gather"])
def test_shape_only_route_under_grad(entry):
    if entry == "flash_attention":
        args = [randn(2, 4, 12, 64), randn(2, 2, 12, 64), randn(2, 2, 12, 64)]
        grads_of = args

        def run(*a):
            return ops.flash_attention(*a).sum()
        launches = ["flash_attention", "flash_attention_backward"]
    elif entry == "ssd_scan":
        args = [randn(1, 4, 40, 16), torch.rand(1, 4, 40), -torch.rand(4),
                randn(1, 1, 40, 8), randn(1, 1, 40, 8)]
        grads_of = [args[0], args[1], args[3], args[4]]

        def run(*a):
            y, h = ops.ssd_scan(*a)
            return y.sum() + h.sum()
        launches = ["ssd_scan", "ssd_scan_backward"]
    else:
        tok = torch.randint(0, 11, (24,), generator=GEN)
        args = [randn(10, 16)]
        grads_of = args

        def run(x):
            return ops.moe_gather(x, tok.to(x.device),
                                  max_rows_per_token=3).sum()
        launches = ["moe_gather", "token_rows_table", "moe_gather_backward"]
    want = torch.autograd.grad(run(*[a.requires_grad_() for a in args]),
                               grads_of)
    margs = [_meta(a).requires_grad_() for a in args]
    mgrads_of = [next(m for a, m in zip(args, margs) if a is g)
                 for g in grads_of]
    seen = []
    with ops.cost_count(lambda e, cost, note: seen.append(e)):
        got = torch.autograd.grad(run(*margs), mgrads_of)
    assert seen == launches
    assert [(g.shape, g.dtype) for g in got] \
        == [(w.shape, w.dtype) for w in want]


# ---------------------------------------------------------------------------
# (iii) the peak tracker
# ---------------------------------------------------------------------------

def test_peak_of_a_known_live_set():
    x = torch.empty(1024, device="meta")              # 4 KiB, an argument

    def step(x):
        x.add_(1.0)                # in place on an argument: not counted
        a = x * 2                  # 4 KiB live
        b = a + 1                  # 8 KiB live
        del a                      # 4 KiB
        c = torch.empty(2048, device="meta")          # 12 KiB: the peak
        del c
        d = torch.empty(512, device="meta")           # 6 KiB
        return b, d

    s = ca.analyze_step(step, [x])
    assert s.peak_bytes == 4096 + 8192
    assert s.argument_bytes == 4096 and s.output_bytes == 4096 + 2048
    # the three ops' reads and writes (the allocations are free)
    assert s.hbm_bytes == 3 * 2 * 4096
    assert s.flops == 3 * 1024 and s.dot_flops == 0
    assert s.kernel_launches == {} and s.collective_bytes == 0


def test_peak_counts_views_once_and_products():
    a, w = torch.empty(64, 32, device="meta"), torch.empty(32, 16,
                                                            device="meta")

    def step(a, w):
        h = a @ w                          # 4 KiB
        v = h.t()                          # a view: free
        return (v.contiguous() * 2).sum()  # 4 + 4 KiB at once

    s = ca.analyze_step(step, [a, w])
    assert s.dot_flops == 2 * 64 * 32 * 16
    assert s.peak_bytes == 3 * 64 * 16 * 4
    with pytest.raises(ValueError, match="meta tensors only"):
        ca.analyze_step(step, [torch.ones(64, 32), torch.ones(32, 16)])


# ---------------------------------------------------------------------------
# the counting mesh
# ---------------------------------------------------------------------------

def test_counting_mesh_counts_without_a_process_group():
    layout = mesh_lib.MeshLayout(("pod", "data", "model"), (2, 16, 16))
    live = mesh_lib.counting_mesh(layout, {"pod": 1, "data": 3, "model": 5})
    assert live.counting and live.rank == (1 * 16 + 3) * 16 + 5
    assert live.index(("pod", "data")) == 19 and live.group("model") is None
    with pytest.raises(ValueError, match="do not lie"):
        mesh_lib.counting_mesh(layout, {"pod": 2, "data": 0, "model": 0})
    x = torch.empty(4, 8, device="meta")
    before = mesh_lib.wire_bytes()
    mesh_lib.reset_wire_bytes()
    try:
        assert mesh_lib.all_reduce(x, live, "model").shape == (4, 8)
        assert mesh_lib.all_gather(x, live, "data", 1).shape == (4, 128)
        assert mesh_lib.reduce_scatter(torch.empty(32, 8, device="meta"),
                                       live, ("pod", "data"), 0).shape \
            == (1, 8)
        assert mesh_lib.all_to_all(torch.empty(16, 2, device="meta"), live,
                                   "model").shape == (16, 2)
        rows = [0] * 512
        rows[live.rank], rows[0] = 3, 2
        assert mesh_lib.group_all_to_all_rows(
            torch.empty(5, 4, device="meta"), rows, rows, live).shape \
            == (5, 4)
        assert mesh_lib.wire_bytes() == {
            "all_reduce": 2 * 128 * 15 / 16, "all_gather": 2048 * 15 / 16,
            "reduce_scatter": 1024 * 31 / 32, "all_to_all": 128 * 15 / 16
            + 2 * 16}
        with pytest.raises(ValueError, match="meta tensors only"):
            mesh_lib.all_reduce(torch.ones(2), live, "model")
    finally:
        mesh_lib.WIRE_BYTES.update(before)


# ---------------------------------------------------------------------------
# (vi) the dry-run's records
# ---------------------------------------------------------------------------

SMALL_PREFILL = ShapeConfig("prefill_small", 32, 4, "prefill")
SMALL_TRAIN = ShapeConfig("train_small", 32, 4, "train")


@pytest.mark.parametrize("name,shape", [("minicpm-2b", SMALL_PREFILL),
                                        ("deepseek-moe-16b", SMALL_TRAIN)])
def test_dryrun_records_carry_costs(name, shape, tmp_path):
    # head_dim 64, the kernels' smallest (the reduced configs' 16 is no
    # kernel's: test_dryrun_skips_a_rank_the_kernels_refuse)
    cfg = dataclasses.replace(configs.get(name).reduced(), head_dim=64)
    wide = mesh_lib.MeshLayout(("data", "model"), (2, 2))
    knobs = dict(microbatches=1) if shape.kind == "train" else {}
    for tag, layout in (("host", mesh_lib.make_host_mesh()),
                        ("dp2tp2", wide)):
        rec = dryrun.run_cell(cfg, shape, layout, str(tmp_path), tag,
                              **knobs)
        assert rec["status"] == "ok", rec.get("traceback")
        c, mem = rec["costs"], rec["memory_analysis"]
        assert c["num_partitions"] == layout.size
        assert c["collective_bytes_per_chip"] == sum(
            c["collective_breakdown"].values())
        assert (c["collective_bytes_per_chip"] == 0) == (layout.size == 1)
        assert c["flops_per_chip"] >= c["dot_flops_per_chip"] > 0
        assert c["hbm_bytes_per_chip"] > 0 and c["kernel_launches"]
        assert mem["temp_size_in_bytes"] == c["peak_bytes_per_chip"] > 0
        assert mem["generated_code_size_in_bytes"] is None
        assert mem["argument_size_in_bytes"] == rec["bytes_per_chip"][
            "total"]
    # another rank's coordinates give rank 0's counts
    first = dryrun.rank_costs(cfg, shape, wide, **knobs)
    other = dryrun.rank_costs(cfg, shape, wide, {"data": 1, "model": 1},
                              **knobs)
    assert first == other


def test_dryrun_skips_a_rank_the_kernels_refuse(tmp_path):
    """A cell whose kernels the card would refuse has no rank count: the
    record says why, and keeps the plain-version fields."""
    cfg = configs.get("minicpm-2b").reduced()
    rec = dryrun.run_cell(cfg, SMALL_PREFILL, mesh_lib.make_host_mesh(),
                          None, "host")
    assert rec["status"] == "ok" and rec["flops"]["products_per_step"] > 0
    assert "head_dim must be one of" in rec["costs"]["skipped"]
    assert rec["memory_analysis"] == rec["costs"]


def test_dryrun_one_chip_costs_are_the_step_count():
    """On the one-chip layout the rank's products with the plain versions
    are the whole step's, the dry-run's FlopCounterMode count."""
    cfg = configs.get("mamba2-780m").reduced()
    shape = dataclasses.replace(SMALL_PREFILL, seq_len=64)
    layout = mesh_lib.make_host_mesh()
    cell = dryrun.steps.build_cell(cfg, shape, layout, device="meta",
                                   mesh=mesh_lib.counting_mesh(layout))
    ops.use_kernels("ref")   # the plain versions, op by op
    try:
        plain = ca.count_cell(cell)
    finally:
        ops.use_kernels("auto")
    whole = dryrun.count_flops(cell, cfg, shape)
    assert plain.dot_flops == whole["products"]
    assert plain.collective_bytes == 0
