"""The port's four keyed-plane kernels against the JAX package's.

Each plain PyTorch version (what a CPU tensor dispatches to) is fed the same
numpy inputs as the reference's jnp oracle and its Pallas kernel in
interpret mode.  Integers must be bit-exact — int32 wraparound and negative
int64 keys included; float32 sums are held to 3e-5, the tolerance the
reference holds its own kernels to, because the order of the sum differs.
The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hash_table as jht
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import segment_reduce as jsr
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import hash_table as tht
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels import ssd_scan as tss

F32 = dict(atol=3e-5, rtol=3e-5)
I64 = np.iinfo(np.int64)


def t(a):
    return torch.as_tensor(np.asarray(a))


def _interpret(fn, *args):
    jops.use_kernels("interpret")
    try:
        return np.asarray(fn(*args))
    finally:
        jops.use_kernels("auto")


# ---------------------------------------------------------------------------
# segment_sum
# ---------------------------------------------------------------------------

class TestSegmentSum:
    @pytest.mark.parametrize("R,S,d", [(1, 1, 1), (37, 5, 2), (300, 40, 3)])
    def test_int32_wraparound_and_dropped_ids(self, R, S, d):
        """Values near 2^31 overflow the int32 accumulator: the port wraps
        exactly like the reference; ids >= S contribute nothing."""
        rng = np.random.default_rng(R)
        ids = rng.integers(0, S + 3, R).astype(np.int32)
        vals = rng.integers(2 ** 31 - 500, 2 ** 31, (R, d)).astype(np.int32)
        got = tops.segment_sum(t(vals), t(ids), S).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, np.asarray(jref.segment_sum_ref(jnp.asarray(vals),
                                                 jnp.asarray(ids), S)))
        np.testing.assert_array_equal(
            got, np.asarray(jsr.segment_sum(jnp.asarray(vals),
                                            jnp.asarray(ids), S,
                                            block_rows=16, interpret=True)))

    def test_float32_within_tolerance(self):
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 30, 400).astype(np.int32)
        vals = rng.standard_normal((400, 2)).astype(np.float32)
        got = tops.segment_sum(t(vals), t(ids), 25).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(
            got, np.asarray(jref.segment_sum_ref(vals, ids, 25)), **F32)
        np.testing.assert_allclose(
            got, np.asarray(jsr.segment_sum(jnp.asarray(vals),
                                            jnp.asarray(ids), 25,
                                            interpret=True)), **F32)

    @pytest.mark.parametrize("with_padding", [False, True])
    def test_sorted_prefix_realization(self, with_padding):
        """The scatter-free prefix-sum path for sorted ids equals the
        reference's, wraparound included (its int32 prefix wraps; the
        port's int64 prefix wrapped to int32 gives the same segments)."""
        rng = np.random.default_rng(2)
        S = 20
        ids = np.sort(rng.integers(0, S + (4 if with_padding else 0), 200)
                      ).astype(np.int32)
        vals = rng.integers(-2 ** 31, 2 ** 31, (200, 2)).astype(np.int32)
        got = tops.segment_sum_sorted(t(vals), t(ids), S).numpy()
        want = np.asarray(jsr.segment_sum_sorted(jnp.asarray(vals),
                                                 jnp.asarray(ids), S))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, tref.segment_sum_ref(t(vals), t(ids), S).numpy())

    def test_empty_input(self):
        out = tops.segment_sum(torch.zeros((0, 2), dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32), 4)
        assert out.shape == (4, 2) and not out.any()
        out = tops.segment_sum_sorted(torch.zeros((0, 2), dtype=torch.int32),
                                      torch.zeros(0, dtype=torch.int32), 4)
        assert out.shape == (4, 2) and not out.any()


# ---------------------------------------------------------------------------
# scatter_add
# ---------------------------------------------------------------------------

class TestScatterAdd:
    def test_int32_matches_reference_and_kernel(self):
        rng = np.random.default_rng(3)
        table = rng.integers(2 ** 30, 2 ** 31 - 1, (17, 2)).astype(np.int32)
        ids = rng.integers(0, 20, 90).astype(np.int32)  # >= 17 dropped
        rows = rng.integers(2 ** 29, 2 ** 30, (90, 2)).astype(np.int32)
        got = tops.scatter_add(t(table), t(ids), t(rows)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, np.asarray(jref.scatter_add_ref(jnp.asarray(table),
                                                 jnp.asarray(ids),
                                                 jnp.asarray(rows))))
        np.testing.assert_array_equal(
            got, np.asarray(jsr.scatter_add(jnp.asarray(table),
                                            jnp.asarray(ids),
                                            jnp.asarray(rows),
                                            block_rows=32, interpret=True)))

    def test_float32_within_tolerance(self):
        rng = np.random.default_rng(4)
        table = rng.standard_normal((9, 3)).astype(np.float32)
        ids = rng.integers(0, 11, 120).astype(np.int32)
        rows = rng.standard_normal((120, 3)).astype(np.float32)
        got = tops.scatter_add(t(table), t(ids), t(rows)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jsr.scatter_add(jnp.asarray(table),
                                            jnp.asarray(ids),
                                            jnp.asarray(rows),
                                            interpret=True)), **F32)

    def test_int64_equals_np_add_at(self):
        """The window table's accumulate: int64, repeats, ids >= C dropped,
        values large enough to wrap 2^64 — exactly ``np.add.at``."""
        rng = np.random.default_rng(5)
        table = rng.integers(2 ** 62, I64.max, (13, 2))
        ids = rng.integers(0, 16, 200)
        rows = rng.integers(2 ** 60, 2 ** 62, (200, 2))
        want = table.copy()
        ok = ids < 13
        with np.errstate(over="ignore"):
            np.add.at(want, ids[ok], rows[ok])
        got = t(table).clone()
        tops.scatter_add_(got, t(ids), t(rows))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tops.scatter_add(t(table), t(ids), t(rows)).numpy(), want)


# ---------------------------------------------------------------------------
# table lookups
# ---------------------------------------------------------------------------

def _lookup_case(seed, n=60, capacity=45):
    """Keys from a small pool of extreme / negative int64 values so cells
    hit, miss and match duplicate rows (a table that breaks the
    probe-window invariant: the least occupied match must win)."""
    rng = np.random.default_rng(seed)
    pool = np.array([I64.min, I64.max, -1, 0, 1, -(2 ** 40), 2 ** 33 + 5],
                    np.int64)
    tk = rng.choice(pool, capacity)
    ts = rng.integers(-2, 2, capacity) * 7
    occ = rng.random(capacity) < 0.6
    ck = rng.choice(np.append(pool, 12345), n)
    cs = rng.integers(-2, 3, n) * 7
    return ck, cs, tk, ts, occ


class TestTableLookup:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_reference_and_interpret_kernel(self, seed):
        ck, cs, tk, ts, occ = _lookup_case(seed)
        got = tops.table_lookup(t(ck), t(cs), t(tk), t(ts), t(occ)).numpy()
        assert got.dtype == np.int32
        assert (got == len(tk)).any() and (got < len(tk)).any()
        jops.use_kernels("ref")
        try:
            want = np.asarray(jops.table_lookup(ck, cs, tk, ts, occ))
        finally:
            jops.use_kernels("auto")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, _interpret(jops.table_lookup, ck, cs, tk, ts, occ))

    def test_blocked_interpret_kernel_with_padding(self):
        ck, cs, tk, ts, occ = _lookup_case(7, n=23, capacity=37)
        cells = jops._split_i64(ck) + jops._split_i64(cs)
        table = jops._split_i64(tk) + jops._split_i64(ts)
        want = np.asarray(jht.table_lookup(
            cells, table, occ.astype(np.int32), block_cells=8,
            block_table=16, interpret=True))
        got = tops.table_lookup(t(ck), t(cs), t(tk), t(ts), t(occ)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("seed", [3, 4])
    def test_batched_matches_reference_and_interpret_kernel(self, seed):
        """The owner plane keeps matches inside the cell's own shard: the
        same (key, start) in another shard's rows is not a match."""
        ck, cs, tk, ts, occ = _lookup_case(seed, capacity=48)
        rng = np.random.default_rng(seed)
        row_own = np.arange(48) // 12
        c_own = rng.integers(0, 5, len(ck))  # owner 4 has no rows
        got = tops.batched_table_lookup(t(c_own), t(ck), t(cs), t(row_own),
                                        t(tk), t(ts), t(occ)).numpy()
        jops.use_kernels("ref")
        try:
            want = np.asarray(jops.batched_table_lookup(
                c_own, ck, cs, row_own, tk, ts, occ))
        finally:
            jops.use_kernels("auto")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _interpret(
            jops.batched_table_lookup, c_own, ck, cs, row_own, tk, ts, occ))
        assert (got[c_own == 4] == 48).all()

    def test_tiled_plain_version_equals_untiled(self, monkeypatch):
        ck, cs, tk, ts, occ = _lookup_case(9, n=50)
        whole = tref.table_lookup_ref(t(ck), t(cs), t(tk), t(ts), t(occ))
        monkeypatch.setattr(tref, "LOOKUP_TILE_ELEMS", 3 * len(tk))
        tiled = tref.table_lookup_ref(t(ck), t(cs), t(tk), t(ts), t(occ))
        np.testing.assert_array_equal(whole.numpy(), tiled.numpy())

    def test_empty_cells_and_empty_table(self):
        z = torch.zeros(0, dtype=torch.int64)
        _, _, tk, ts, occ = _lookup_case(0)
        assert len(tops.table_lookup(z, z, t(tk), t(ts), t(occ))) == 0
        out = tops.table_lookup(t([1, 2]), t([0, 0]), z, z,
                                torch.zeros(0, dtype=torch.bool))
        np.testing.assert_array_equal(out.numpy(), [0, 0])


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class TestDispatch:
    def test_cpu_tensors_take_the_plain_versions(self):
        tops.reset_launch_counts()
        ck, cs, tk, ts, occ = _lookup_case(0)
        tops.table_lookup(t(ck), t(cs), t(tk), t(ts), t(occ))
        tops.segment_sum(t(np.ones((4, 2), np.int32)), t(np.arange(4)), 4)
        tops.scatter_add_(t(np.zeros((4, 2), np.int64)), t(np.arange(4)),
                          t(np.ones((4, 2), np.int64)))
        qkv = torch.ones((1, 2, 3, 64))
        tops.flash_attention(qkv, qkv, qkv)
        tops.decode_attention(qkv[:, :, 0], qkv, qkv, 2)
        tops.ssd_scan(qkv, qkv[..., 0], torch.ones(2), qkv, qkv)
        tops.moe_gather(qkv[0, 0], t(np.arange(4, dtype=np.int32)))
        assert tops.launch_counts() == dict.fromkeys(
            ("segment_sum", "scatter_add", "table_lookup",
             "batched_table_lookup", "flash_attention", "decode_attention",
             "ssd_scan", "moe_gather"), 0)
        assert not tops.kernels_active("cpu")

    def test_kernel_mode_refuses_cpu_tensors(self):
        tops.use_kernels("kernel")
        try:
            with pytest.raises(RuntimeError, match="CUDA"):
                tops.segment_sum(t(np.ones((2, 1), np.int32)),
                                 t(np.zeros(2, np.int32)), 1)
        finally:
            tops.use_kernels("auto")

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError):
            tops.use_kernels("interpret")
        assert tops.kernels_active("cpu") is False

    def test_wrappers_refuse_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            tsr.segment_sum(t(np.ones((2, 1), np.int32)),
                            t(np.zeros(2, np.int32)), 1)
        with pytest.raises(ValueError, match="CUDA"):
            tht.table_lookup(*(t(np.zeros(2, np.int64)),) * 4,
                             t(np.zeros(2, bool)))
        qkv = torch.ones((1, 2, 3, 64))
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention(qkv, qkv, qkv)
        with pytest.raises(ValueError, match="CUDA"):
            tda.decode_attention(qkv[:, :, 0], qkv, qkv,
                                 torch.ones(1, dtype=torch.int32))
        with pytest.raises(ValueError, match="CUDA"):
            tss.ssd_scan(qkv, qkv[..., 0], torch.ones(2), qkv, qkv)
        with pytest.raises(ValueError, match="CUDA"):
            tmd.moe_gather(qkv[0, 0], torch.zeros(2, dtype=torch.int32))
