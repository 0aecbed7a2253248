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
from repro.keyed import table as jtable
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

#: extreme and negative int64 keys, the cells' key pool
POOL = np.array([I64.min, I64.max, -1, 0, 1, -(2 ** 40), 2 ** 33 + 5, 12345],
                np.int64)
MAX_PROBES = 16


def _window_tables(seed, capacity, n_w):
    """Window tables built by the JAX package's own mutators, so they hold
    the invariant (a live cell has one row, inside its probe window).

    Cells are the pool's keys at 7 window starts; about 70% are placed,
    each in one of the first ``n_w - 1`` shards (the last has no rows), by
    ``BatchedWindowTable.update`` over a canonically sorted batch; a
    watermark then closes some of them, which leaves stale unoccupied
    copies behind, and stale copies of further cells are written into
    unoccupied rows of their own windows.  At this capacity many windows
    wrap the segment's end.  Returns the table and the looked-up cells
    ``(owner, key, start)``: every cell, each with the owner it was placed
    under (a random one for the others, the empty shard included)."""
    rng = np.random.default_rng(seed)
    tables = [jtable.DeviceWindowTable(capacity, max_probes=MAX_PROBES)
              for _ in range(n_w)]
    bt = jtable.BatchedWindowTable(tables)
    ck = np.repeat(POOL, 7)
    cs = np.tile(np.arange(-3, 4, dtype=np.int64) * 7, len(POOL))
    own = rng.integers(0, n_w - 1, len(ck))
    put = rng.random(len(ck)) < 0.7
    ends = cs + rng.integers(1, 30, len(ck))
    order = np.lexsort((cs[put], ck[put]))
    bt.update(own[put][order], ck[put][order], cs[put][order],
              ends[put][order], np.ones(put.sum(), np.int64),
              np.ones(put.sum(), np.int64), 0)
    bt.take_due(10)
    home = jtable.cell_hash(ck, cs, capacity)
    for i in rng.choice(len(ck), 12, replace=False):
        window = own[i] * capacity + (home[i] + np.arange(MAX_PROBES)) \
            % capacity
        free = window[~bt._focc[window]]
        if len(free):
            row = rng.choice(free)
            bt._fkey[row], bt._fstart[row] = ck[i], cs[i]
    own = np.where(put, own, rng.integers(0, n_w, len(ck)))
    return bt, own.astype(np.int32), ck, cs


def _jax_lookup(fn, *args, mode):
    jops.use_kernels(mode)
    try:
        return np.asarray(fn(*args))
    finally:
        jops.use_kernels("auto")


class TestTableLookup:
    """The port's probe-window lookups on tables that hold the invariant,
    bit-exact against the JAX package's full-scan Pallas kernel in
    interpret mode, its jnp oracle (ops mode ``ref``) and its own tables'
    probe-window lookup."""

    @pytest.mark.parametrize("seed,capacity", [(0, 37), (1, 45), (2, 37)])
    def test_matches_reference_and_interpret_kernel(self, seed, capacity):
        bt, _, ck, cs = _window_tables(seed, capacity, 3)
        hits = 0
        for w, tab in enumerate(bt._adopted[:2]):
            got = tops.table_lookup(t(ck), t(cs), t(tab.key), t(tab.start),
                                    t(tab.occ), MAX_PROBES).numpy()
            assert got.dtype == np.int32
            args = (ck, cs, tab.key, tab.start, tab.occ)
            np.testing.assert_array_equal(
                got, _jax_lookup(jops.table_lookup, *args, mode="ref"))
            np.testing.assert_array_equal(
                got, _jax_lookup(jops.table_lookup, *args,
                                 mode="interpret"))
            np.testing.assert_array_equal(
                np.where(got == capacity, -1, got), tab.lookup(ck, cs))
            hits += int((got < capacity).sum())
        assert 0 < hits < 2 * len(ck)

    def test_blocked_interpret_kernel_with_padding(self):
        """Cell and row counts that no block size divides."""
        bt, _, ck, cs = _window_tables(7, 37, 2)
        tab = bt._adopted[0]
        cells = jops._split_i64(ck[:23]) + jops._split_i64(cs[:23])
        table = jops._split_i64(tab.key) + jops._split_i64(tab.start)
        want = np.asarray(jht.table_lookup(
            cells, table, tab.occ.astype(np.int32), block_cells=8,
            block_table=16, interpret=True))
        got = tops.table_lookup(t(ck[:23]), t(cs[:23]), t(tab.key),
                                t(tab.start), t(tab.occ), MAX_PROBES)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("seed,capacity", [(3, 37), (4, 45)])
    def test_batched_matches_reference_and_interpret_kernel(self, seed,
                                                            capacity):
        """Hits, misses, windows that wrap their segment's end, cells of the
        shard with no rows and of owners outside the segments (-1, 4: no
        row of theirs, so a miss in both packages); the same (key, start)
        in another shard's rows is not a match."""
        bt, own, ck, cs = _window_tables(seed, capacity, 4)
        own[:2] = -1, 4
        total = bt.total_rows
        got = tops.batched_table_lookup(
            t(own), t(ck), t(cs), t(bt._fkey), t(bt._fstart), t(bt._focc),
            capacity, MAX_PROBES).numpy()
        args = (own, ck, cs, bt.row_owner, bt._fkey, bt._fstart, bt._focc)
        np.testing.assert_array_equal(
            got, _jax_lookup(jops.batched_table_lookup, *args, mode="ref"))
        np.testing.assert_array_equal(
            got, _jax_lookup(jops.batched_table_lookup, *args,
                             mode="interpret"))
        # the JAX table's own lookup indexes by owner: in-range owners only
        np.testing.assert_array_equal(np.where(got == total, -1, got)[2:],
                                      bt.lookup(own[2:], ck[2:], cs[2:]))
        assert (got < total).any() and (got[own == 3] == total).all()
        assert (got[:2] == total).all()
        home = jtable.cell_hash(ck, cs, capacity)
        hit = got < total
        assert ((home + MAX_PROBES > capacity) & hit).any()  # wrapped

    def test_probe_window_contract_off_the_invariant(self):
        """On a table that breaks the invariant the lookup is the probe
        window's, not the full scan's: a live copy outside the window is
        not found, and of two live copies inside it the first in probe
        order wins, here the higher row of a window that wraps the end."""
        cap, probes = 20, 6
        keys = np.arange(-500, 500, dtype=np.int64)
        homes = jtable.cell_hash(keys, np.zeros_like(keys), cap)
        ck = np.array([keys[homes == 3][0], keys[homes == cap - 2][0]])
        cs = np.zeros(2, np.int64)
        tk, ts = np.zeros(cap, np.int64), np.full(cap, -1, np.int64)
        occ = np.zeros(cap, bool)
        tk[3 + probes], ts[3 + probes], occ[3 + probes] = ck[0], 0, True
        # cell 1's window is rows 18, 19, 0, 1, 2, 3: copies at probes 1, 4
        for row in (cap - 1, 2):
            tk[row], ts[row], occ[row] = ck[1], 0, True
        got = tops.table_lookup(t(ck), t(cs), t(tk), t(ts), t(occ),
                                probes).numpy()
        np.testing.assert_array_equal(got, [cap, cap - 1])
        full = _jax_lookup(jops.table_lookup, ck, cs, tk, ts, occ, mode="ref")
        np.testing.assert_array_equal(full, [3 + probes, 2])
        # the batched lookup: the same in shard 1's segment
        got = tops.batched_table_lookup(
            t(np.ones(2, np.int32)), t(ck), t(cs),
            t(np.concatenate([tk, tk])), t(np.concatenate([ts, ts])),
            t(np.concatenate([np.zeros(cap, bool), occ])), cap,
            probes).numpy()
        np.testing.assert_array_equal(got, [2 * cap, 2 * cap - 1])

    def test_empty_cells_and_empty_table(self):
        z = torch.zeros(0, dtype=torch.int64)
        bt, own, ck, cs = _window_tables(0, 37, 2)
        tab = bt._adopted[0]
        assert len(tops.table_lookup(z, z, t(tab.key), t(tab.start),
                                     t(tab.occ), MAX_PROBES)) == 0
        out = tops.table_lookup(t([1, 2]), t([0, 0]), z, z,
                                torch.zeros(0, dtype=torch.bool), MAX_PROBES)
        np.testing.assert_array_equal(out.numpy(), [0, 0])
        out = tops.batched_table_lookup(
            t(np.array([0, 5], np.int32)), t([1, 2]), t([0, 0]), z, z,
            torch.zeros(0, dtype=torch.bool), 37, MAX_PROBES)
        np.testing.assert_array_equal(out.numpy(), [0, 0])

    def test_refuses_what_the_function_does_not_define(self):
        """max_probes outside [1, capacity] and planes that are not whole
        segments raise."""
        bt, own, ck, cs = _window_tables(1, 37, 2)
        planes = (t(bt._fkey), t(bt._fstart), t(bt._focc))
        for bad in (0, 38):
            with pytest.raises(ValueError, match="max_probes"):
                tops.batched_table_lookup(t(own), t(ck), t(cs), *planes, 37,
                                          bad)
        with pytest.raises(ValueError, match="max_probes"):
            tops.table_lookup(t(ck), t(cs), *planes, 75)
        with pytest.raises(ValueError, match="segments"):
            tops.batched_table_lookup(t(own), t(ck), t(cs), *planes, 36,
                                      MAX_PROBES)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class TestDispatch:
    def test_cpu_tensors_take_the_plain_versions(self):
        tops.reset_launch_counts()
        bt, _, ck, cs = _window_tables(0, 37, 2)
        tops.table_lookup(t(ck), t(cs), t(bt._fkey), t(bt._fstart),
                          t(bt._focc), MAX_PROBES)
        tops.segment_sum(t(np.ones((4, 2), np.int32)), t(np.arange(4)), 4)
        tops.scatter_add_(t(np.zeros((4, 2), np.int64)), t(np.arange(4)),
                          t(np.ones((4, 2), np.int64)))
        qkv = torch.ones((1, 2, 3, 64))
        tops.flash_attention(qkv, qkv, qkv)
        tops.decode_attention(qkv[:, :, 0], qkv, qkv, 2)
        tops.decode_attention_partial(qkv[:, :, 0], qkv, qkv, 5, 3)
        tops.ssd_scan(qkv, qkv[..., 0], torch.ones(2), qkv, qkv)
        tops.moe_gather(qkv[0, 0], t(np.arange(4, dtype=np.int32)))
        assert tops.launch_counts() == dict.fromkeys(
            ("segment_sum", "scatter_add", "table_lookup",
             "batched_table_lookup", "flash_attention",
             "flash_attention_backward", "decode_attention",
             "decode_attention_partial", "ssd_scan", "ssd_scan_backward",
             "moe_gather", "moe_gather_backward", "token_rows_table"), 0)
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
                             t(np.zeros(2, bool)), 1)
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
