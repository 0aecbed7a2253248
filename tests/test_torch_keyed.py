"""The port's keyed modules against the JAX package's, on the CPU.

Hashes, cell dedup, the cell reduction and both window tables are fed the
same numpy inputs in both packages; results, placement (every plane, row
for row), placement stats and ``copied_bytes`` must be equal.  The hashes
use unsigned 64-bit arithmetic in the reference; torch has no uint64
remainder on the CPU and a signed ``%`` gives other rows for negative keys,
so the port's tensor hash is pinned against numpy with negative keys.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.keyed import kernels as jkk
from repro.keyed import store as jstore
from repro.keyed import table as jtable
from repro.keyed import windows as jwin
from repro_torch.keyed import kernels as tkk
from repro_torch.keyed import store as tstore
from repro_torch.keyed import table as ttable
from repro_torch.keyed import windows as twin

I64 = np.iinfo(np.int64)
CPU = "cpu"


def t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

class TestHashes:
    @settings(max_examples=40, deadline=None)
    @given(
        st.lists(st.integers(I64.min, I64.max), min_size=1, max_size=40),
        st.lists(st.integers(-(2 ** 40), 2 ** 40), min_size=1, max_size=40),
        st.integers(1, 2 ** 40),
    )
    def test_property_tensor_hashes_equal_numpy(self, keys, starts, modulus):
        n = min(len(keys), len(starts))
        k = np.asarray(keys[:n], np.int64)
        s = np.asarray(starts[:n], np.int64)
        np.testing.assert_array_equal(
            tstore.hash_to_slot(t(k), modulus).numpy(),
            jstore.hash_to_slot(k, modulus).astype(np.int64))
        np.testing.assert_array_equal(
            ttable.cell_hash(t(k), t(s), modulus).numpy(),
            jtable.cell_hash(k, s, modulus))

    def test_signed_remainder_pitfall_pinned(self):
        """key -5, 1000 slots: the unsigned hash gives slot 811; a signed
        int64 remainder of the same product gives 195 (floor) or -805
        (truncating) — the rows a naive port would pick."""
        assert int(jstore.hash_to_slot(-5, 1000)) == 811
        assert int(tstore.hash_to_slot(t([-5]), 1000)[0]) == 811
        product = t([-5]) * tstore.HASH_MULTIPLIER
        assert int(torch.remainder(product, 1000)[0]) == 195
        assert int(torch.fmod(product, 1000)[0]) == -805

    def test_numpy_path_is_the_reference(self):
        keys = np.array([I64.min, -1, 0, 7, I64.max], np.int64)
        np.testing.assert_array_equal(tstore.hash_to_slot(keys, 20),
                                      jstore.hash_to_slot(keys, 20))
        np.testing.assert_array_equal(ttable.cell_hash(keys, keys, 33),
                                      jtable.cell_hash(keys, keys, 33))


# ---------------------------------------------------------------------------
# dedup + reduce
# ---------------------------------------------------------------------------

class TestCellReduction:
    @pytest.mark.parametrize("seed", range(3))
    def test_dedup_cells_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        keys = rng.choice(np.array([I64.min, -3, 0, 5, I64.max]), 80)
        starts = rng.integers(-3, 3, 80) * 11
        j_cells, j_inv = jkk.dedup_cells(keys, starts)
        t_cells, t_inv = tkk.dedup_cells(t(keys), t(starts))
        np.testing.assert_array_equal(t_cells.numpy(), j_cells)
        np.testing.assert_array_equal(t_inv.numpy(), j_inv)

    def test_dedup_cells_empty(self):
        cells, inv = tkk.dedup_cells(t(np.zeros(0, np.int64)),
                                     t(np.zeros(0, np.int64)))
        assert cells.shape == (0, 2) and inv.shape == (0,)

    @pytest.mark.parametrize("impl", ["segment", "masked"])
    def test_reduce_by_cell_matches_reference(self, impl):
        """int32 partials with wraparound, both implementations."""
        rng = np.random.default_rng(11)
        ids = rng.integers(0, 9, 64).astype(np.int32)
        vals = rng.integers(2 ** 30, 2 ** 31 - 1, (64, 2))
        want = np.asarray(jkk.reduce_by_cell(ids, vals, 9, impl=impl))
        got = tkk.reduce_by_cell(t(ids), t(vals), 9, impl=impl).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)

    def test_reduce_by_cell_rejects_unknown_impl(self):
        with pytest.raises(ValueError):
            tkk.reduce_by_cell(t([0]), t([[1]]), 1, impl="dense")

    def test_lexsort_matches_numpy(self):
        rng = np.random.default_rng(5)
        cols = [rng.integers(-3, 3, 50) for _ in range(3)]
        np.testing.assert_array_equal(
            tkk.lexsort([t(c) for c in cols]).numpy(), np.lexsort(cols))


# ---------------------------------------------------------------------------
# tables, fed the same batches in both packages
# ---------------------------------------------------------------------------

def _assert_tables_equal(jt, tt):
    for col in ("key", "start", "end", "value", "count", "touch", "occ"):
        np.testing.assert_array_equal(_np(getattr(tt, col)),
                                      getattr(jt, col), err_msg=col)
    assert vars(tt.stats) == vars(jt.stats)


def _assert_cols_equal(j_out, t_out):
    if j_out is None or t_out is None:
        assert j_out is None and t_out is None
        return
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        np.testing.assert_array_equal(_np(b), a)


def _batch(rng, n, key_pool=12, owners=None):
    """Canonically sorted, duplicate-free cell batch."""
    keys = rng.integers(-key_pool, key_pool, n)
    starts = rng.integers(0, 4, n) * 10
    cells = np.unique(np.stack([keys, starts], 1), axis=0)
    k, s = cells[:, 0], cells[:, 1]
    vals = rng.integers(0, 50, len(k))
    cnts = rng.integers(1, 4, len(k))
    return k, s, s + 10, vals, cnts


class TestDeviceWindowTable:
    @pytest.mark.parametrize("capacity,probes", [(64, 16), (9, 2), (5, 1)])
    def test_update_close_evict_match_reference(self, capacity, probes):
        rng = np.random.default_rng(capacity)
        jt = jtable.DeviceWindowTable(capacity, max_probes=probes)
        tt = ttable.DeviceWindowTable(capacity, max_probes=probes,
                                      device=CPU)
        for step in range(8):
            batch = _batch(rng, 10)
            _assert_cols_equal(jt.update(*batch, touch_ts=step * 3),
                               tt.update(*batch, touch_ts=step * 3))
            _assert_tables_equal(jt, tt)
            if step % 3 == 2:
                _assert_cols_equal(jt.take_due(15), tt.take_due(15))
                _assert_cols_equal(jt.evict_idle(step * 3, 4),
                                   tt.evict_idle(step * 3, 4))
                _assert_tables_equal(jt, tt)
        np.testing.assert_array_equal(_np(tt.rows()), jt.rows())
        assert tt.health() == jt.health()

    def test_lookup_and_insert_rows_match_reference(self):
        rng = np.random.default_rng(2)
        jt = jtable.DeviceWindowTable(16, max_probes=4)
        tt = ttable.DeviceWindowTable(16, max_probes=4, device=CPU)
        k, s, e, v, c = _batch(rng, 14)
        touch = rng.integers(-5, 5, len(k))
        _assert_cols_equal(jt.insert_rows(k, s, e, v, c, touch),
                           tt.insert_rows(k, s, e, v, c, touch))
        _assert_tables_equal(jt, tt)
        np.testing.assert_array_equal(_np(tt.lookup(k, s)), jt.lookup(k, s))
        _assert_cols_equal(jt.extract_slot_rows([0, 3, 7], 10),
                           tt.extract_slot_rows([0, 3, 7], 10))
        _assert_tables_equal(jt, tt)
        np.testing.assert_array_equal(
            _np(tt.owners(np.arange(10) % 3, 10)), jt.owners(np.arange(10) % 3,
                                                             10))


class TestBatchedWindowTable:
    def _pair(self, n_w, capacity=12, probes=3, reserve=0):
        jt = [jtable.DeviceWindowTable(capacity, max_probes=probes)
              for _ in range(n_w)]
        tt = [ttable.DeviceWindowTable(capacity, max_probes=probes,
                                       device=CPU) for _ in range(n_w)]
        return (jtable.BatchedWindowTable(jt, reserve=reserve), jt,
                ttable.BatchedWindowTable(tt, reserve=reserve), tt)

    @staticmethod
    def _owned_batch(rng, n_w):
        k, s, e, v, c = _batch(rng, 16)
        owners = jstore.hash_to_slot(k, n_w).astype(np.int64)
        return owners, k, s, e, v, c

    def _check(self, jb, tb, jts, tts):
        for jt, tt in zip(jts, tts):
            _assert_tables_equal(jt, tt)
        np.testing.assert_array_equal(_np(tb.row_owner), jb.row_owner)
        assert tb.copied_bytes == jb.copied_bytes
        assert tb.per_shard_health() == jb.per_shard_health()
        np.testing.assert_array_equal(_np(tb.per_shard_occupancy()),
                                      jb.per_shard_occupancy())

    def test_update_close_evict_match_reference(self):
        rng = np.random.default_rng(4)
        jb, jts, tb, tts = self._pair(3)
        for step in range(6):
            batch = self._owned_batch(rng, 3)
            _assert_cols_equal(jb.update(*batch, touch_ts=step),
                               tb.update(*batch, touch_ts=step))
            self._check(jb, tb, jts, tts)
            _assert_cols_equal(jb.open_rows(), tb.open_rows())
            if step % 2:
                _assert_cols_equal(jb.take_due(20), tb.take_due(20))
                _assert_cols_equal(jb.evict_idle(step, 2),
                                   tb.evict_idle(step, 2))
                self._check(jb, tb, jts, tts)

    def test_restack_grow_shrink_and_realloc_match_reference(self):
        """In-place grow/shrink copies zero slab bytes; a grow beyond the
        allocation and a foreign non-empty table are charged exactly as the
        reference charges them."""
        rng = np.random.default_rng(6)
        jb, jts, tb, tts = self._pair(2, reserve=3)
        batch = self._owned_batch(rng, 2)
        jb.update(*batch, touch_ts=1)
        tb.update(*batch, touch_ts=1)
        for n_new in (3, 2, 5):
            jts = jts[:n_new] + [jtable.DeviceWindowTable(12, max_probes=3)
                                 for _ in range(n_new - len(jts))]
            tts = tts[:n_new] + [ttable.DeviceWindowTable(12, max_probes=3,
                                                          device=CPU)
                                 for _ in range(n_new - len(tts))]
            jb.restack(jts)
            tb.restack(tts)
            self._check(jb, tb, jts, tts)
            batch = self._owned_batch(rng, n_new)
            jb.update(*batch, touch_ts=2)
            tb.update(*batch, touch_ts=2)
            self._check(jb, tb, jts, tts)
        assert tb.copied_bytes > 0  # the realloc to 5 shards
        # a foreign non-empty table replacing shard 1 is copied in
        jf = jtable.DeviceWindowTable(12, max_probes=3)
        tf = ttable.DeviceWindowTable(12, max_probes=3, device=CPU)
        b = _batch(rng, 5)
        jf.update(*b, touch_ts=0)
        tf.update(*b, touch_ts=0)
        jb.restack([jts[0], jf])
        tb.restack([tts[0], tf])
        self._check(jb, tb, [jts[0], jf], [tts[0], tf])

    def test_shard_tables_are_views_of_the_planes(self):
        _, _, tb, tts = self._pair(2)
        assert tts[1].key.data_ptr() == tb.key[1].data_ptr()
        assert tts[1].vc.data_ptr() == tb.vc[1].data_ptr()
        tts[1].occ[3] = True
        assert bool(tb._focc[12 + 3])


# ---------------------------------------------------------------------------
# engine pieces
# ---------------------------------------------------------------------------

class TestEnginePieces:
    def test_expand_panes_matches_reference(self):
        rng = np.random.default_rng(8)
        n = 40
        keys, vals = rng.integers(-9, 9, n), rng.integers(0, 9, n)
        ts = np.arange(n) + rng.integers(-6, 7, n)
        pos = np.arange(n)
        for j_spec, t_spec in (
            (jwin.WindowSpec("sliding", size=9, slide=4),
             twin.WindowSpec("sliding", size=9, slide=4)),
            (jwin.WindowSpec("tumbling", size=5),
             twin.WindowSpec("tumbling", size=5)),
        ):
            want = jwin.expand_panes(j_spec, keys, vals, ts, pos)
            got = twin.expand_panes(t_spec, t(keys), t(vals), t(ts), t(pos))
            _assert_cols_equal(want, got)

    @pytest.mark.parametrize("backend,kw", [
        ("host", {}),
        ("device_table", dict(capacity=8, max_probes=2, ttl=2)),
    ])
    def test_engine_chunks_snapshot_and_migration(self, backend, kw):
        from repro.keyed import synthetic_keyed_items

        items = synthetic_keyed_items(96, num_keys=9, disorder=5, seed=3)
        specs = (jwin.WindowSpec("sliding", size=9, slide=4, lateness=2,
                                 late_policy="side", early_every=2),
                 twin.WindowSpec("sliding", size=9, slide=4, lateness=2,
                                 late_policy="side", early_every=2))
        je = jwin.KeyedWindowEngine(specs[0], num_slots=10, backend=backend,
                                    **kw)
        te = twin.KeyedWindowEngine(specs[1], num_slots=10, backend=backend,
                                    device=CPU, **kw)
        for i in range(0, 96, 16):
            a = je.process_chunk(items[i: i + 16])
            b = te.process_chunk(items[i: i + 16])
            for ch in a:
                for k in a[ch]:
                    np.testing.assert_array_equal(b[ch][k], a[ch][k])
                    assert b[ch][k].dtype == a[ch][k].dtype
        js, ts_ = je.snapshot(), te.snapshot()
        assert set(js) == set(ts_)
        for k in js:
            np.testing.assert_array_equal(ts_[k], js[k], err_msg=k)
        _assert_cols_equal(je.extract_rows([1, 4]), te.extract_rows([1, 4]))
        rows = je.extract_rows([2])
        te.extract_rows([2])
        je.ingest_rows(*rows)
        te.ingest_rows(*rows)
        restored = twin.KeyedWindowEngine.restore(
            specs[1], je.snapshot(), backend=backend, device=CPU, **kw)
        want, got, again = je.snapshot(), te.snapshot(), restored.snapshot()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            np.testing.assert_array_equal(again[k], v, err_msg=k)
        want, got = je.flush(), te.flush()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


class TestStore:
    def test_slotmap_fold_and_relocation_match_reference(self):
        for n_old, n_new in ((3, 7), (8, 5), (4, 4)):
            js, jm = jstore.SlotMap(20, n_old).rebalance(n_new)
            ts_, tm = tstore.SlotMap(20, n_old).rebalance(n_new)
            np.testing.assert_array_equal(ts_.table, js.table)
            np.testing.assert_array_equal(tm, jm)
            items = np.arange(n_old) * 7 + 3
            np.testing.assert_array_equal(
                tstore.fold_worker_items(items, jstore.SlotMap(20, n_old).table,
                                         js.table, n_new),
                jstore.fold_worker_items(items, jstore.SlotMap(20, n_old).table,
                                         js.table, n_new))
        sessions = {0: -4, 3: 11, 5: 2 ** 40, 9: 7}
        for policy in ("hash", "ondemand"):
            assert tstore.plan_relocation(sessions, 6, policy=policy) == \
                jstore.plan_relocation(sessions, 6, policy=policy)
