"""The port's multi-process keyed plane against the JAX package, on the CPU.

``repro_torch.dist.DistributedKeyedPlane`` runs its engine shards in
spawned worker processes (``device="cpu"`` here; the card tests run them on
the GPU).  After ``tests/test_dist.py``, each run is held bit-exact against
all four of: the JAX package's in-process ``KeyedWindowAdapter`` on the
same stream and degree schedule, the port's in-process adapter, the serial
oracle ``repro.core.semantics.keyed_windows``, and the JAX plane's barrier
snapshot.  Covered: grow and shrink at degrees that do not divide the slot
count over the pipe and the rings (with shard-host multiplexing and the
executor's scatter-ahead overlap), the overlap engaging, a killed worker
recovered through the port's ``Supervisor`` (pipe, and rings with a warm
spare), and the autoscaler moving the process count.  Plus the device rule
in the workers (a worker told to use an absent card fails, never runs on
the CPU), the ``fork`` guard, and the workers' launch counts.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import semantics
from repro.keyed import KeyedWindowAdapter as JAdapter
from repro.keyed import WindowSpec as JSpec
from repro.keyed import synthetic_keyed_items
from repro.runtime import StreamExecutor as JExecutor
from repro_torch.dist import DistributedKeyedPlane
from repro_torch.dist.plane import _HostHandle, check_start_method
from repro_torch.keyed import KeyedWindowAdapter as TAdapter
from repro_torch.keyed import WindowSpec as TSpec
from repro_torch.keyed.runtime import ROW_BYTES
from repro_torch.obs import Tracer
from repro_torch.runtime import (
    Autoscaler,
    BoundedSource,
    QueueDepthPolicy,
    StreamExecutor,
    Supervisor,
    WorkerFailure,
)

NUM_SLOTS = 20  # degrees 3, 6, 7 do not divide this
CHUNK = 16
ROW_COLS = ("w_key", "w_start", "w_end", "w_value", "w_count", "w_resident",
            "w_touch")
SCALARS = ("wm", "wm_valid", "wm_ticks", "max_ts", "max_ts_valid",
           "late_count")


def _chunks(items):
    return [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]


def _rows(d, cols=("key", "start", "end", "value", "count")):
    return [tuple(int(x) for x in r) for r in zip(*(d[k] for k in cols))]


def _inprocess(pkg, spec_kw, items, degree, schedule=None, **kw):
    """The in-process plane of either package over the same stream and
    schedule; returns (outputs, barrier snapshot)."""
    kw.setdefault("num_slots", NUM_SLOTS)
    if pkg == "jax":
        ex = JExecutor(JAdapter(JSpec(**spec_kw), **kw),
                       degree=degree, chunk_size=CHUNK)
    else:
        ex = StreamExecutor(TAdapter(TSpec(**spec_kw), device="cpu", **kw),
                            degree=degree, chunk_size=CHUNK)
    outs = ex.run(_chunks(items), schedule=schedule)
    return outs, ex.snapshot_barrier()


def _plane(spec_kw, tmp_path, **kw):
    kw.setdefault("num_slots", NUM_SLOTS)
    return DistributedKeyedPlane(TSpec(**spec_kw), device="cpu",
                                 blackbox_dir=str(tmp_path / "bb"), **kw)


def _assert_outputs_equal(outs, ref_outs):
    assert len(outs) == len(ref_outs)
    for i, (o, r) in enumerate(zip(outs, ref_outs)):
        for ch in ("emissions", "early", "late"):
            assert set(o[ch]) == set(r[ch]), (i, ch)
            for k in r[ch]:
                assert o[ch][k].dtype == r[ch][k].dtype, (i, ch, k)
                np.testing.assert_array_equal(o[ch][k], r[ch][k],
                                              err_msg=f"chunk {i} {ch}/{k}")


def _assert_state_equal(state, ref, keys=None):
    """``keys=None``: the whole snapshot, else those entries."""
    if keys is None:
        assert set(state) == set(ref)
        keys = list(ref)
    for k in keys:
        assert np.asarray(state[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(state[k], ref[k], err_msg=k)


def _assert_oracle(spec_kw, items, outs, state):
    em, open_, late, *early = semantics.keyed_windows(
        spec_kw["kind"],
        [(int(r["key"]), int(r["value"]), int(r["ts"])) for r in items],
        **JSpec(**spec_kw).oracle_kwargs(CHUNK),
    )
    assert [r for o in outs for r in _rows(o["emissions"])] == em
    assert [r for o in outs for r in _rows(
        o["late"], ("key", "value", "ts", "start"))] == late
    if early:
        assert [r for o in outs for r in _rows(o["early"])] == early[0]
    assert _rows(state, ROW_COLS[:5]) == [tuple(t) for t in open_]


def _assert_four_way(spec_kw, items, outs, state, degree, schedule=None,
                     keys=None, **kw):
    """The dist run against the JAX package's in-process plane (outputs
    and barrier snapshot), the port's, and the serial oracle."""
    for pkg in ("jax", "torch"):
        ref_outs, ref_state = _inprocess(pkg, spec_kw, items, degree,
                                         schedule, **kw)
        _assert_outputs_equal(outs, ref_outs)
        _assert_state_equal(state, ref_state, keys)
    _assert_oracle(spec_kw, items, outs, state)


# ---------------------------------------------------------------------------
# the process-boundary plane, four ways
# ---------------------------------------------------------------------------

class TestDistributedPlaneBitExact:
    @pytest.mark.parametrize(
        "transport,spk,overlap",
        [("pipe", 2, False), ("pipe", 2, True), ("shm", 1, True),
         ("shm", 2, True)],
        ids=["pipe-mux2", "pipe-mux2-overlap", "shm-overlap",
             "shm-mux2-overlap"],
    )
    def test_grow_shrink_nondivisor_degrees_bit_exact(
        self, tmp_path, transport, spk, overlap
    ):
        """Grow 2 -> 3 -> 7 and shrink 7 -> 2 at degrees that do not divide
        20 slots: every chunk's emissions, early firings and late records,
        the final state and the barrier snapshot equal the JAX package's
        in-process plane, the port's and the oracle; migration rows and
        slots equal the in-process plane's, and the bytes are wire bytes."""
        spec_kw = dict(kind="tumbling", size=8, lateness=3,
                       late_policy="side", early_every=2)
        items = synthetic_keyed_items(10 * CHUNK + 9, num_keys=12,
                                      disorder=4, seed=7)
        schedule = {2: 3, 5: 7, 8: 2}
        table = dict(backend="device_table", capacity=64)
        ad = _plane(spec_kw, tmp_path, prespawn=7, transport=transport,
                    shards_per_host=spk, **table)
        try:
            ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK,
                                pipeline=overlap)
            outs = ex.run(_chunks(items), schedule=schedule)
            snap = ex.snapshot_barrier()
            _assert_four_way(spec_kw, items, outs, snap, 2, schedule,
                             **table)
            ref = StreamExecutor(TAdapter(TSpec(**spec_kw),
                                          num_slots=NUM_SLOTS, device="cpu",
                                          **table),
                                 degree=2, chunk_size=CHUNK)
            ref.run(_chunks(items), schedule=schedule)
            vol_ref = ref.metrics.migration_volume()
            vol = ex.metrics.migration_volume()
            assert vol["rows"] == vol_ref["rows"] > 0
            assert vol["slots"] == vol_ref["slots"]
            payload = vol["rows"] * ROW_BYTES
            assert payload <= vol["bytes"] <= \
                payload + vol["handoffs"] * 7 * 512
            assert ad.wire_bytes["migration"] == vol["bytes"]
            assert ad.wire_bytes["step"] > 0 and ad.wire_bytes["piped"] > 0
            if transport == "shm":
                assert ad.wire_bytes["shm"] > 0
            else:
                assert ad.wire_bytes["shm"] == 0
            assert not any(ad.fault_events.values())
        finally:
            ad.close()

    def test_overlap_actually_engages(self, tmp_path):
        """With ``pipeline=True`` and full chunks, every chunk after the
        first is scattered ahead (the port's executor calls ``step_ahead``),
        and the outputs equal the synchronous run's and the references'.
        The workers' ``shard_step`` spans land on the coordinator's
        tracer, each with its launch counts (none on the CPU)."""
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        items = synthetic_keyed_items(CHUNK * 6, num_keys=8, disorder=3,
                                      seed=5)

        def run(pipeline, counter=None, tracer=None):
            ad = _plane(spec_kw, tmp_path, prespawn=2, transport="shm",
                        shards_per_host=2)
            try:
                if counter is not None:
                    inner = ad.step_ahead

                    def counting(chunk, prepared=None):
                        ok = inner(chunk, prepared=prepared)
                        counter.append(ok)
                        return ok

                    ad.step_ahead = counting
                ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK,
                                    pipeline=pipeline, tracer=tracer)
                outs = ex.run(_chunks(items))
                return outs, ex.state, dict(ad.kernel_launches)
            finally:
                ad.close()

        ref_outs, ref_state, _ = run(False)
        hits = []
        tracer = Tracer(recorder=None)
        outs, state, launches = run(True, counter=hits, tracer=tracer)
        assert len(hits) == 5 and all(hits)  # chunks 1..5 scattered ahead
        _assert_outputs_equal(outs, ref_outs)
        _assert_state_equal(state, ref_state)
        _assert_four_way(spec_kw, items, outs, state, 2)
        steps = [s for s in tracer.spans if s.name == "shard_step"]
        assert len(steps) == 2 * 6
        assert {s.tid for s in steps} == {
            t for t, n in tracer.track_names.items() if n.startswith("shard")}
        assert all(s.args["launches"] == {} for s in steps)
        assert launches == {}

    def test_worker_launch_counts_are_summed(self):
        """The coordinator sums the launch counts its workers ship on their
        ``shard_step`` spans (what chip runs read as the dist path's
        launches); other spans carry none."""
        ad = DistributedKeyedPlane(TSpec("tumbling", size=8), num_slots=4,
                                   device="cpu")
        try:
            h = _HostHandle(0, None, None, None, None)
            ad._replay_spans(h, 0, [
                ["shard_step", 0.0, 1.0, {"launches": {"segment_sum": 1,
                                                       "scatter_add": 1}}],
                ["shard_step", 1.0, 2.0, {"launches": {"segment_sum": 1,
                                                       "table_lookup": 3}}],
                ["shard_snapshot", 2.0, 3.0, {"shard": 0}],
                ["shard_step", 3.0, 4.0, None],
            ])
            assert ad.kernel_launches == {"segment_sum": 2,
                                          "scatter_add": 1,
                                          "table_lookup": 3}
        finally:
            ad.close()


# ---------------------------------------------------------------------------
# real worker-process death -> supervisor recovery from canonical snapshot
# ---------------------------------------------------------------------------

class TestKilledWorkerRecovery:
    @pytest.mark.parametrize("transport,spares", [("pipe", 0), ("shm", 1)],
                             ids=["pipe", "shm-spare"])
    def test_killed_worker_recovers_through_supervisor(
        self, tmp_path, transport, spares
    ):
        """A CRASH frame makes shard 1's host dump its flight recorder and
        exit mid-stream; the port's Supervisor restores from the canonical
        snapshot, the pool refills the hole (a promoted warm spare when
        ``spares=1``), and the replayed stream equals the references: every
        chunk's outputs, and the final rows and clock."""
        spec_kw = dict(kind="tumbling", size=30, lateness=5,
                       late_policy="side", early_every=2)
        nch = 6
        items = synthetic_keyed_items(CHUNK * nch, num_keys=7, disorder=5,
                                      seed=3)
        src = BoundedSource(items)
        table = dict(backend="device_table", capacity=8, max_probes=2, ttl=4)
        ad = _plane(spec_kw, tmp_path, prespawn=3, transport=transport,
                    spares=spares, shards_per_host=2, num_slots=10, **table)
        try:
            ex = StreamExecutor(ad, degree=3, chunk_size=CHUNK)
            killed = {"done": False}

            def chunk_fn(i):
                if i == 3 and not killed["done"]:
                    killed["done"] = True
                    ad.kill_worker(1)  # real process death, mid-stream
                src.seek(i * CHUNK)
                return src.take(CHUNK)

            sup = Supervisor(ex, chunk_fn, num_chunks=nch,
                             ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
            outs = sup.run()
            ordered = [outs[i] for i in range(nch)]
            _assert_recovered(spec_kw, items, ordered, ex.state,
                              num_slots=10, **table)
            kinds = [e.kind for e in sup.events]
            assert {"failure", "restore", "shrink", "grow"} <= set(kinds)
            assert ad.fault_events["death_dead"] == 1
            assert ad.fault_events["recoveries"] == len(ad.mttr_s) >= 1
            assert ad.collected_blackboxes
            with open(ad.collected_blackboxes[0]) as f:
                box = json.load(f)
            assert any(e.get("name") == "worker_error"
                       for e in box["traceEvents"])
            if spares:
                assert len(ad._spares) == spares
                assert all(h is not None for h in ad._pool)
        finally:
            ad.close()


def _assert_recovered(spec_kw, items, outs, state, num_slots=NUM_SLOTS,
                      **kw):
    """A supervised run (its degree history differs from an unfailed
    run's) against the references: every chunk's outputs, the final rows
    and the watermark clock."""
    for pkg in ("jax", "torch"):
        ref_outs, ref_state = _inprocess(pkg, spec_kw, items, 3,
                                         num_slots=num_slots, **kw)
        _assert_outputs_equal(outs, ref_outs)
        _assert_state_equal(state, ref_state, keys=ROW_COLS[:5] + SCALARS)
    _assert_oracle(spec_kw, items, outs, state)


# ---------------------------------------------------------------------------
# the autoscaler chooses the *process* count
# ---------------------------------------------------------------------------

class TestAutoscalerOverProcesses:
    def test_autoscaler_scales_worker_processes(self, tmp_path):
        """The QueueDepthPolicy drives ``set_degree`` on the distributed
        plane: a deep queue grows the worker processes (2 -> 3), a drained
        queue shrinks them (3 -> 2); the run equals the references run
        with the same degree changes as a schedule."""
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        items = synthetic_keyed_items(CHUNK * 6, num_keys=8, disorder=3,
                                      seed=11)
        ad = _plane(spec_kw, tmp_path, backend="host", prespawn=4,
                    transport="pipe")
        try:
            ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK)
            sc = Autoscaler(QueueDepthPolicy(), [2, 3, 4], cooldown_chunks=0)

            class _Q:
                high_watermark, low_watermark = 8, 1
                depth = 0

            outs = []
            procs = []
            for i, c in enumerate(_chunks(items)):
                outs.append(ex.process(c))
                if i == 1:
                    _Q.depth = 99                      # pressure: scale up
                    d = sc.maybe_scale(ex, queue=_Q())
                    assert d is not None and d.applied
                    assert ad._active == 3
                    procs.append(sum(h is not None for h in ad._pool))
                if i == 3:
                    _Q.depth = 0                       # drained: scale down
                    d = sc.maybe_scale(ex, queue=_Q())
                    assert d is not None and d.applied
                    assert ad._active == 2
                    assert d.handoff_bytes >= d.handoff_rows * ROW_BYTES
            assert procs == [4]  # the prespawned pool served the grow
            _assert_four_way(spec_kw, items, outs, ex.snapshot_barrier(), 2,
                             {2: 3, 4: 2}, backend="host")
        finally:
            ad.close()


# ---------------------------------------------------------------------------
# the device rule across the process boundary
# ---------------------------------------------------------------------------

class TestNoCpuFallback:
    def test_worker_told_cuda_without_a_card_fails(self, tmp_path):
        """A worker whose engines are to live on the card, on a host with
        no card, raises at its first ATTACH, dumps its black box and dies:
        the coordinator surfaces ``WorkerFailure`` and no chunk is ever
        processed on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("needs a host without a CUDA card")
        spec_kw = dict(kind="tumbling", size=8, lateness=3)
        items = synthetic_keyed_items(CHUNK * 2, num_keys=6, seed=1)
        ad = _plane(spec_kw, tmp_path, backend="device_table", prespawn=1,
                    transport="pipe")
        try:
            ex = StreamExecutor(ad, degree=1, chunk_size=CHUNK)
            ad.device = torch.device("cuda")  # what the workers are told
            with pytest.raises(WorkerFailure) as ei:
                ex.process(_chunks(items)[0])
            assert ei.value.cause == "dead"
            assert "CUDA is unavailable" in str(ei.value)
            assert ad.fault_events["death_dead"] == 1
            assert ad.wire_bytes["step"] == 0  # no STEP ever left
            assert ad.kernel_launches == {}
            with open(ad.collected_blackboxes[0]) as f:
                box = json.load(f)
            assert any(e.get("name") == "worker_error" and "CUDA" in
                       e["args"]["error"] for e in box["traceEvents"])
        finally:
            ad.close()

    def test_fork_refused_for_a_cuda_device(self):
        with pytest.raises(ValueError, match="fork"):
            check_start_method("fork", torch.device("cuda"))
        with pytest.raises(ValueError, match="fork"):
            check_start_method("fork", "cuda:0")
        check_start_method("spawn", "cuda")
        check_start_method("fork", "cpu")
        ad = DistributedKeyedPlane(TSpec("tumbling", size=8), num_slots=4,
                                   start_method="fork", device="cpu")
        ad.close()

    def test_engine_device_crosses_as_a_string(self):
        ad = DistributedKeyedPlane(TSpec("tumbling", size=8), num_slots=4,
                                   backend="device_table", device="cpu")
        try:
            kw = ad._engine_kwargs()
            assert kw["device"] == "cpu" and kw["backend"] == "device_table"
            assert ad.transport == os.environ.get("REPRO_DIST_TRANSPORT",
                                                  "shm")
        finally:
            ad.close()
