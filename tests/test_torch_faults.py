"""Chaos tests for the port's distributed keyed plane, on the CPU.

After ``tests/test_faults.py``: under a seeded ``FaultPlan`` storm (a hung
worker, a crash, corrupt / truncated / dropped / delayed frames both ways,
a corrupted ring span) and the port's ``Supervisor``, every fault is
detected and recovered and the stream stays bit-exact against the JAX
package's in-process plane, the port's and the serial oracle; each
transport fault family leaves its fingerprint; a hung worker is caught
within ``deadline + probe``; a CRC-off peer interoperates; a dropped INGEST
acknowledgment is served from the reply cache (exactly once); replayed
INGEST / APPLY epochs are fenced; a crash in the middle of a migration
recovers with its accounting intact; a SIGKILLed coordinator leaves no
worker process and no ring behind; and spawn failure degrades capacity.
Workers run with ``device="cpu"``.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro.core import semantics
from repro.keyed import KeyedWindowAdapter as JAdapter
from repro.keyed import WindowSpec as JSpec
from repro.keyed import synthetic_keyed_items
from repro.runtime import StreamExecutor as JExecutor
from repro_torch.dist import DistributedKeyedPlane, shardhost, wire
from repro_torch.dist.faults import Fault, FaultPlan
from repro_torch.dist.plane import Deadlines
from repro_torch.keyed import KeyedWindowAdapter as TAdapter
from repro_torch.keyed import WindowSpec as TSpec
from repro_torch.keyed.runtime import ROW_BYTES
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime import (
    Autoscaler,
    BoundedSource,
    FailurePlan,
    QueueDepthPolicy,
    StreamExecutor,
    Supervisor,
    WorkerFailure,
)

NUM_SLOTS = 20
CHUNK = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chunks(items):
    return [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]


def _rows(d, cols=("key", "start", "end", "value", "count")):
    return [tuple(int(x) for x in r) for r in zip(*(d[k] for k in cols))]


def _plane(spec_kw, tmp_path, **kw):
    return DistributedKeyedPlane(TSpec(**spec_kw), num_slots=NUM_SLOTS,
                                 device="cpu",
                                 blackbox_dir=str(tmp_path / "bb"), **kw)


def _tight(**kw):
    """Deadlines that drive the probe/kill automaton in seconds."""
    base = dict(step=2.5, snapshot=30.0, migrate=30.0, health=15.0,
                default=30.0, attach=60.0, probe=1.0, retry_base=0.01)
    base.update(kw)
    return Deadlines(**base)


def _assert_references(spec_kw, items, outs, state, **kw):
    """Every chunk's outputs against the JAX package's and the port's
    in-process planes (an unfailed run at degree 3), and outputs plus
    final rows against the serial oracle."""
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            ex = JExecutor(JAdapter(JSpec(**spec_kw), num_slots=NUM_SLOTS,
                                    **kw), degree=3, chunk_size=CHUNK)
        else:
            ex = StreamExecutor(TAdapter(TSpec(**spec_kw),
                                         num_slots=NUM_SLOTS, device="cpu",
                                         **kw), degree=3, chunk_size=CHUNK)
        ref_outs = ex.run(_chunks(items))
        assert len(outs) == len(ref_outs)
        for o, r in zip(outs, ref_outs):
            for ch in ("emissions", "early", "late"):
                for k in r[ch]:
                    np.testing.assert_array_equal(o[ch][k], r[ch][k])
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
    assert _rows(state, ("w_key", "w_start", "w_end", "w_value",
                         "w_count")) == [tuple(t) for t in open_]


def _supervised(ad, items, nch, tmp_path, **kw):
    src = BoundedSource(items)
    ex = StreamExecutor(ad, degree=3, chunk_size=CHUNK)

    def chunk_fn(i):
        src.seek(i * CHUNK)
        return src.take(CHUNK)

    sup = Supervisor(ex, chunk_fn, num_chunks=nch,
                     ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2, **kw)
    outs = sup.run()
    return [outs[i] for i in range(nch)], ex, sup


# ---------------------------------------------------------------------------
# the seeded storm: every failure domain at once, bit-exact recovery
# ---------------------------------------------------------------------------

class TestFaultStorm:
    def test_storm_recovers_bit_exact(self, tmp_path):
        """A seeded storm on the ring transport against the port's
        Supervisor: both kills detected and attributed, every transport
        fault retried transparently, the replay equal to the references;
        MTTR recorded per recovery."""
        spec_kw = dict(kind="tumbling", size=24, lateness=5,
                       late_policy="side", early_every=2)
        nch = 10
        items = synthetic_keyed_items(CHUNK * nch, num_keys=9, disorder=5,
                                      seed=13)
        plan = FaultPlan.storm(seed=4, n_shards=3, n_chunks=nch,
                               include_shm=True)
        table = dict(backend="device_table", capacity=16, max_probes=2,
                     ttl=6)
        ad = _plane(spec_kw, tmp_path, prespawn=3, transport="shm",
                    faults=plan, deadlines=_tight(), **table)
        try:
            outs, ex, sup = _supervised(ad, items, nch, tmp_path)
            _assert_references(spec_kw, items, outs, ex.state, **table)
            fired = plan.kinds_fired()
            assert fired.get("worker:hang") == 1
            assert fired.get("worker:crash") == 1
            ev = ad.fault_events
            assert ev["death_hung"] == 1 and ev["death_dead"] == 1
            assert ev["probes"] >= 1 and ev["injected_send"] >= 1
            assert ev["recoveries"] == len(ad.mttr_s) >= 1
            assert all(m > 0 for m in ad.mttr_s)
            kinds = [e.kind for e in sup.events]
            assert {"failure", "restore", "shrink", "grow"} <= set(kinds)
            assert ad.collected_blackboxes
        finally:
            ad.close()

    def test_every_transport_fault_family_is_transparent(self, tmp_path):
        """One fault of each recoverable family and no kill: no
        ``WorkerFailure``, outputs equal to the references, and each family
        leaves its fingerprint on the counters ``export_health`` exports."""
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        nch = 8
        items = synthetic_keyed_items(CHUNK * nch, num_keys=8, disorder=4,
                                      seed=21)
        plan = FaultPlan([
            Fault("send", "STEP", "corrupt", nth=2, shard=0, seed=12345),
            Fault("send", "STEP", "truncate", nth=3, shard=1, seed=777),
            Fault("send", "STEP", "drop", nth=4, shard=2),
            Fault("send", "STEP", "delay", nth=2, shard=1, seconds=0.02),
            Fault("reply", "STEP", "corrupt", nth=5, shard=0, seed=99),
            Fault("reply", "STEP", "drop", nth=5, shard=1),
            Fault("reply", "STEP", "delay", nth=3, shard=2, seconds=0.02),
            Fault("shm", "STEP", "corrupt", nth=2, shard=0),
        ])
        ad = _plane(spec_kw, tmp_path, backend="host", prespawn=3,
                    transport="shm", faults=plan, deadlines=_tight())
        try:
            ex = StreamExecutor(ad, degree=3, chunk_size=CHUNK)
            outs = ex.run(_chunks(items))
            _assert_references(spec_kw, items, outs, ex.state,
                               backend="host")
            assert plan.kinds_fired() == {
                "send:corrupt": 1, "send:truncate": 1,
                "send:drop": 1, "send:delay": 1,
            }
            ev = ad.fault_events
            assert ev["injected_send"] == 4
            assert ev["nacks"] >= 2 and ev["crc_errors"] >= 2
            assert ev["probes"] >= 2 and ev["probes_answered"] >= 2
            assert ev["retransmits"] >= 4
            assert sum(v for k, v in ev.items()
                       if k.startswith("death_")) == 0
            assert all(h.chan.crc for h in ad._pool if h is not None)
            reg = MetricsRegistry()
            ad.export_health(reg)
            assert reg.counter("dist.fault.injected_send").value == 4
            assert reg.counter("dist.fault.crc_errors").value == \
                ev["crc_errors"]
            assert reg.gauge("keyed.plane.n_shards").value == 3
        finally:
            ad.close()


# ---------------------------------------------------------------------------
# detection bounds, CRC interop, exactly-once
# ---------------------------------------------------------------------------

class TestDetectionAndInterop:
    def test_hung_worker_detected_within_deadline_plus_probe(self, tmp_path):
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        items = synthetic_keyed_items(CHUNK * 3, num_keys=6, disorder=3,
                                      seed=2)
        dl = _tight(step=1.5, probe=0.5)
        plan = FaultPlan([Fault("worker", "STEP", "hang", nth=2, shard=1)])
        ad = _plane(spec_kw, tmp_path, backend="host", prespawn=2,
                    transport="pipe", faults=plan, deadlines=dl)
        try:
            ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK)
            chunks = _chunks(items)
            ex.process(chunks[0])
            t0 = time.monotonic()
            with pytest.raises(WorkerFailure) as ei:
                ex.process(chunks[1])
            elapsed = time.monotonic() - t0
            assert ei.value.cause == "hung"
            assert dl.step * 0.9 <= elapsed <= dl.step + dl.probe + 2.5
            assert ad.fault_events["death_hung"] == 1
        finally:
            ad.close()

    def test_crc_off_peer_interoperates_bit_exact(self, tmp_path):
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        items = synthetic_keyed_items(CHUNK * 4, num_keys=7, disorder=3,
                                      seed=9)
        ad = _plane(spec_kw, tmp_path, backend="host", prespawn=2,
                    transport="pipe", worker_crc=False)
        try:
            ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK)
            outs = ex.run(_chunks(items))
            assert all(not h.chan.crc for h in ad._pool if h is not None)
            assert ad.fault_events["crc_errors"] == 0
            _assert_references(spec_kw, items, outs, ex.state,
                               backend="host")
        finally:
            ad.close()

    def test_dropped_ingest_reply_served_from_cache(self, tmp_path):
        """A dropped INGEST acknowledgment forces probe + retransmit; the
        worker answers from its reply cache without ingesting twice."""
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        items = synthetic_keyed_items(CHUNK * 5, num_keys=8, disorder=3,
                                      seed=17)
        plan = FaultPlan([Fault("reply", "INGEST", "drop", nth=1)])
        ad = _plane(spec_kw, tmp_path, backend="host", prespawn=3,
                    transport="shm", faults=plan,
                    deadlines=_tight(migrate=2.0, probe=0.5))
        try:
            ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK)
            outs = ex.run(_chunks(items), schedule={2: 3})
            assert ad.fault_events["probes_answered"] >= 1
            assert ad.fault_events["retransmits"] >= 1
            _assert_references(spec_kw, items, outs, ex.state,
                               backend="host")
        finally:
            ad.close()

    def test_ingest_apply_epoch_fence(self):
        spec = TSpec("tumbling", size=8, lateness=3, late_policy="side")
        host = shardhost._Host(None, {
            "spec": dataclasses.asdict(spec), "engine_kwargs": {},
        })
        assert not host.fenced(wire.INGEST, {"shard": 1, "epoch": 4})
        assert host.fenced(wire.INGEST, {"shard": 1, "epoch": 4})  # replay
        assert not host.fenced(wire.APPLY, {"shard": 1, "epoch": 4})
        assert not host.fenced(wire.INGEST, {"shard": 2, "epoch": 4})
        assert not host.fenced(wire.INGEST, {"shard": 1, "epoch": 5})
        assert not host.fenced(wire.INGEST, {"shard": 1})
        assert not host.fenced(wire.INGEST, {"shard": 1})
        for e in range(shardhost.FENCE_CACHE + 1):
            host.fenced(wire.INGEST, {"shard": 0, "epoch": 1000 + e})
        assert not host.fenced(wire.INGEST, {"shard": 1, "epoch": 4})


# ---------------------------------------------------------------------------
# mid-resize partial failure
# ---------------------------------------------------------------------------

class TestMidResizeFailure:
    @pytest.mark.parametrize(
        "transport,op", [("pipe", "EXTRACT"), ("shm", "INGEST")],
        ids=["pipe-donor-extract", "shm-recipient-ingest"],
    )
    def test_crash_mid_migration_recovers_bit_exact(self, tmp_path,
                                                    transport, op):
        """A donor dying on EXTRACT or a recipient on INGEST in the middle
        of the recovery grow 1 -> 3: the Supervisor rolls back, the replay
        equals the references, and only completed resizes are metered."""
        spec_kw = dict(kind="tumbling", size=60, lateness=5,
                       late_policy="side", early_every=2)
        nch = 6
        items = synthetic_keyed_items(CHUNK * nch, num_keys=10, disorder=5,
                                      seed=3)
        plan = FaultPlan([Fault("worker", op, "crash", nth=1)])
        table = dict(backend="device_table", capacity=16)
        ad = _plane(spec_kw, tmp_path, prespawn=3, transport=transport,
                    faults=plan, deadlines=_tight(), **table)
        try:
            outs, ex, sup = _supervised(
                ad, items, nch, tmp_path,
                failure_plan=FailurePlan(fail_at=2, recover_after=1))
            _assert_references(spec_kw, items, outs, ex.state, **table)
            assert ad.fault_events["death_dead"] >= 1
            assert plan.kinds_fired().get("worker:crash", 0) >= 1
            assert len([e for e in sup.events if e.kind == "failure"]) >= 2
            tl = ex.metrics.resize_timeline()
            assert [(r["n_old"], r["n_new"]) for r in tl] == [(3, 1), (1, 3)]
            vol = ex.metrics.migration_volume()
            assert vol["rows"] > 0
            payload = vol["rows"] * ROW_BYTES
            assert payload <= vol["bytes"] \
                <= payload + vol["handoffs"] * 7 * 512
            assert 0 < ad.wire_bytes["migration"] <= vol["bytes"]
        finally:
            ad.close()


# ---------------------------------------------------------------------------
# orphaned-worker hygiene and graceful degradation
# ---------------------------------------------------------------------------

class TestOrphansAndDegradation:
    def test_sigkill_coordinator_leaves_no_orphans(self, tmp_path):
        """SIGKILL the coordinator: every worker sees EOF on its pipe,
        dumps its black box, unlinks its rings and exits."""
        bb_dir = tmp_path / "bb"
        script = textwrap.dedent(f"""
            import time
            from repro_torch.keyed import WindowSpec
            from repro_torch.dist import DistributedKeyedPlane

            def main():  # spawn-safe: workers re-import this module
                ad = DistributedKeyedPlane(
                    WindowSpec("tumbling", size=8, lateness=3,
                               late_policy="side"),
                    num_slots=12, prespawn=2, transport="shm",
                    device="cpu", blackbox_dir={str(bb_dir)!r},
                )
                ad._ensure_pool(2)
                pids = [str(h.pid) for h in ad._pool if h is not None]
                rings = [r._shm.name for h in ad._pool if h is not None
                         for r in (h.rings or ())]
                print("READY", ",".join(pids), ";", ",".join(rings),
                      flush=True)
                time.sleep(300)

            if __name__ == "__main__":
                main()
        """)
        path = tmp_path / "coordinator.py"
        path.write_text(script)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep \
            + env.get("PYTHONPATH", "")
        proc = subprocess.Popen([sys.executable, str(path)], env=env,
                                stdout=subprocess.PIPE, text=True)
        try:
            line = ""
            while not line.startswith("READY"):
                line = proc.stdout.readline()
                assert line, "coordinator exited before READY"
            _, pids_s, _, rings_s = line.split()
            pids = [int(p) for p in pids_s.split(",")]
            rings = [r for r in rings_s.split(",") if r]
            assert len(pids) == 2 and len(rings) == 4
        finally:
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait()

        def gone(pid):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    return f.read().split(")")[-1].split()[0] in ("Z", "X")
            except OSError:
                return True

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not all(gone(p) for p in pids):
            time.sleep(0.1)
        assert all(gone(p) for p in pids), "orphaned worker processes"
        leaked = [r for r in rings if os.path.exists(f"/dev/shm/{r}")]
        assert not leaked, f"leaked shm segments: {leaked}"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not (
            bb_dir.exists() and list(bb_dir.iterdir())
        ):
            time.sleep(0.1)
        assert bb_dir.exists() and list(bb_dir.iterdir())

    def test_close_leaves_no_process_and_no_ring(self, tmp_path):
        spec_kw = dict(kind="tumbling", size=8, lateness=3)
        ad = _plane(spec_kw, tmp_path, prespawn=2, spares=1,
                    transport="shm")
        ad._ensure_pool(2)
        hosts = [h for h in ad._pool + ad._spares if h is not None]
        rings = [r._shm.name for h in hosts for r in (h.rings or ())]
        assert len(hosts) == 3 and len(rings) == 6
        ad.close()
        assert not any(h.proc.is_alive() for h in hosts)
        assert not [r for r in rings if os.path.exists(f"/dev/shm/{r}")]

    def test_spawn_failure_sets_capacity_limit(self, tmp_path):
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        items = synthetic_keyed_items(CHUNK * 3, num_keys=6, disorder=3,
                                      seed=5)
        ad = _plane(spec_kw, tmp_path, backend="host", prespawn=2,
                    transport="pipe", deadlines=_tight())
        try:
            ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK)
            chunks = _chunks(items)
            ex.process(chunks[0])

            def refuse():
                raise RuntimeError("spawn refused (drill)")

            ad._spawn = refuse
            ad.kill_worker(1)
            with pytest.raises(WorkerFailure) as ei:
                ex.process(chunks[1])
            assert ei.value.cause == "dead" and ei.value.capacity == 1
            assert ad.capacity_limit == 1
            assert ad.fault_events["degraded"] >= 1
            assert ad.feasible_degrees(CHUNK, [1, 2, 3]) == [1]
            sup = Supervisor(ex, lambda i: chunks[i], num_chunks=3,
                             ckpt_dir=str(tmp_path / "ckpt"))
            assert sup._shrink_for_failure(2, capacity=1) == 1
            reg = MetricsRegistry()
            ad.export_health(reg)
            assert reg.gauge("dist.fault.capacity_limit").value == 1
        finally:
            del ad.__dict__["_spawn"]
            ad.close()

    def test_autoscaler_forces_degrade_onto_capacity(self, tmp_path):
        spec_kw = dict(kind="tumbling", size=12, lateness=3,
                       late_policy="side")
        items = synthetic_keyed_items(CHUNK * 4, num_keys=7, disorder=3,
                                      seed=11)
        ad = _plane(spec_kw, tmp_path, backend="host", prespawn=2,
                    transport="pipe")
        try:
            ex = StreamExecutor(ad, degree=2, chunk_size=CHUNK)
            sc = Autoscaler(QueueDepthPolicy(), [1, 2, 3],
                            cooldown_chunks=100)

            class _Q:
                high_watermark, low_watermark = 8, 1
                depth = 0

            chunks = _chunks(items)
            outs = [ex.process(chunks[0])]
            ad.capacity_limit = 1
            d = sc.maybe_scale(ex, queue=_Q())
            assert d is not None and d.applied and d.signal == "capacity"
            assert ad._active == 1 and ex.degree == 1
            ad.capacity_limit = None
            for c in chunks[1:]:
                outs.append(ex.process(c))
            _assert_references(spec_kw, items, outs, ex.state,
                               backend="host")
        finally:
            ad.close()
