"""The port's control planes against the JAX package's, on the CPU.

* **Checkpoints.** A keyed snapshot under a spill + TTL table config,
  written by either package, restores in the other with equal arrays and
  dtypes, and both packages write the same files and ``manifest.json``;
  the restored state continues the stream bit-exactly.  Tensor leaves come
  back on their template's device in their dtype, an asynchronous save keeps
  the values of the call, bfloat16 is refused, and ``latest_step`` ignores
  incomplete steps.
* **Supervisor.** The same stream with ``FailurePlan(fail_at=3,
  recover_after=2)``, ``ckpt_every=2`` at degree 3, on both backends:
  emissions, early and late channels, the final rows and the
  ``(chunk_index, kind)`` event sequence equal the JAX ``Supervisor``'s;
  traced, the black boxes hold the same events.
* **Autoscaler.** The same chunk records under a logical clock give the
  same proposals from each of the four policies through cooldown and
  hysteresis, and the same ``Decision`` from ``maybe_scale`` over keyed
  executors, the capacity guard included.
* **ServingRuntime.** A reduced model with burst arrivals under
  ``QueueDepthPolicy`` (grow) and under ``SLOLatencyPolicy`` in serving
  mode (shrink): the same tokens per request and resize events.
* **Device rule.** Without ``device=``, the entry points raise on a host
  with no card.
"""

import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.keyed as jkeyed
import repro.obs as jobs
import repro.runtime as jrt
import repro.runtime.autoscaler as jauto
import repro.serving.app as japp
import repro.serving.engine as jengine
import repro_torch.configs as tconfigs
import repro_torch.keyed as tkeyed
import repro_torch.obs as tobs
import repro_torch.runtime as trt
import repro_torch.runtime.autoscaler as tauto
import repro_torch.serving.app as tapp
import repro_torch.serving.engine as tengine
from repro.checkpoint import checkpoint as jckpt
from repro.keyed import synthetic_keyed_items
from repro.models import transformer as JT
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.interop import ROW_COLUMNS, params_from_reference

JAX = types.SimpleNamespace(name="jax", ckpt=jckpt, keyed=jkeyed, obs=jobs,
                            rt=jrt, auto=jauto, app=japp, engine=jengine)
TORCH = types.SimpleNamespace(name="torch", ckpt=tckpt, keyed=tkeyed,
                              obs=tobs, rt=trt, auto=tauto, app=tapp,
                              engine=tengine)
CHUNK = 16
NCH = 6
#: the spill + TTL stress config of the reference's device-table
#: supervisor test: 8 rows a shard, 2 probes, eviction after 4 ticks
TABLE = dict(capacity=8, max_probes=2, ttl=4)


def _items():
    return synthetic_keyed_items(CHUNK * NCH, num_keys=7, disorder=5, seed=3)


def _adapter(pkg, backend="device_table", early_every=0):
    spec = pkg.keyed.WindowSpec("tumbling", size=30, lateness=5,
                                late_policy="side", early_every=early_every)
    kw = dict(num_slots=10, impl="segment", backend=backend,
              **(TABLE if backend == "device_table" else {}))
    if pkg is TORCH:
        kw["device"] = "cpu"
    return pkg.keyed.KeyedWindowAdapter(spec, **kw)


def _assert_channels_equal(a, b):
    for ch in ("emissions", "late", "early"):
        assert set(a[ch]) == set(b[ch]), ch
        for k in a[ch]:
            assert b[ch][k].dtype == a[ch][k].dtype, f"{ch}/{k}"
            np.testing.assert_array_equal(b[ch][k], a[ch][k],
                                          err_msg=f"{ch}/{k}")


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_keyed_checkpoint_restores_across_packages(tmp_path):
    """Both packages write the same directory for the same snapshot, each
    restores the other's, and the restored states continue alike."""
    items = _items()
    chunks = [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]
    ex = {}
    for pkg in (JAX, TORCH):
        ex[pkg.name] = pkg.rt.StreamExecutor(_adapter(pkg), degree=3,
                                             chunk_size=CHUNK)
        ex[pkg.name].run(chunks[:4])
    snap = {k: e.snapshot_barrier() for k, e in ex.items()}
    _assert_states_equal(snap["jax"], snap["torch"])
    assert int(snap["torch"]["t_spilled"]) > 0
    assert int(snap["torch"]["t_evicted"]) > 0
    meta = {"cursor": 4, "degree": 3}
    jckpt.save(str(tmp_path / "jax"), 4, snap["jax"], metadata=meta)
    tckpt.save(str(tmp_path / "torch"), 4, snap["torch"], metadata=meta)
    jdir, tdir = tmp_path / "jax" / "step_4", tmp_path / "torch" / "step_4"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name

    # each package restores the other's directory into its own template
    got_t, meta_t = tckpt.restore(str(tmp_path / "jax"), 4,
                                  _adapter(TORCH).init_state())
    got_j, meta_j = jckpt.restore(str(tmp_path / "torch"), 4,
                                  _adapter(JAX).init_state())
    assert meta_t == meta_j == meta
    _assert_states_equal(snap["jax"], got_t)
    _assert_states_equal(snap["torch"], got_j)
    assert all(isinstance(v, np.ndarray) for v in got_t.values())

    outs = {}
    for pkg, state in ((JAX, got_j), (TORCH, got_t)):
        e = pkg.rt.StreamExecutor(_adapter(pkg), degree=3, chunk_size=CHUNK)
        e.state = state
        outs[pkg.name] = (e.run(chunks[4:]), e.state)
    for a, b in zip(outs["jax"][0], outs["torch"][0]):
        _assert_channels_equal(a, b)
    _assert_states_equal(outs["jax"][1], outs["torch"][1])


def _tree():
    return {
        "b": [torch.tensor([1, 2, 3], dtype=torch.int64),
              np.arange(4, dtype=np.int32)],
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "c": (np.int64(7), None, 2.5),
        "d": {"z": torch.tensor([True, False]), "y": np.float32(1.5)},
    }


def _numpy_tree(tree):
    """The same tree with torch tensors as numpy arrays (the JAX package's
    checkpoint takes host arrays)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy().copy()
    return tree


def test_tensor_leaves_round_trip_and_async_save(tmp_path):
    """Leaf names and the manifest equal the JAX package's; a non-blocking
    save keeps the values of the call; tensors come back as tensors on the
    template's device in their dtype, numpy leaves as numpy, the structure
    (dict, list, tuple, None) as it was."""
    tree = _tree()
    want = _numpy_tree(tree)
    assert list(tckpt._flatten(tree)) == list(jckpt._flatten(want))
    writer = tckpt.save(str(tmp_path / "t"), 3, tree, metadata={"x": 1},
                        blocking=False)
    tree["a"].add_(100.0)       # after save returned: not in the checkpoint
    tree["b"][0].zero_()
    writer.join()
    jckpt.save(str(tmp_path / "j"), 3, want, metadata={"x": 1})
    assert (tmp_path / "t" / "step_3" / "manifest.json").read_text() == \
        (tmp_path / "j" / "step_3" / "manifest.json").read_text()
    assert sorted(os.listdir(tmp_path / "t" / "step_3")) == [
        "a.npy", "b__0.npy", "b__1.npy", "c__0.npy", "c__2.npy", "d__y.npy",
        "d__z.npy", "manifest.json"]

    got, meta = tckpt.restore(str(tmp_path / "j"), 3, tree)
    assert meta == {"x": 1}
    assert isinstance(got["c"], tuple) and got["c"][1] is None
    for path, leaf in tckpt._flatten(got).items():
        ref = tckpt._flatten(tree)[path]
        if isinstance(ref, torch.Tensor):
            assert isinstance(leaf, torch.Tensor) and leaf.device == ref.device
            assert leaf.dtype == ref.dtype
            leaf = leaf.numpy()
        else:
            assert isinstance(leaf, np.ndarray)
        np.testing.assert_array_equal(leaf, tckpt._flatten(want)[path])
        assert leaf.dtype == np.asarray(tckpt._flatten(want)[path]).dtype
    back, _ = jckpt.restore(str(tmp_path / "t"), 3, want)
    for path, leaf in jckpt._flatten(back).items():
        np.testing.assert_array_equal(leaf, jckpt._flatten(want)[path])


def test_bfloat16_leaf_is_refused(tmp_path):
    tree = {"w": torch.zeros(2, dtype=torch.bfloat16), "n": np.int64(1)}
    for blocking in (True, False):
        with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
            tckpt.save(str(tmp_path), 0, tree, blocking=blocking)
    assert not os.listdir(tmp_path)


def test_latest_step_ignores_incomplete_steps(tmp_path):
    for ckpt in (jckpt, tckpt):
        d = tmp_path / ckpt.__name__
        assert ckpt.latest_step(str(d)) is None
        ckpt.save(str(d), 1, {"x": np.arange(3)})
        (d / "step_5.tmp").mkdir()
        (d / "step_5.tmp" / "manifest.json").write_text("{}")
        (d / "step_7").mkdir()               # no manifest: never completed
        assert ckpt.latest_step(str(d)) == 1
        ckpt.save(str(d), 9, {"x": np.arange(3)})
        assert ckpt.latest_step(str(d)) == 9
        assert sorted(os.listdir(d)) == ["step_1", "step_5.tmp", "step_7",
                                         "step_9"]


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def _supervised(pkg, tmp_path, backend, traced):
    items = _items()
    src = pkg.rt.BoundedSource(items)

    def chunk_fn(i):
        src.seek(i * CHUNK)
        return src.take(CHUNK)

    tracer = registry = None
    if traced:
        tracer = pkg.obs.Tracer(clock=pkg.obs.LogicalClock(),
                                recorder=pkg.obs.FlightRecorder())
        registry = pkg.obs.MetricsRegistry()
    ad = _adapter(pkg, backend, early_every=2)
    ex = pkg.rt.StreamExecutor(ad, degree=3, chunk_size=CHUNK, tracer=tracer)
    sup = pkg.rt.Supervisor(
        ex, chunk_fn, num_chunks=NCH, ckpt_dir=str(tmp_path / pkg.name),
        ckpt_every=2, failure_plan=pkg.rt.FailurePlan(fail_at=3,
                                                      recover_after=2),
        registry=registry)
    return sup, sup.run(), ex


@pytest.mark.parametrize("backend,traced", [
    ("host", False), ("device_table", False), ("device_table", True)])
def test_supervisor_equals_the_reference(tmp_path, backend, traced):
    jsup, jouts, jex = _supervised(JAX, tmp_path, backend, traced)
    tsup, touts, tex = _supervised(TORCH, tmp_path, backend, traced)
    assert sorted(touts) == sorted(jouts) == list(range(NCH))
    for i in range(NCH):
        _assert_channels_equal(jouts[i], touts[i])
    jstate, tstate = jex.state, tex.state
    for k in ROW_COLUMNS + ("n_workers", "wm", "late_count"):
        np.testing.assert_array_equal(tstate[k], jstate[k], err_msg=k)
    events = [(e.chunk_index, e.kind) for e in tsup.events]
    assert events == [(e.chunk_index, e.kind) for e in jsup.events]
    kinds = {k for _, k in events}
    assert {"ckpt", "failure", "restore", "shrink", "grow"} <= kinds
    assert len(tsup.mttr_s) == 1
    if traced:
        assert "blackbox" in kinds and len(tsup.blackbox_paths) == 2
        for jp, tp in zip(jsup.blackbox_paths, tsup.blackbox_paths):
            jdoc, tdoc = (json.loads(open(p).read()) for p in (jp, tp))
            assert [(e["name"], e["ph"]) for e in tdoc["traceEvents"]] == \
                [(e["name"], e["ph"]) for e in jdoc["traceEvents"]]
        names = {e["name"] for e in tdoc["traceEvents"]}
        assert {"chunk", "ckpt", "restore"} <= names


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------

class _Queue:
    """A queue stub whose depth follows a script."""

    high_watermark, low_watermark = 8, 1

    def __init__(self, depths):
        self.depths = list(depths)
        self.depth = self.depths[0]


def _policy(pkg, kind):
    a = pkg.auto
    if kind == "queue":
        return a.QueueDepthPolicy()
    if kind == "utilization":
        return a.UtilizationPolicy(low=0.4, high=0.9)
    if kind == "throughput":
        return a.ThroughputTargetPolicy(target_throughput=0.05)
    tracker = pkg.obs.SLOTracker(pkg.obs.SLOSpec(
        name="chunk", objective=40.0, compliance=0.9, short_window=2,
        long_window=4, fast_burn=2.0, slow_burn=1.0))
    if kind == "slo":
        return a.SLOLatencyPolicy(objective=40.0, window=6, tracker=tracker)
    return a.SLOLatencyPolicy(objective=30.0, mode="serving", window=4,
                              tracker=tracker)


@pytest.mark.parametrize("kind", ["queue", "utilization", "throughput",
                                  "slo", "slo-serving"])
def test_policies_decide_like_the_reference(kind):
    """Load that rises, falls and bursts, fed as chunk records under a
    logical clock; cooldown 1 and two confirmations."""
    rng = np.random.default_rng(5)
    work = np.concatenate([np.full(10, 64.0), np.full(10, 320.0),
                           np.full(10, 24.0)]) * rng.uniform(0.9, 1.1, 30)
    depths = rng.integers(0, 12, 30)
    seen = {}
    for pkg in (JAX, TORCH):
        clk = pkg.obs.LogicalClock()
        bus = pkg.rt.MetricsBus(clock=clk)
        pol = _policy(pkg, kind)
        asc = pkg.auto.Autoscaler(pol, [1, 2, 4, 8, 16], cooldown_chunks=1,
                                  confirm=2)
        degree, trail = 8, []
        for step, (w, q) in enumerate(zip(work, depths)):
            queue = _Queue([q])
            tracker = getattr(pol, "tracker", None)
            if tracker is not None:
                tracker.observe(float(w) / degree)
            target = asc.propose(bus, degree, queue=queue,
                                 feasible=[1, 2, 4, 8] if step > 20 else None)
            asc.tick()
            if target is not None:
                degree = target
                asc.notify_resized()
            t0 = clk.now()
            clk.advance(float(w) / degree)
            bus.record_chunk(pkg.rt.ChunkRecord(t0, clk.now(), m=64,
                                                n_workers=degree,
                                                queue_depth=int(q)))
            trail.append((step, target, degree,
                          getattr(pol, "last_signal", "")))
        seen[pkg.name] = trail
    assert seen["torch"] == seen["jax"]
    assert len({d for _, _, d, _ in seen["jax"]}) > 1


def _scaled(pkg, capacity_limit=None):
    items = _items()
    chunks = [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]
    ad = _adapter(pkg)
    ex = pkg.rt.StreamExecutor(ad, degree=3, chunk_size=CHUNK)
    asc = pkg.auto.Autoscaler(pkg.auto.QueueDepthPolicy(), [2, 3, 5, 7],
                              cooldown_chunks=1)
    for i, chunk in enumerate(chunks):
        if capacity_limit is not None and i == 3:
            ad.capacity_limit = capacity_limit
        asc.maybe_scale(ex, queue=_Queue([(12, 12, 0, 12, 12, 0)[i]]))
        ex.process(chunk)
    return [dataclasses.asdict(d) for d in asc.decisions], ex.state


@pytest.mark.parametrize("capacity_limit", [None, 2])
def test_maybe_scale_decisions_equal_the_reference(capacity_limit):
    """Decisions through the executors' resize protocol, with their handoff
    volumes; with a capacity limit the guard forces the degree down."""
    jdec, jstate = _scaled(JAX, capacity_limit)
    tdec, tstate = _scaled(TORCH, capacity_limit)
    assert tdec == jdec and len(jdec) >= 2
    assert any(d["handoff_rows"] > 0 for d in jdec)
    if capacity_limit:
        assert any(d["signal"] == "capacity" for d in jdec)
    for k in ROW_COLUMNS:
        np.testing.assert_array_equal(tstate[k], jstate[k], err_msg=k)


# ---------------------------------------------------------------------------
# ServingRuntime
# ---------------------------------------------------------------------------

class _StepClock:
    """A clock that advances one unit per reading: ticks take equal time
    in both packages, whatever the host does."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get("paper-synthetic").reduced()
    tcfg = tconfigs.get("paper-synthetic").reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, tcfg, params_from_reference(tree, tcfg, device="cpu")


def _serve(pkg, model, slots, policy, total=8, n_new=4):
    jcfg, tree, tcfg, params = model
    if pkg is JAX:
        engine = pkg.engine.ServingEngine(jcfg, tree, num_slots=slots,
                                          s_max=64)
    else:
        engine = pkg.engine.ServingEngine(tcfg, params, num_slots=slots,
                                          s_max=64, device="cpu")
    if policy == "slo":
        pol = pkg.auto.SLOLatencyPolicy(objective=0.5, mode="serving")
        metrics = pkg.rt.MetricsBus(clock=_StepClock())
    else:
        pol, metrics = None, None
    rt = pkg.app.ServingRuntime(
        engine,
        pkg.app.request_source(vocab=tcfg.vocab_size, total=total,
                               max_new_tokens=n_new, seed=2),
        pkg.rt.BurstyRate(base=0, burst=total, period=64, duty=1),
        slot_candidates=[2, 4, 8], queue_capacity=total + 2, policy=pol,
        cooldown_ticks=1, metrics=metrics)
    rt.run()
    assert engine.tokens_out == total * n_new
    return dict(
        tokens={r.rid: list(r.generated) for r in rt.requests},
        events=list(engine.resize_events),
        reports=[dataclasses.asdict(r) for r in rt.reports],
        reasons=[r.reason for r in rt.metrics.resizes])


@pytest.mark.parametrize("slots,policy", [(2, "queue"), (8, "slo")])
def test_serving_runtime_equals_the_reference(model, slots, policy):
    """Burst arrivals grow the slot count under QueueDepthPolicy; an
    objective no tick meets shrinks it under SLOLatencyPolicy."""
    want = _serve(JAX, model, slots, policy)
    got = _serve(TORCH, model, slots, policy)
    assert got == want
    grew = [e["new"] > e["old"] for e in want["events"]]
    assert want["events"] and grew[0] == (policy == "queue")
    assert any(grew) == (policy == "queue")


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

def test_entry_points_need_a_card_without_device(tmp_path, model):
    """The supervisor's and the serving runtime's stacks, built the way a
    user builds them without naming a device, refuse to run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = tkeyed.WindowSpec("tumbling", size=30, lateness=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.Supervisor(
            trt.StreamExecutor(tkeyed.KeyedWindowAdapter(spec, num_slots=10),
                               degree=2, chunk_size=CHUNK),
            lambda i: None, 1, ckpt_dir=str(tmp_path))
    _, _, tcfg, params = model
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.ServingRuntime(
            tengine.ServingEngine(tcfg, params, num_slots=2, s_max=64),
            tapp.request_source(vocab=tcfg.vocab_size, total=1),
            trt.ConstantRate(1), slot_candidates=[2])
