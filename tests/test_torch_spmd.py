"""The port's patterns and SPMD executor against the JAX package's at 8
workers, on the CPU.

The reference's ``run`` needs one device per worker, so each test re-runs
this file as a child process with ``--xla_force_host_platform_device_count=8``
(as ``tests/test_spmd.py`` runs ``spmd_checks.py``), keeping the main
pytest process at one device.  In the child, on the same streams and
degree schedules:

* ``patterns`` — S3's per-item ys (stale views) bit-equal over
  ``flush_every`` in {1, 2, 4, 8} and S4's traces over ``sync_every`` in
  {1, 2, 8}, at 2, 4 and 8 workers; S2 (both ownerships) and S5 whole.
* ``executor`` — the reference's ``StreamExecutor`` and the port's with each
  of the four adapters under the schedules of ``tests/runtime_checks.py``:
  outputs, final state, ``ResizeInfo`` protocols, handoff counts and the
  degrees with a cached step.
* ``control`` — ``Autoscaler(QueueDepthPolicy)`` over a backpressure queue
  and ``Supervisor`` with a failure and a recovery: outputs, state, the
  resize sequence and the ``(chunk_index, kind)`` events.
"""

import os
import subprocess
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
DONE = "TORCH SPMD CHECKS PASSED"

CHUNK = 16
NUM_CHUNKS = 8
SCHEDULE = {2: 4, 4: 8, 6: 2}  # grow 2 -> 4 -> 8, shrink back to 2


@pytest.mark.parametrize("group", ["patterns", "executor", "control"])
def test_cross_package_at_8_workers(group, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(_REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), group, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    assert f"{group}: {DONE}" in proc.stdout


# ---------------------------------------------------------------------------
# the child
# ---------------------------------------------------------------------------

def _pkgs():
    """The two packages' modules under one set of names, and a mesh maker
    for each (the reference's over host devices, the port's on the CPU)."""
    import functools
    import types

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import repro.core.patterns as jpat
    import repro.runtime as jrt
    import repro_torch.core.patterns as tpat
    import repro_torch.runtime as trt
    from repro_torch.core.mesh import WorkerMesh

    def jmesh(n):
        return jax.make_mesh((n,), ("workers",),
                             axis_types=(jax.sharding.AxisType.Auto,))

    J = types.SimpleNamespace(
        name="jax", pat=jpat, rt=jrt, mesh=jmesh, exkw={},
        arr=jnp.asarray, i32=jnp.int32, f32=jnp.float32,
        minimum=jnp.minimum, cast32=lambda x: x.astype(jnp.int32))
    T = types.SimpleNamespace(
        name="torch", pat=tpat, rt=trt,
        mesh=lambda n: WorkerMesh(n, "workers", device="cpu"),
        exkw=dict(mesh_factory=functools.partial(trt.default_mesh_factory,
                                                 device="cpu")),
        arr=lambda a: torch.as_tensor(np.asarray(a)),
        i32=lambda v: torch.tensor(v, dtype=torch.int32),
        f32=lambda v: torch.tensor(v, dtype=torch.float32),
        minimum=torch.minimum, cast32=lambda x: x.to(torch.int32))
    return J, T


def _equal(got, want, what):
    import numpy as np

    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}[{k}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _s2(P, num_slots, ownership, mul=7, f=None, ns=None):
    return P.pat.PartitionedState(
        f=f or (lambda x, s: x * 2 + s), ns=ns or (lambda x, s: s + x),
        h=lambda x: (P.cast32(x) * mul) % num_slots, num_slots=num_slots,
        ownership=ownership)


def _s3(P, f):
    return P.pat.AccumulatorState(f=f, g=lambda x: x,
                                  combine=lambda a, b: a + b,
                                  zero=lambda: P.i32(0))


def _s4(P):
    return P.pat.SuccessiveApproximationState(
        c=lambda x, s: x < s, s_prime=lambda x, s: P.minimum(x, s),
        direction="min")


def _s5(P, f=lambda x: x * x, s=lambda y, s: s * 31 + y):
    return P.pat.SeparateTaskState(f=f, s=s)


def check_patterns():
    import numpy as np

    J, T = _pkgs()
    rng = np.random.default_rng(0)
    ints = np.arange(1, 65, dtype=np.int32)
    mixed = rng.integers(-500, 500, 64).astype(np.int32)
    floats = rng.random(64).astype(np.float32)
    for n in (2, 4, 8):
        for xs in (ints, mixed):
            for fe in (1, 2, 4, 8):
                got = _s3(T, lambda x, v: x * 3 + v).run(
                    T.mesh(n), "workers", T.arr(xs), flush_every=fe,
                    s0=T.i32(11))
                want = _s3(J, lambda x, v: x * 3 + v).run(
                    J.mesh(n), "workers", J.arr(xs), flush_every=fe,
                    s0=J.i32(11))
                _equal(got[0], want[0], f"S3 ys n={n} flush_every={fe}")
                _equal(got[1], want[1], f"S3 state n={n} flush_every={fe}")
        for se in (1, 2, 8):
            for xs, s0 in ((floats, np.float32(np.inf)),
                           (mixed, np.int32(400))):
                got = _s4(T).run(T.mesh(n), "workers", T.arr(xs), T.arr(s0),
                                 sync_every=se)
                want = _s4(J).run(J.mesh(n), "workers", J.arr(xs), J.arr(s0),
                                  sync_every=se)
                _equal(got[0], want[0], f"S4 trace n={n} sync_every={se}")
                _equal(got[1], want[1], f"S4 state n={n} sync_every={se}")
        for ownership in ("block", "slotmap"):
            v0 = np.arange(16, dtype=np.int32)
            got = _s2(T, 16, ownership).run(T.mesh(n), "workers",
                                            T.arr(mixed), T.arr(v0))
            want = _s2(J, 16, ownership).run(J.mesh(n), "workers",
                                             J.arr(mixed), J.arr(v0))
            _equal(got[0], want[0], f"S2 {ownership} ys n={n}")
            _equal(got[1], want[1], f"S2 {ownership} v n={n}")
        got = _s5(T).run(T.mesh(n), "workers", T.arr(mixed), T.i32(1))
        want = _s5(J).run(J.mesh(n), "workers", J.arr(mixed), J.i32(1))
        for g, w, k in zip(got, want, ("ys", "trace", "state")):
            _equal(g, w, f"S5 {k} n={n}")
    # slotmap at degrees that do not divide 18
    for n in (4, 5, 7):
        xs = np.arange(20 * n, dtype=np.int32)
        got = _s2(T, 18, "slotmap", 11).run(T.mesh(n), "workers", T.arr(xs),
                                            T.arr(np.zeros(18, np.int32)))
        want = _s2(J, 18, "slotmap", 11).run(J.mesh(n), "workers",
                                             J.arr(xs),
                                             J.arr(np.zeros(18, np.int32)))
        _equal(got[0], want[0], f"S2 slotmap ys n={n}")
        _equal(got[1], want[1], f"S2 slotmap v n={n}")


def _drive(P, make_adapter, xs, chunk, schedule, degree=2):
    ex = P.rt.StreamExecutor(make_adapter(P), degree=degree, chunk_size=chunk,
                             **P.exkw)
    chunks = [P.arr(xs[i: i + chunk]) for i in range(0, len(xs), chunk)]
    outs = ex.run(chunks, schedule=schedule)
    resizes = [(r.n_old, r.n_new, r.protocol, r.handoff_items, r.handoff_rows)
               for r in ex.metrics.resizes]
    return outs, ex.state, resizes, ex.compiled_degrees


def check_executor():
    import numpy as np

    J, T = _pkgs()
    n_items = CHUNK * NUM_CHUNKS
    rng = np.random.default_rng(7)
    cases = {
        "S2 block": (
            lambda P: P.rt.PartitionedAdapter(_s2(P, 16, "block"),
                                              P.arr(np.zeros(16, np.int32))),
            np.arange(n_items, dtype=np.int32), CHUNK, SCHEDULE),
        "S2 slotmap": (
            lambda P: P.rt.PartitionedAdapter(
                _s2(P, 18, "slotmap", 11, f=lambda x, s: x * 3 + s,
                    ns=lambda x, s: s + 2 * x),
                P.arr(np.zeros(18, np.int32))),
            np.arange(20 * NUM_CHUNKS, dtype=np.int32), 20,
            {2: 4, 4: 5, 6: 2}),
        "S3 view-independent": (
            lambda P: P.rt.AccumulatorAdapter(
                _s3(P, lambda x, v: x * 3 - 1), flush_every=2),
            np.arange(1, n_items + 1, dtype=np.int32), CHUNK, SCHEDULE),
        "S3 stale views": (
            lambda P: P.rt.AccumulatorAdapter(
                _s3(P, lambda x, v: v * 2 - x), flush_every=2),
            rng.integers(-99, 99, n_items).astype(np.int32), CHUNK,
            SCHEDULE),
        "S4": (
            lambda P: P.rt.SuccessiveAdapter(_s4(P), P.i32(2_000_000),
                                             sync_every=2),
            rng.integers(0, 1_000_000, n_items).astype(np.int32), CHUNK,
            SCHEDULE),
        "S5": (
            lambda P: P.rt.SeparateAdapter(_s5(P), P.i32(1)),
            np.arange(n_items, dtype=np.int32), CHUNK, SCHEDULE),
    }
    for name, (make, xs, chunk, schedule) in cases.items():
        t_outs, t_state, t_res, t_deg = _drive(T, make, xs, chunk, schedule)
        j_outs, j_state, j_res, j_deg = _drive(J, make, xs, chunk, schedule)
        assert len(t_outs) == len(j_outs), name
        for i, (g, w) in enumerate(zip(t_outs, j_outs)):
            _equal(g, w, f"{name} chunk {i}")
        _equal(t_state, j_state, f"{name} state")
        assert t_res == j_res, (name, t_res, j_res)
        assert t_deg == j_deg, (name, t_deg, j_deg)
    # S3 state threading at a fixed degree: chunk N+1's views see chunk N
    xs = np.arange(1, 33, dtype=np.int32)
    make = lambda P: P.rt.AccumulatorAdapter(  # noqa: E731
        _s3(P, lambda x, v: v), flush_every=4)
    t = _drive(T, make, xs, 16, None)
    j = _drive(J, make, xs, 16, None)
    for g, w in zip(t[0], j[0]):
        _equal(g, w, "S3 threading ys")
    _equal(t[1], j[1], "S3 threading state")
    assert int(t[1]) == int(xs.sum())


def check_control(tmp):
    import numpy as np

    J, T = _pkgs()
    # the autoscaler grows under backlog (runtime_checks.py:221-260)
    data = np.arange(CHUNK * 12, dtype=np.int32)
    results = {}
    for P in (J, T):
        rt = P.rt
        ex = rt.StreamExecutor(
            rt.PartitionedAdapter(
                _s2(P, 16, "block", 13, f=lambda x, s: x + 3 * s,
                    ns=lambda x, s: s + 2 * x),
                P.arr(np.zeros(16, np.int32))),
            degree=2, chunk_size=CHUNK, **P.exkw)
        scaler = rt.Autoscaler(rt.QueueDepthPolicy(), candidates=[2, 4, 8],
                               cooldown_chunks=1)
        src = rt.BoundedSource(data)
        q = rt.BackpressureQueue(capacity=6 * CHUNK,
                                 high_watermark=3 * CHUNK,
                                 low_watermark=CHUNK // 2)
        chunker = rt.Chunker(CHUNK)
        outs, pend, t = [], None, 0
        while not (src.exhausted and q.depth == 0):
            pend = rt.pump(src, rt.ConstantRate(3 * CHUNK), q, t,
                           pending=pend)
            q.observe()
            while chunker.ready(q):
                scaler.maybe_scale(ex, queue=q)
                c = chunker.next_chunk(q)
                outs.append(ex.process(P.arr(c), queue_depth=q.depth))
            t += 1
        results[P.name] = (
            np.concatenate([np.asarray(o) for o in outs]), ex.state,
            [(r.n_old, r.n_new, r.protocol, r.handoff_items)
             for r in ex.metrics.resizes])
    got, want = results["torch"], results["jax"]
    _equal(got[0], want[0], "autoscaled ys")
    _equal(got[1], want[1], "autoscaled state")
    assert got[2] == want[2] and any(r[1] > r[0] for r in got[2]), got[2]

    # the supervisor's failure -> shrink, recovery -> grow (:262-290)
    data = np.arange(1, CHUNK * 6 + 1, dtype=np.int32)
    for P in (J, T):
        rt = P.rt
        ex = rt.StreamExecutor(
            rt.AccumulatorAdapter(_s3(P, lambda x, v: x - v), flush_every=4),
            degree=4, chunk_size=CHUNK, **P.exkw)
        sup = rt.Supervisor(
            ex, lambda i, P=P: P.arr(data[i * CHUNK: (i + 1) * CHUNK]),
            num_chunks=6, ckpt_dir=os.path.join(tmp, P.name), ckpt_every=2,
            failure_plan=rt.FailurePlan(fail_at=3, recover_after=2))
        outs = sup.run()
        results[P.name] = (
            np.concatenate([np.asarray(outs[i]) for i in range(6)]),
            ex.state, [(e.chunk_index, e.kind) for e in sup.events],
            [(r.n_old, r.n_new, r.protocol) for r in ex.metrics.resizes])
    got, want = results["torch"], results["jax"]
    _equal(got[0], want[0], "supervised ys")
    _equal(got[1], want[1], "supervised state")
    assert got[2] == want[2], (got[2], want[2])
    assert got[3] == want[3], (got[3], want[3])
    kinds = {k for _, k in got[2]}
    assert {"failure", "restore", "shrink", "grow"} <= kinds, kinds


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax

    assert jax.device_count() == 8, jax.devices()
    group = sys.argv[1]
    if group == "patterns":
        check_patterns()
    elif group == "executor":
        check_executor()
    else:
        check_control(sys.argv[2])
    print(f"{group}: {DONE}")
