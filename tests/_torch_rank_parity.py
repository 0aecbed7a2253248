"""The runner of ``test_torch_rank_patterns.py``: the paper's patterns with
their workers spread over ``torch.distributed`` ranks, against the JAX
package at 8 placeholder host devices.

``run_all`` starts, side by side, a child that runs the JAX package's
patterns, ``TaskFarm``, ``StreamExecutor``, ``Autoscaler`` and
``Supervisor`` with ``--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_spmd.py`` does), and the port over gloo on the CPU at
each world size of ``WORLDS``, one process a rank, each rendezvous on a
free port.  Both sides run the same cases on the same numpy-seeded
streams.  Every rank records every result (each rank must end with the
reference's global arrays), and per chunk the wire bytes it counted by
family, the bytes it received as an idle rank, and its resident S2 block.
``compare`` then returns ``{check: (passed, detail)}`` for every name of
``checks()``, which the test file parametrises over; the closed forms of
the bytes are written here (``expected_bytes``), apart from the port.

By hand: ``python tests/_torch_rank_parity.py jax out.npz`` (the
reference) or ``... rank <world> <rank> <port> <dir>`` (one rank).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

#: the port's world sizes: 1 (a rank mesh against WorkerMesh), 2 and 4
WORLDS = (1, 2, 4)
#: the degrees the patterns run at directly
DEGREES = (2, 4, 8)
F32_TOL = 3e-5
CHUNK, NUM_CHUNKS = 16, 8
SCHEDULE = {2: 4, 4: 8, 6: 2}
SLOTMAP_SCHEDULE = {2: 4, 4: 5, 6: 2}
SLOTMAP_CHUNK = 20
FAMILIES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


# ---------------------------------------------------------------------------
# the two packages under one set of names
# ---------------------------------------------------------------------------

def jax_pkg():
    import jax
    import jax.numpy as jnp
    from jax import lax

    import repro.core.farm as jfarm
    import repro.core.patterns as jpat
    import repro.runtime as jrt

    def mesh(n):
        return jax.make_mesh((n,), ("workers",),
                             axis_types=(jax.sharding.AxisType.Auto,))

    return types.SimpleNamespace(
        name="jax", pat=jpat, rt=jrt, farm=jfarm, mesh=mesh, exkw=lambda: {},
        arr=jnp.asarray, i32=jnp.int32, f32=jnp.float32,
        minimum=jnp.minimum, cast32=lambda x: x.astype(jnp.int32),
        psum_all=lambda y, ax: lax.psum(jnp.sum(y), ax),
        fails_here=lambda: True)


def torch_pkg(groups=None, factory=None):
    """The port; ``groups`` / ``factory`` make its meshes rank meshes
    (without them: ``WorkerMesh`` on the CPU)."""
    import functools

    import torch
    import torch.distributed as dist

    import repro_torch.core.farm as tfarm
    import repro_torch.core.patterns as tpat
    import repro_torch.runtime as trt
    from repro_torch.core.mesh import RankMesh, WorkerMesh

    if groups is None:
        mesh = functools.partial(WorkerMesh, axis="workers", device="cpu")
        exkw = lambda: dict(mesh_factory=functools.partial(  # noqa: E731
            trt.default_mesh_factory, device="cpu"))
    else:
        mesh = functools.partial(RankMesh, axis="workers", device="cpu",
                                 ranks=groups)
        exkw = lambda: dict(mesh_factory=factory)  # noqa: E731
    return types.SimpleNamespace(
        name="torch", pat=tpat, rt=trt, farm=tfarm, mesh=mesh, exkw=exkw,
        arr=lambda a: torch.as_tensor(np.asarray(a)),
        i32=lambda v: torch.tensor(v, dtype=torch.int32),
        f32=lambda v: torch.tensor(v, dtype=torch.float32),
        minimum=torch.minimum, cast32=lambda x: x.to(torch.int32),
        psum_all=lambda y, mesh: mesh.psum(y.sum(1, dtype=y.dtype)),
        # the one-rank failure fires on the last rank only
        fails_here=lambda: not dist.is_initialized()
        or dist.get_rank() == dist.get_world_size() - 1)


def _s2(P, num_slots, ownership, mul=7, f=None, ns=None):
    return P.pat.PartitionedState(
        f=f or (lambda x, s: x * 2 + s), ns=ns or (lambda x, s: s + x),
        h=lambda x: (P.cast32(x) * mul) % num_slots, num_slots=num_slots,
        ownership=ownership)


def _s3(P, f, zero=None):
    return P.pat.AccumulatorState(
        f=f, g=lambda x: x, combine=lambda a, b: a + b,
        zero=zero or (lambda: P.i32(0)))


def _s4(P):
    return P.pat.SuccessiveApproximationState(
        c=lambda x, s: x < s, s_prime=lambda x, s: P.minimum(x, s),
        direction="min")


def _s5(P):
    return P.pat.SeparateTaskState(f=lambda x: x * x,
                                   s=lambda y, s: s * 31 + y)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def streams():
    rng = np.random.default_rng(0)
    return dict(ints=np.arange(1, 65, dtype=np.int32),
                mixed=rng.integers(-500, 500, 64).astype(np.int32),
                floats=rng.random(64).astype(np.float32),
                wide=rng.integers(1 << 29, 1 << 30, 64).astype(np.int32))


def pattern_cases(P):
    """``{key: thunk}``: each thunk runs one pattern directly over a mesh
    and returns its output tree."""
    st = streams()
    out = {}
    for n in DEGREES:
        out[f"S1/n{n}"] = lambda n=n: P.pat.SerialState(
            f=lambda x, s: x - s, ns=lambda x, s: s * 3 + x).run(
                P.mesh(n), "workers", P.arr(st["mixed"]), P.i32(7))
        for own in ("block", "slotmap"):
            out[f"S2-{own}/n{n}"] = lambda n=n, own=own: _s2(P, 16, own).run(
                P.mesh(n), "workers", P.arr(st["mixed"]),
                P.arr(np.arange(16, dtype=np.int32)))
        # "wide" wraps int32 in the sums: local, then across ranks
        for name in ("ints", "mixed", "wide"):
            for fe in (1, 2, 4, 8):
                out[f"S3/{name}/n{n}/fe{fe}"] = \
                    lambda n=n, name=name, fe=fe: _s3(
                        P, lambda x, v: x * 3 + v).run(
                        P.mesh(n), "workers", P.arr(st[name]),
                        flush_every=fe, s0=P.i32(11))
        for fe in (1, 4):
            out[f"S3f/n{n}/fe{fe}"] = lambda n=n, fe=fe: _s3(
                P, lambda x, v: x * 0.5 + v, zero=lambda: P.f32(0.0)).run(
                P.mesh(n), "workers", P.arr(st["floats"]), flush_every=fe,
                s0=P.f32(0.25))
        for se in (1, 2, 8):
            for name, s0 in (("floats", np.float32(np.inf)),
                             ("mixed", np.int32(400))):
                out[f"S4/{name}/n{n}/se{se}"] = \
                    lambda n=n, name=name, s0=s0, se=se: _s4(P).run(
                        P.mesh(n), "workers", P.arr(st[name]), P.arr(s0),
                        sync_every=se)
        out[f"S5/n{n}"] = lambda n=n: _s5(P).run(
            P.mesh(n), "workers", P.arr(st["mixed"]), P.i32(1))
        out[f"farm/n{n}/map"] = lambda n=n: P.farm.TaskFarm(
            P.mesh(n), "workers").map(lambda x: x * 3 - 1,
                                      P.arr(st["mixed"]))
        out[f"farm/n{n}/collector"] = lambda n=n: P.farm.TaskFarm(
            P.mesh(n), "workers").map(lambda x: x * 3, P.arr(st["mixed"]),
                                      collector=P.psum_all)
        out[f"farm/n{n}/collector-f32"] = lambda n=n: P.farm.TaskFarm(
            P.mesh(n), "workers").map(lambda x: x * 3, P.arr(st["floats"]),
                                      collector=P.psum_all)
    for n in (4, 5, 7):  # slot-map degrees that do not divide 18
        xs = np.arange(20 * n, dtype=np.int32)
        out[f"S2-slotmap18/n{n}"] = lambda n=n, xs=xs: _s2(
            P, 18, "slotmap", 11).run(P.mesh(n), "workers", P.arr(xs),
                                      P.arr(np.zeros(18, np.int32)))
    return out


#: executor case -> (chunk, schedule, initial degree, int elements of the
#: slots or None, items' and state's byte widths per item)
def executor_cases(P):
    rng = np.random.default_rng(7)
    n_items = CHUNK * NUM_CHUNKS
    return {
        "S2-block": (
            lambda: P.rt.PartitionedAdapter(
                _s2(P, 16, "block"), P.arr(np.zeros(16, np.int32))),
            np.arange(n_items, dtype=np.int32), CHUNK, SCHEDULE),
        "S2-slotmap": (
            lambda: P.rt.PartitionedAdapter(
                _s2(P, 18, "slotmap", 11, f=lambda x, s: x * 3 + s,
                    ns=lambda x, s: s + 2 * x),
                P.arr(np.zeros(18, np.int32))),
            np.arange(SLOTMAP_CHUNK * NUM_CHUNKS, dtype=np.int32),
            SLOTMAP_CHUNK, SLOTMAP_SCHEDULE),
        "S3-view-independent": (
            lambda: P.rt.AccumulatorAdapter(
                _s3(P, lambda x, v: x * 3 - 1), flush_every=2),
            np.arange(1, n_items + 1, dtype=np.int32), CHUNK, SCHEDULE),
        "S3-stale-views": (
            lambda: P.rt.AccumulatorAdapter(
                _s3(P, lambda x, v: v * 2 - x), flush_every=2),
            rng.integers(-99, 99, n_items).astype(np.int32), CHUNK,
            SCHEDULE),
        "S4": (
            lambda: P.rt.SuccessiveAdapter(_s4(P), P.i32(2_000_000),
                                           sync_every=2),
            rng.integers(0, 1_000_000, n_items).astype(np.int32), CHUNK,
            SCHEDULE),
        "S5": (
            lambda: P.rt.SeparateAdapter(_s5(P), P.i32(1)),
            np.arange(n_items, dtype=np.int32), CHUNK, SCHEDULE),
        "S3-threading": (
            lambda: P.rt.AccumulatorAdapter(_s3(P, lambda x, v: v),
                                            flush_every=4),
            np.arange(1, 33, dtype=np.int32), 16, None),
    }


def drive(P, make, xs, chunk, schedule, degree=2, extras=None):
    """The stream through ``StreamExecutor``: each chunk's scheduled resize,
    then the chunk (``run``'s order).  With ``extras`` (the port over
    ranks) each step's wire bytes, idle bytes and the resident S2 block
    are recorded in it."""
    ex = P.rt.StreamExecutor(make(), degree=degree, chunk_size=chunk,
                             **P.exkw())
    outs = []
    for i in range(0, len(xs) // chunk):
        if schedule and i in schedule:
            bytes_before = _bytes() if extras is not None else None
            ex.set_degree(schedule[i], reason=f"schedule@chunk{i}")
            if extras is not None:
                extras.setdefault("handoff", {})[str(i)] = \
                    _delta(bytes_before)["all_to_all"]
        before = _bytes() if extras is not None else None
        outs.append(ex.process(P.arr(xs[i * chunk: (i + 1) * chunk])))
        if extras is not None:
            extras.setdefault("chunks", []).append(
                dict(degree=ex.degree, **_delta(before)))
            data = getattr(ex._state, "data", None)
            if data is not None:
                extras.setdefault("block_bytes", []).append(
                    data.numel() * data.element_size())
    resizes = [(r.n_old, r.n_new, r.protocol, r.handoff_items,
                r.handoff_rows, r.handoff_bytes)
               for r in ex.metrics.resizes]
    return dict(outs=outs, state=ex.state, resizes=resizes,
                degrees=ex.compiled_degrees)


def _bytes():
    from repro_torch.core.mesh import IDLE_BYTES
    from repro_torch.launch.mesh import WIRE_BYTES

    return dict(WIRE_BYTES, idle=IDLE_BYTES["broadcast"])


def _delta(before):
    now = _bytes()
    return {k: now[k] - before[k] for k in now}


def control(P, tmp):
    """``Autoscaler(QueueDepthPolicy)`` over a backpressure queue,
    ``Supervisor`` with a failure and a recovery (``test_torch_spmd.py``'s
    runs), and ``Supervisor`` with a failure raised on one rank only: the
    last rank's chunk source fails once before chunk 3 (in the reference,
    the one process's)."""
    rt = P.rt
    data = np.arange(CHUNK * 12, dtype=np.int32)
    ex = rt.StreamExecutor(
        rt.PartitionedAdapter(
            _s2(P, 16, "block", 13, f=lambda x, s: x + 3 * s,
                ns=lambda x, s: s + 2 * x), P.arr(np.zeros(16, np.int32))),
        degree=2, chunk_size=CHUNK, **P.exkw())
    scaler = rt.Autoscaler(rt.QueueDepthPolicy(), candidates=[2, 4, 8],
                           cooldown_chunks=1)
    src = rt.BoundedSource(data)
    q = rt.BackpressureQueue(capacity=6 * CHUNK, high_watermark=3 * CHUNK,
                             low_watermark=CHUNK // 2)
    chunker = rt.Chunker(CHUNK)
    outs, pend, t = [], None, 0
    while not (src.exhausted and q.depth == 0):
        pend = rt.pump(src, rt.ConstantRate(3 * CHUNK), q, t, pending=pend)
        q.observe()
        while chunker.ready(q):
            scaler.maybe_scale(ex, queue=q)
            c = chunker.next_chunk(q)
            outs.append(ex.process(P.arr(c), queue_depth=q.depth))
        t += 1
    res = {"autoscaled/ys": np.concatenate([np.asarray(o) for o in outs]),
           "autoscaled/state": ex.state,
           "autoscaled/resizes": json.dumps(
               [(r.n_old, r.n_new, r.protocol, r.handoff_items)
                for r in ex.metrics.resizes])}

    data = np.arange(1, CHUNK * 6 + 1, dtype=np.int32)
    ex = rt.StreamExecutor(
        rt.AccumulatorAdapter(_s3(P, lambda x, v: x - v), flush_every=4),
        degree=4, chunk_size=CHUNK, **P.exkw())
    sup = rt.Supervisor(
        ex, lambda i: P.arr(data[i * CHUNK: (i + 1) * CHUNK]), num_chunks=6,
        ckpt_dir=os.path.join(tmp, "ckpt"), ckpt_every=2,
        failure_plan=rt.FailurePlan(fail_at=3, recover_after=2))
    _supervised(res, "supervised", ex, sup)

    ex = rt.StreamExecutor(
        rt.AccumulatorAdapter(_s3(P, lambda x, v: x - v), flush_every=4),
        degree=4, chunk_size=CHUNK, **P.exkw())
    failing = [P.fails_here()]

    def source(i):
        if i == 3 and failing[0]:
            failing[0] = False
            raise rt.WorkerFailure(f"chunk source lost before chunk {i}")
        return P.arr(data[i * CHUNK: (i + 1) * CHUNK])

    # the plan never fires (chunk 6 is past the stream): it sets the
    # recovery's pace, 2 chunks, as in the run above
    sup = rt.Supervisor(
        ex, source, num_chunks=6, ckpt_dir=os.path.join(tmp, "ckpt-one"),
        ckpt_every=2, failure_plan=rt.FailurePlan(fail_at=6, recover_after=2))
    _supervised(res, "supervised-one-rank", ex, sup)
    return res


def _supervised(res, name, ex, sup):
    outs = sup.run()
    res.update({
        f"{name}/ys": np.concatenate([np.asarray(outs[i]) for i in range(6)]),
        f"{name}/state": ex.state,
        f"{name}/events": json.dumps(
            [(e.chunk_index, e.kind) for e in sup.events
             if e.kind != "blackbox"]),
        f"{name}/resizes": json.dumps(
            [(r.n_old, r.n_new, r.protocol) for r in ex.metrics.resizes])})


def run_everything(P, tmp, extras=None):
    """Every case's results as ``{key: array or json}``."""
    res = {}
    for key, thunk in pattern_cases(P).items():
        _flat(res, f"run/{key}", thunk())
    for name, (make, xs, chunk, schedule) in executor_cases(P).items():
        ext = None if extras is None else extras.setdefault(name, {})
        d = drive(P, make, xs, chunk, schedule, extras=ext)
        for i, o in enumerate(d["outs"]):
            _flat(res, f"ex/{name}/out/{i}", o)
        _flat(res, f"ex/{name}/state", d["state"])
        res[f"ex/{name}/resizes"] = json.dumps(d["resizes"])
        res[f"ex/{name}/degrees"] = json.dumps(d["degrees"])
    for k, v in control(P, tmp).items():
        _flat(res, f"control/{k}", v)
    return res


def _flat(res, prefix, tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(res, f"{prefix}/{k}", tree[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(res, f"{prefix}/{i}", v)
    elif isinstance(tree, str):
        res[prefix] = tree
    else:
        res[prefix] = np.asarray(tree)


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def jax_main(out):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax

    assert jax.device_count() == 8, jax.devices()
    res = run_everything(jax_pkg(), os.path.dirname(out))
    np.savez(out, **res)


def rank_main(world, rank, port, out_dir):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import prefix_groups, reset_wire_bytes

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.runtime import RankMeshFactory

        groups = prefix_groups(range(1, world + 1))
        factory = RankMeshFactory(degrees=(1, 2, 4, 5, 8), device="cpu")
        reset_wire_bytes()
        extras = {}
        tmp = os.path.join(out_dir, f"w{world}")
        os.makedirs(tmp, exist_ok=True)
        res = run_everything(torch_pkg(groups, factory), tmp, extras)
        res["extras"] = json.dumps(extras)
        if world == 1:  # the same cases over WorkerMesh on the CPU
            wm = run_everything(torch_pkg(), os.path.join(tmp, "wm"))
            res.update({f"wm/{k}": v for k, v in wm.items()})
        np.savez(os.path.join(out_dir, f"w{world}_r{rank}.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_all(tmp, timeout=300):
    """Runs the reference and every world of ranks in ``tmp`` ->
    ``{check: (passed, detail)}``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    me = os.path.abspath(__file__)
    ref_out = os.path.join(tmp, "jax.npz")

    def start(*args):
        return subprocess.Popen([sys.executable, me, *map(str, args)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    procs = [start("jax", ref_out)]
    for world in WORLDS:
        port = _free_port()
        procs += [start("rank", world, r, port, tmp) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tail = "\n".join(logs[i][-3000:] for i in failed)
        raise RuntimeError(f"processes {failed} failed\n{tail}")
    ref = dict(np.load(ref_out))
    port = {(w, r): dict(np.load(os.path.join(tmp, f"w{w}_r{r}.npz")))
            for w in WORLDS for r in range(w)}
    return compare(ref, port)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def result_groups():
    """The result groups every world is checked on, from the cases' names
    (the same on both sides)."""
    names = [f"run/{k}" for k in pattern_cases(_names_only())]
    for name in executor_cases(_names_only()):
        names += [f"ex/{name}/out", f"ex/{name}/state",
                  f"ex/{name}/resizes", f"ex/{name}/degrees"]
    for run in ("autoscaled", "supervised", "supervised-one-rank"):
        names += [f"control/{run}/ys", f"control/{run}/state",
                  f"control/{run}/resizes"]
    names += ["control/supervised/events",
              "control/supervised-one-rank/events"]
    return names


def _names_only():
    """A package namespace whose cases are only named, not run."""
    return types.SimpleNamespace(
        pat=None, rt=types.SimpleNamespace(
            PartitionedAdapter=None, AccumulatorAdapter=None,
            SuccessiveAdapter=None, SeparateAdapter=None),
        arr=lambda a: a, i32=int, f32=float)


def checks():
    """The check names, in a fixed order: each result group at each world
    (every rank), the bytes of each executor case at worlds 2 and 4, and a
    world of one against ``WorkerMesh``."""
    out = []
    for world in WORLDS:
        out += [f"w{world}/{g}" for g in result_groups()]
    for world in WORLDS[1:]:
        for name in executor_cases(_names_only()):
            out += [f"w{world}/bytes/{name}/wire",
                    f"w{world}/bytes/{name}/idle"]
        out += [f"w{world}/bytes/S2-block/handoff",
                f"w{world}/bytes/S2-block/resident"]
    out += [f"w1/worker-mesh/{g}" for g in result_groups()]
    return out


def _key_matches(key, group):
    return key == group or key.startswith(group + "/")


def _equal_or_close(got, want):
    if got.dtype.kind in "US" or want.dtype.kind in "US":
        return str(got) == str(want), "json differs"
    if got.dtype != want.dtype:
        return False, f"dtype {got.dtype} vs {want.dtype}"
    if got.shape != want.shape:
        return False, f"shape {got.shape} vs {want.shape}"
    if got.dtype.kind == "f":
        err = float(np.max(np.abs(got.astype(np.float64)
                                  - want.astype(np.float64)), initial=0.0))
        return err <= F32_TOL, f"max abs err {err:.3g} (limit {F32_TOL})"
    ok = np.array_equal(got, want)
    return ok, "bit-exact" if ok else \
        f"{int(np.sum(got != want))} elements differ"


def _compare_group(want, got, group):
    keys = sorted(k for k in want if _key_matches(k, group))
    if not keys:
        return False, f"no reference results under {group}"
    for k in keys:
        if k not in got:
            return False, f"{k} missing"
        ok, detail = _equal_or_close(got[k], want[k])
        if not ok:
            return False, f"{k}: {detail}"
    return True, f"{len(keys)} arrays"


def prefix_size(n, world):
    """The ranks a degree-``n`` mesh spans: the largest divisor of ``n``
    not above the world (the layout the port documents)."""
    return max(d for d in range(1, min(n, world) + 1) if n % d == 0)


def expected_bytes(name, degree, rank, world, chunk):
    """The closed form of one executor case's bytes for one chunk on one
    rank at ``degree``: ``{family: bytes}`` by the ring formulas (an
    all-reduce ``2 b (g-1)/g``, an all-gather ``b (g-1)/g`` of its result,
    ``g`` the ranks the degree spans), and ``idle``: the outputs an idle
    rank receives from rank 0.  Every item and slot is int32 (4 bytes)."""
    g = prefix_size(degree, world)
    share = (g - 1) / g
    m = chunk * 4  # the chunk's bytes, and its ys'
    ar, ag, idle = 0.0, 0.0, 0.0
    if name == "S2-block":
        ag, ar, idle = m * share, 2 * m * share, m
    elif name == "S2-slotmap":
        ag, ar, idle = m * share, 2 * (m + 18 * 4) * share, m + 18 * 4
    elif name.startswith("S3"):
        flush = 4 if name == "S3-threading" else 2
        blocks = chunk // degree // flush
        ar, ag, idle = 2 * 4 * blocks * share, m * share, m + 4
    elif name == "S4":
        blocks = chunk // degree // 2
        ar, ag, idle = 2 * 4 * blocks * share, m * share, m + 4
    elif name == "S5":
        ag, idle = m * share, 2 * m + 4
    if rank >= g:
        return dict.fromkeys(FAMILIES, 0.0) | {"idle": idle}
    return {"all_reduce": ar, "all_gather": ag, "reduce_scatter": 0.0,
            "all_to_all": 0.0, "idle": 0.0}


def expected_handoff(rank, world, n_old, n_new, num_slots=16):
    """The int32 bytes rank ``rank`` receives in the block handoff from
    degree ``n_old`` to ``n_new``: the slots whose owning rank changes and
    that it owns after.  Slot ``p``'s owning rank at degree ``n`` is
    ``owner(p) // (n / g)``, the owner being the reference's block rule."""
    def owning_rank(p, n):
        g = prefix_size(n, world)
        return (p // (num_slots // n)) // (n // g)

    return 4 * sum(1 for p in range(num_slots)
                   if owning_rank(p, n_new) == rank
                   and owning_rank(p, n_old) != rank)


def _bytes_checks(port, world):
    out = {}
    ranks = [json.loads(str(port[(world, r)]["extras"]))
             for r in range(world)]
    for name, (_, xs, chunk, schedule) in executor_cases(
            _names_only()).items():
        bad_wire, bad_idle = [], []
        for r, ext in enumerate(ranks):
            for i, rec in enumerate(ext[name]["chunks"]):
                want = expected_bytes(name, rec["degree"], r, world, chunk)
                for fam in FAMILIES:
                    if rec[fam] != want[fam]:
                        bad_wire.append((r, i, fam, rec[fam], want[fam]))
                if rec["idle"] != want["idle"]:
                    bad_idle.append((r, i, rec["idle"], want["idle"]))
        out[f"w{world}/bytes/{name}/wire"] = (
            not bad_wire, f"{bad_wire[:4]}" if bad_wire else "closed form")
        out[f"w{world}/bytes/{name}/idle"] = (
            not bad_idle, f"{bad_idle[:4]}" if bad_idle else "closed form")
    # the block handoff and the resident block
    bad, bad_res, total = [], [], 0
    degrees = [2] + [SCHEDULE[i] for i in sorted(SCHEDULE)]
    for r, ext in enumerate(ranks):
        rec = ext["S2-block"]
        for (i, got), n_old, n_new in zip(
                sorted(rec["handoff"].items(), key=lambda kv: int(kv[0])),
                degrees, degrees[1:]):
            want = expected_handoff(r, world, n_old, n_new)
            total += got
            if got != want:
                bad.append((r, i, got, want))
        for i, got in enumerate(rec["block_bytes"]):
            deg = rec["chunks"][i]["degree"]
            g = prefix_size(deg, world)
            want = 16 * 4 // g if r < g else 0
            if got != want:
                bad_res.append((r, i, got, want))
    out[f"w{world}/bytes/S2-block/handoff"] = (
        not bad, f"{bad[:4]}" if bad else f"{total} bytes over the ranks")
    out[f"w{world}/bytes/S2-block/resident"] = (
        not bad_res, f"{bad_res[:4]}" if bad_res else "each rank its block")
    return out


def compare(ref, port):
    out = {}
    groups = result_groups()
    for world in WORLDS:
        for g in groups:
            res = [_compare_group(ref, port[(world, r)], g)
                   for r in range(world)]
            bad = [(r, d) for r, (ok, d) in enumerate(res) if not ok]
            out[f"w{world}/{g}"] = (not bad, str(bad[:2]) if bad
                                    else res[0][1])
    for world in WORLDS[1:]:
        out.update(_bytes_checks(port, world))
    one = port[(1, 0)]
    for g in groups:
        keys = sorted(k for k in one if _key_matches(k, g))
        bad = [k for k in keys
               if not _equal_or_close(one[k], one["wm/" + k])[0]
               or (one[k].dtype.kind == "f"
                   and not np.array_equal(one[k], one["wm/" + k]))]
        out[f"w1/worker-mesh/{g}"] = (bool(keys) and not bad,
                                      f"{bad[:3]}" if bad else
                                      f"{len(keys)} arrays bit-equal")
    return out


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(sys.argv[2])
    else:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
