"""The port's five state access patterns against the JAX package's, on the
CPU.

* **Semantics.**  Every ``semantics.*`` oracle of the port equals
  ``repro.core.semantics``'s on numpy-seeded int32 streams (negative values
  pin flooring ``//`` and ``%``; large multipliers pin int32 wraparound),
  float32 for successive approximation; ``keyed_windows`` over tumbling,
  sliding and session windows with early firing and the late side output.
* **Simulator.**  Every ``simulate_*`` returns the reference's ``SimResult``
  field for field (the same numpy draws from the same seeds).
* **Ownership and adaptivity math** over a grid of slot counts and degrees,
  errors included.
* **run.**  S1-S5 at one worker equal the reference's ``run`` on a
  one-device JAX mesh; at 2, 4 and 8 workers they equal the JAX oracle
  wherever the reference holds its own ``run`` to it
  (``tests/spmd_checks.py``).  Pytree state, ``TaskFarm.map`` with and
  without a collector, ``pipeline_stages``.
* **Executor.**  The per-degree step cache, a tail chunk, the granularity
  errors, and the device rule: without ``device=`` the mesh and the
  executor raise on a host with no card.

Cross-package runs at 8 workers of the reference (which needs 8 host
devices) are in ``tests/test_torch_spmd.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import farm as jfarm
from repro.core import patterns as jpat
from repro.core import semantics as jsem
from repro.core import simulator as jsim
from repro_torch.core import farm as tfarm
from repro_torch.core import patterns as tpat
from repro_torch.core import semantics as tsem
from repro_torch.core import simulator as tsim
from repro_torch.core.mesh import WorkerMesh, psum
from repro_torch.runtime import (
    AccumulatorAdapter,
    PartitionedAdapter,
    SeparateAdapter,
    StreamExecutor,
    SuccessiveAdapter,
    default_mesh_factory,
)

CPU_MESH = functools.partial(default_mesh_factory, device="cpu")
F32 = dict(atol=3e-5, rtol=3e-5)


def cpu_mesh(n):
    return WorkerMesh(n, "workers", device="cpu")


def jax_mesh1():
    return jax.make_mesh((1,), ("workers",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def stream(seed, m, lo=-1000, hi=1000):
    return np.random.default_rng(seed).integers(lo, hi, m).astype(np.int32)


def T(a):
    return torch.as_tensor(np.asarray(a))


def equal(got, want):
    """Tensors (or pytrees of them) equal bit for bit, in dtype too."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            equal(got[k], want[k])
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            equal(g, w)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


seeds = st.integers(min_value=0, max_value=2**31 - 1)
lengths = st.sampled_from([1, 7, 16, 33, 64])


# ---------------------------------------------------------------------------
# semantics: the port's oracles against the reference's
# ---------------------------------------------------------------------------

class TestSemantics:
    @given(seeds, lengths)
    @settings(max_examples=8, deadline=None)
    def test_serial(self, seed, m):
        xs = stream(seed, m)
        # s * 1000003 wraps int32 within a few steps; // and % of negatives
        ys, s = tsem.serial(lambda x, s: x * 10 - s // 3,
                            lambda x, s: s * 1000003 + x % 7, T(xs),
                            torch.tensor(5, dtype=torch.int32))
        jys, js = jsem.serial(lambda x, s: x * 10 - s // 3,
                              lambda x, s: s * 1000003 + x % 7,
                              jnp.asarray(xs), jnp.int32(5))
        equal(ys, jys)
        equal(s, js)

    @given(seeds, lengths, st.sampled_from([2, 5, 8]))
    @settings(max_examples=8, deadline=None)
    def test_partitioned(self, seed, m, num_slots):
        xs = stream(seed, m)
        v0 = np.arange(num_slots, dtype=np.int32) - 3
        v0_t = T(v0)
        ys, v = tsem.partitioned(lambda x, s: x + 3 * s,
                                 lambda x, s: s + x // 4,
                                 lambda x: (x * 31 + 7) % num_slots,
                                 T(xs), v0_t)
        jys, jv = jsem.partitioned(lambda x, s: x + 3 * s,
                                   lambda x, s: s + x // 4,
                                   lambda x: (x * 31 + 7) % num_slots,
                                   jnp.asarray(xs), jnp.asarray(v0))
        equal(ys, jys)
        equal(v, jv)
        equal(v0_t, v0)  # the caller's vector is not modified

    def test_partitioned_pytree_state(self):
        xs = np.arange(16, dtype=np.int32)
        f = lambda x, s: s["a"] + x  # noqa: E731
        ns = lambda x, s: {"a": s["a"] + x, "n": s["n"] + 1}  # noqa: E731
        ys, v = tsem.partitioned(
            f, ns, lambda x: x % 4, T(xs),
            {"a": torch.zeros(4, dtype=torch.int32),
             "n": torch.zeros(4, dtype=torch.int32)})
        jys, jv = jsem.partitioned(
            f, ns, lambda x: x % 4, jnp.asarray(xs),
            {"a": jnp.zeros(4, jnp.int32), "n": jnp.zeros(4, jnp.int32)})
        equal(ys, jys)
        equal(v, jv)
        assert v["n"].tolist() == [4, 4, 4, 4]

    @given(seeds, lengths)
    @settings(max_examples=8, deadline=None)
    def test_accumulator(self, seed, m):
        xs = stream(seed, m)
        args = (lambda x, s: x - s, lambda x: x * x, lambda a, b: a + b)
        ys, s = tsem.accumulator(*args, T(xs),
                                 torch.tensor(0, dtype=torch.int32))
        jys, js = jsem.accumulator(*args, jnp.asarray(xs), jnp.int32(0))
        equal(ys, jys)
        equal(s, js)

    @given(seeds, lengths)
    @settings(max_examples=8, deadline=None)
    def test_successive_approximation_float_and_int(self, seed, m):
        rng = np.random.default_rng(seed)
        xs = rng.random(m).astype(np.float32)
        tr, s = tsem.successive_approximation(
            lambda x, s: x < s, lambda x, s: torch.minimum(x, s), T(xs),
            torch.tensor(np.inf, dtype=torch.float32))
        jtr, js = jsem.successive_approximation(
            lambda x, s: x < s, lambda x, s: jnp.minimum(x, s),
            jnp.asarray(xs), jnp.float32(np.inf))
        equal(tr, jtr)
        equal(s, js)
        ints = stream(seed, m)
        tr, s = tsem.successive_approximation(
            lambda x, s: x > s, lambda x, s: x, T(ints),
            torch.tensor(-5, dtype=torch.int32))
        jtr, js = jsem.successive_approximation(
            lambda x, s: x > s, lambda x, s: x, jnp.asarray(ints),
            jnp.int32(-5))
        equal(tr, jtr)
        equal(s, js)

    def test_non_monotone_updates_discarded(self):
        tr, s = tsem.successive_approximation(
            lambda x, s: x < s, lambda x, s: x,
            torch.tensor([5.0, 9.0, 3.0, 7.0]), torch.tensor(6.0))
        assert tr.tolist() == [5.0, 5.0, 3.0, 3.0] and float(s) == 3.0

    @given(seeds, lengths)
    @settings(max_examples=8, deadline=None)
    def test_separate_task_state(self, seed, m):
        xs = stream(seed, m)
        ys, tr, s = tsem.separate_task_state(
            lambda x: x * x - x // 3, lambda y, st: st * 31 + y, T(xs),
            torch.tensor(1, dtype=torch.int32))
        jys, jtr, js = jsem.separate_task_state(
            lambda x: x * x - x // 3, lambda y, st: st * 31 + y,
            jnp.asarray(xs), jnp.int32(1))
        equal(ys, jys)
        equal(tr, jtr)
        equal(s, js)

    @pytest.mark.parametrize("kind,kw", [
        ("tumbling", dict(size=10)),
        ("sliding", dict(size=12, slide=4)),
        ("session", dict(gap=5)),
    ])
    @pytest.mark.parametrize("early_every", [0, 2])
    def test_keyed_windows(self, kind, kw, early_every):
        rng = np.random.default_rng(11)
        n = 300
        ts = np.arange(n) // 3 + rng.integers(-6, 7, n)  # bounded disorder
        items = list(zip(rng.integers(0, 7, n), rng.integers(-50, 50, n), ts))
        common = dict(watermark_every=16, lateness=2, late_policy="side",
                      early_every=early_every, **kw)
        got = tsem.keyed_windows(kind, items, **common)
        want = jsem.keyed_windows(kind, items, **common)
        assert got == want
        assert len(got[2]) > 0  # late items reached the side output
        with pytest.raises(ValueError, match="unknown window kind"):
            tsem.keyed_windows("hopping", items)


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args,kw", [
    ("simulate_serial", (100, 2.0, 1.0), dict(t_a=0.5)),
    ("simulate_partitioned", (1024, 8, 1.0, 0.5), dict(t_a=0.01)),
    ("simulate_partitioned", (4096, 8, 1.0, 0.0), dict(skew=1.5, seed=1)),
    ("simulate_accumulator", (2000, 8, 4.0, 1.0),
     dict(flush_every=4, t_a=0.1, t_comm=0.05)),
    ("simulate_accumulator", (500, 16, 1.0, 2.0), dict(flush_every=1)),
    ("simulate_successive_approximation", (3000, 8, 1.0, 5.0),
     dict(feedback_latency=3.0, seed=7)),
    ("simulate_successive_approximation", (1000, 4, 2.0, 1.0),
     dict(t_a=0.3, seed=2)),
    ("simulate_separate_task_state", (1000, 8, 10.0, 1.0),
     dict(t_a=0.2, t_comm=0.1)),
])
def test_simulator_equals_reference(name, args, kw):
    got = getattr(tsim, name)(*args, **kw)
    want = getattr(jsim, name)(*args, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.throughput == want.throughput


# ---------------------------------------------------------------------------
# ownership and adaptivity math
# ---------------------------------------------------------------------------

def _same_outcome(fn_t, fn_j):
    """Both return equal values, or both raise ValueError with one message."""
    try:
        want = fn_j()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_t()
        assert str(got.value) == str(e)
        return False
    got = fn_t()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype
    return True


@pytest.mark.parametrize("ownership", ["block", "slotmap"])
@pytest.mark.parametrize("num_slots", [1, 12, 16, 18])
def test_ownership_math(ownership, num_slots):
    kw = dict(f=None, ns=None, h=None, num_slots=num_slots,
              ownership=ownership)
    t, j = tpat.PartitionedState(**kw), jpat.PartitionedState(**kw)
    for n in range(0, 21):
        _same_outcome(lambda: t.owner_table(n), lambda: j.owner_table(n))
        _same_outcome(lambda: t.slots_per_worker(n),
                      lambda: j.slots_per_worker(n))
        if _same_outcome(lambda: t.validate_degree(n) or 0,
                         lambda: j.validate_degree(n) or 0):
            for slot in range(num_slots):
                assert t.owner(slot, n) == j.owner(slot, n)
        for n_new in range(1, 21):
            _same_outcome(lambda: t.transition_volume(n, n_new),
                          lambda: j.transition_volume(n, n_new))
            _same_outcome(
                lambda: tpat.PartitionedState.handoff_volume(num_slots, n,
                                                             n_new),
                lambda: jpat.PartitionedState.handoff_volume(num_slots, n,
                                                             n_new))
    assert t.feasible_degrees(24) == j.feasible_degrees(24)
    with pytest.raises(ValueError, match="unknown ownership"):
        tpat.PartitionedState(f=None, ns=None, h=None, num_slots=4,
                              ownership="hash")


def test_adaptivity_helpers():
    acc = tpat.AccumulatorState(f=None, g=None, combine=lambda a, b: a + b,
                                zero=lambda: torch.tensor(0))
    assert int(acc.merge_workers(torch.tensor(5), torch.tensor(7))) == 12
    assert int(acc.new_worker_state()) == 0
    sa = tpat.SuccessiveApproximationState(c=None, s_prime=None)
    tree = {"best": torch.tensor(0.5), "arg": torch.tensor(7)}
    assert sa.new_worker_state(tree) is tree
    assert tpat.SeparateTaskState.speedup_bound(100.0, 1.0) == 101.0
    v = torch.arange(6)
    assert tpat.PartitionedState.reshard(v, 2, 3) is v


# ---------------------------------------------------------------------------
# run: one worker against the reference's run on a one-device mesh
# ---------------------------------------------------------------------------

I32 = dict(dtype=torch.int32)


def _s2(num_slots, ownership, pkg):
    if pkg == "jax":
        return jpat.PartitionedState(
            f=lambda x, s: x * 2 + s, ns=lambda x, s: s + x,
            h=lambda x: (x.astype(jnp.int32) * 7) % num_slots,
            num_slots=num_slots, ownership=ownership)
    return tpat.PartitionedState(
        f=lambda x, s: x * 2 + s, ns=lambda x, s: s + x,
        h=lambda x: (x.to(torch.int32) * 7) % num_slots,
        num_slots=num_slots, ownership=ownership)


def _s3(pkg, f=lambda x, view: x + view):
    if pkg == "jax":
        return jpat.AccumulatorState(f=f, g=lambda x: x,
                                     combine=lambda a, b: a + b,
                                     zero=lambda: jnp.int32(0))
    return tpat.AccumulatorState(f=f, g=lambda x: x,
                                 combine=lambda a, b: a + b,
                                 zero=lambda: torch.tensor(0, **I32))


def _s4(pkg):
    if pkg == "jax":
        return jpat.SuccessiveApproximationState(
            c=lambda x, s: x < s, s_prime=lambda x, s: jnp.minimum(x, s))
    return tpat.SuccessiveApproximationState(
        c=lambda x, s: x < s, s_prime=lambda x, s: torch.minimum(x, s))


def _s5(pkg):
    cls = jpat.SeparateTaskState if pkg == "jax" else tpat.SeparateTaskState
    return cls(f=lambda x: x * x, s=lambda y, s: s * 31 + y)


class TestRunOneWorker:
    def test_serial(self):
        xs = stream(3, 40)
        t = tpat.SerialState(f=lambda x, s: x - s, ns=lambda x, s: s + 2 * x)
        j = jpat.SerialState(f=lambda x, s: x - s, ns=lambda x, s: s + 2 * x)
        ys, s = t.run(cpu_mesh(1), "workers", xs, np.int32(0))
        jys, js = j.run(jax_mesh1(), "workers", jnp.asarray(xs), jnp.int32(0))
        equal(ys, jys)
        equal(s, js)

    @pytest.mark.parametrize("ownership", ["block", "slotmap"])
    def test_partitioned(self, ownership):
        xs = stream(4, 48, 0, 1000)
        v0 = np.arange(16, dtype=np.int32)
        ys, v = _s2(16, ownership, "torch").run(cpu_mesh(1), "workers",
                                                T(xs), T(v0))
        jys, jv = _s2(16, ownership, "jax").run(jax_mesh1(), "workers",
                                                jnp.asarray(xs),
                                                jnp.asarray(v0))
        equal(ys, jys)
        equal(v, jv)

    @pytest.mark.parametrize("flush_every", [1, 4, 16])
    def test_accumulator(self, flush_every):
        xs = stream(5, 32)
        ys, s = _s3("torch").run(cpu_mesh(1), "workers", T(xs),
                                 flush_every=flush_every,
                                 s0=torch.tensor(9, **I32))
        jys, js = _s3("jax").run(jax_mesh1(), "workers", jnp.asarray(xs),
                                 flush_every=flush_every, s0=jnp.int32(9))
        equal(ys, jys)
        equal(s, js)

    @pytest.mark.parametrize("sync_every", [1, 8])
    def test_successive(self, sync_every):
        xs = np.random.default_rng(6).random(32).astype(np.float32)
        tr, s = _s4("torch").run(cpu_mesh(1), "workers", T(xs),
                                 np.float32(np.inf), sync_every=sync_every)
        jtr, js = _s4("jax").run(jax_mesh1(), "workers", jnp.asarray(xs),
                                 jnp.float32(np.inf), sync_every=sync_every)
        equal(tr, jtr)
        equal(s, js)

    def test_separate(self):
        xs = stream(7, 24)
        out = _s5("torch").run(cpu_mesh(1), "workers", T(xs),
                               torch.tensor(1, **I32))
        jout = _s5("jax").run(jax_mesh1(), "workers", jnp.asarray(xs),
                              jnp.int32(1))
        equal(out, jout)


# ---------------------------------------------------------------------------
# run at 2, 4 and 8 workers against the JAX oracle (tests/spmd_checks.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_w", [2, 4, 8])
class TestRunManyWorkers:
    @pytest.mark.parametrize("ownership", ["block", "slotmap"])
    def test_partitioned(self, n_w, ownership):
        xs = np.arange(64, dtype=np.int32)
        v0 = T(np.zeros(16, np.int32))
        ys, v = _s2(16, ownership, "torch").run(cpu_mesh(n_w), "workers",
                                                T(xs), v0)
        jys, jv = _s2(16, ownership, "jax").reference(jnp.asarray(xs),
                                                      jnp.zeros(16, jnp.int32))
        equal(ys, jys)
        equal(v, jv)
        assert int(v0.abs().sum()) == 0

    def test_slotmap_any_degree(self, n_w):
        # degrees that do not divide 18 run in slotmap mode
        n = n_w + 1
        xs = stream(8, 20 * n, 0, 500)
        ys, v = _s2(18, "slotmap", "torch").run(cpu_mesh(n), "workers",
                                                T(xs), T(np.zeros(18, np.int32)))
        jys, jv = _s2(18, "slotmap", "jax").reference(
            jnp.asarray(xs), jnp.zeros(18, jnp.int32))
        equal(ys, jys)
        equal(v, jv)

    @pytest.mark.parametrize("flush_every", [1, 2, 4, 8])
    def test_accumulator_final_state_exact(self, n_w, flush_every):
        xs = np.arange(1, 65, dtype=np.int32)
        _, s = _s3("torch").run(cpu_mesh(n_w), "workers", T(xs),
                                flush_every=flush_every)
        _, js = _s3("jax").reference(jnp.asarray(xs))
        equal(s, js)

    def test_accumulator_float_sum(self, n_w):
        xs = np.random.default_rng(9).standard_normal(64).astype(np.float32)
        pat = tpat.AccumulatorState(f=lambda x, v: v, g=lambda x: x,
                                    combine=lambda a, b: a + b,
                                    zero=lambda: torch.tensor(0.0))
        _, s = pat.run(cpu_mesh(n_w), "workers", T(xs), flush_every=4)
        _, js = jsem.accumulator(lambda x, v: v, lambda x: x,
                                 lambda a, b: a + b, jnp.asarray(xs),
                                 jnp.float32(0))
        np.testing.assert_allclose(float(s), float(js), **F32)

    @pytest.mark.parametrize("sync_every", [1, 2, 8])
    def test_successive(self, n_w, sync_every):
        xs = np.random.default_rng(0).random(64).astype(np.float32)
        tr, s = _s4("torch").run(cpu_mesh(n_w), "workers", T(xs),
                                 torch.tensor(np.inf), sync_every=sync_every)
        _, js = _s4("jax").reference(jnp.asarray(xs), jnp.float32(np.inf))
        equal(s, js)  # min is exact
        # local traces are monotone non-increasing per worker
        assert (np.diff(tr.numpy().reshape(n_w, -1), axis=1) <= 0).all()

    def test_successive_max_direction(self, n_w):
        xs = stream(n_w, 16 * n_w)
        pat = tpat.SuccessiveApproximationState(
            c=lambda x, s: x > s, s_prime=lambda x, s: torch.maximum(x, s),
            direction="max")
        tr, s = pat.run(cpu_mesh(n_w), "workers", T(xs),
                        torch.tensor(-2000, **I32), sync_every=4)
        _, js = jsem.successive_approximation(
            lambda x, s: x > s, lambda x, s: jnp.maximum(x, s),
            jnp.asarray(xs), jnp.int32(-2000))
        equal(s, js)  # max is exact: the pmax commit
        assert (np.diff(tr.numpy().reshape(n_w, -1), axis=1) >= 0).all()

    def test_separate(self, n_w):
        xs = np.arange(32, dtype=np.int32)
        out = _s5("torch").run(cpu_mesh(n_w), "workers", T(xs),
                               torch.tensor(1, **I32))
        jout = _s5("jax").reference(jnp.asarray(xs), jnp.int32(1))
        equal(out, jout)

    def test_pytree_state(self, n_w):
        xs = np.arange(8 * n_w, dtype=np.int32)
        f = lambda x, s: s["a"] * 2 + x  # noqa: E731
        ns = lambda x, s: {"a": s["a"] + x, "n": s["n"] + 1}  # noqa: E731
        pat = tpat.PartitionedState(f=f, ns=ns, h=lambda x: x % 8,
                                    num_slots=8)
        ys, v = pat.run(cpu_mesh(n_w), "workers", T(xs),
                        {"a": torch.zeros(8, **I32),
                         "n": torch.zeros(8, **I32)})
        jys, jv = jsem.partitioned(f, ns, lambda x: x % 8, jnp.asarray(xs),
                                   {"a": jnp.zeros(8, jnp.int32),
                                    "n": jnp.zeros(8, jnp.int32)})
        equal(ys, jys)
        equal(v, jv)
        acc = tpat.AccumulatorState(
            f=lambda x, v: v[0] - x, g=lambda x: (x, x * x),
            combine=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            zero=lambda: (torch.tensor(0, **I32), torch.tensor(0, **I32)))
        _, s = acc.run(cpu_mesh(n_w), "workers", T(xs), flush_every=2)
        equal(s, (np.int32(xs.sum()), np.int32((xs * xs).sum())))


def test_farm_map_and_pipeline():
    xs = np.arange(64, dtype=np.float32)
    farm = tfarm.TaskFarm(cpu_mesh(8), "workers")
    assert farm.n_workers == 8
    np.testing.assert_allclose(farm.map(lambda x: x * 3.0, T(xs)).numpy(),
                               xs * 3.0)
    tot = farm.map(lambda x: x, T(xs),
                   collector=lambda y, mesh: psum(y.sum(1)))
    assert float(tot) == float(xs.sum())
    jys = jfarm.TaskFarm(jax_mesh1(), "workers").map(lambda x: x * 3.0,
                                                     jnp.asarray(xs))
    equal(tfarm.TaskFarm(cpu_mesh(1), "workers").map(lambda x: x * 3.0,
                                                     T(xs)), jys)
    stages = [lambda x: x * 2 + 1, lambda x: x - 3]
    got = tfarm.pipeline_stages(stages, T(xs), num_microbatches=4)
    want = jfarm.pipeline_stages(stages, jnp.asarray(xs), num_microbatches=4)
    equal(got, want)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def test_executor_step_cache_tail_and_errors():
    pat = tpat.SeparateTaskState(f=lambda x: x + 1, s=lambda y, s: s + y)
    ex = StreamExecutor(SeparateAdapter(pat, np.int32(0)), degree=2,
                        chunk_size=16, mesh_factory=CPU_MESH)
    xs = np.arange(16, dtype=np.int32)
    ex.process(xs)
    step2 = ex._steps[2]
    ex.set_degree(4, reason="test")
    ex.process(xs)
    ex.set_degree(2, reason="test")
    assert ex._steps[2] is step2  # cached per degree
    ex.process(xs)
    assert ex.compiled_degrees == [2, 4]
    assert isinstance(ex.state, torch.Tensor) and ex.state.device.type == "cpu"
    assert int(ex.state) == 3 * int((xs + 1).sum())
    out = ex.process(xs[:6])  # tail chunk: the largest degree dividing 6
    assert ex.degree == 2 and out["ys"].tolist() == (xs[:6] + 1).tolist()
    acc = StreamExecutor(AccumulatorAdapter(_s3("torch"), flush_every=4),
                         degree=2, chunk_size=16, mesh_factory=CPU_MESH)
    with pytest.raises(ValueError, match="granularity 4"):
        acc.set_degree(8)
    with pytest.raises(ValueError, match="flush_every must divide"):
        _s3("torch").run(cpu_mesh(2), "workers", T(xs), flush_every=3)
    with pytest.raises(ValueError, match="sync_every must divide"):
        _s4("torch").run(cpu_mesh(2), "workers", T(xs.astype(np.float32)),
                         np.float32(1), sync_every=3)
    s2 = StreamExecutor(PartitionedAdapter(_s2(16, "block", "torch"),
                                           np.zeros(16, np.int32)),
                        degree=2, chunk_size=48, mesh_factory=CPU_MESH,
                        max_degree=4)
    with pytest.raises(ValueError, match="does not divide"):
        s2.set_degree(3)
    with pytest.raises(ValueError, match="exceeds max_degree"):
        s2.set_degree(8)
    assert s2.feasible_degrees([1, 2, 3, 4, 5, 8]) == [1, 2, 4, 8]


def test_device_rule():
    """``device=None`` is the card: without one, the mesh and an SPMD
    executor raise instead of running on the host."""
    sa = SuccessiveAdapter(_s4("torch"), np.float32(1.0), sync_every=1)
    if torch.cuda.is_available():
        assert WorkerMesh(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkerMesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamExecutor(sa, degree=2, chunk_size=8)
    assert WorkerMesh(2, device="cpu").shape == {"workers": 2}
