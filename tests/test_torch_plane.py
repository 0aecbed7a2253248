"""The port's keyed plane end to end against the JAX package, on the CPU.

``StreamExecutor`` + ``KeyedWindowAdapter`` of both packages run the same
stream and degree schedule; emissions, early firings, late records and the
barrier snapshot must be bit-identical (values and dtypes), and equal to
the serial oracle ``repro.core.semantics.keyed_windows``.  Covered:
tumbling, sliding and session windows, both backends, fused and loop, grow
and shrink at degrees that do not divide the slot count, forced spill +
TTL, early firing, the chunk pipeline, the snapshot-per-chunk path, and the
state carry-over (a JAX snapshot continued by the port and back).  Plus
import hygiene and the device rule.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import semantics
from repro.keyed import KeyedWindowAdapter as JAdapter
from repro.keyed import WindowSpec as JSpec
from repro.keyed import synthetic_keyed_items
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.runtime import StreamExecutor as JExecutor
from repro_torch.interop import state_from_reference, state_to_reference
from repro_torch.keyed import KeyedWindowAdapter as TAdapter
from repro_torch.keyed import WindowSpec as TSpec
from repro_torch.obs import MetricsRegistry as TRegistry
from repro_torch.runtime import StreamExecutor as TExecutor

NUM_SLOTS = 20  # degrees 3, 6, 7 do not divide this
CHUNK = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = dict(capacity=16, max_probes=2, ttl=4)  # forces spill and eviction


def _spec(kind, pkg, early_every=3):
    S = JSpec if pkg == "jax" else TSpec
    if kind == "tumbling":
        return S("tumbling", size=7, lateness=3, late_policy="side",
                 early_every=early_every)
    if kind == "sliding":
        return S("sliding", size=9, slide=4, lateness=3, late_policy="side",
                 early_every=early_every)
    return S("session", gap=5, lateness=3, late_policy="side",
             early_every=early_every)


def _adapter(pkg, kind, backend, fused=True, **kw):
    args = dict(num_slots=NUM_SLOTS, impl=kw.pop("impl", "segment"),
                backend=backend, fused=fused,
                **(TABLE if backend == "device_table" else {}), **kw)
    if pkg == "jax":
        return JAdapter(_spec(kind, pkg), **args)
    return TAdapter(_spec(kind, pkg), device="cpu", **args)


def _chunks(items):
    return [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]


def _run(pkg, kind, backend, items, degrees, fused=True, pipeline=False,
         **kw):
    ad = _adapter(pkg, kind, backend, fused, **kw)
    E = JExecutor if pkg == "jax" else TExecutor
    ex = E(ad, degree=degrees[0], chunk_size=CHUNK, pipeline=pipeline)
    outs = ex.run(_chunks(items), schedule={3: degrees[1], 6: degrees[0]})
    return outs, ex.state, ex


def _assert_outputs_equal(a_outs, b_outs):
    assert len(a_outs) == len(b_outs)
    for a, b in zip(a_outs, b_outs):
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


def _rows(d, cols=("key", "start", "end", "value", "count")):
    return [tuple(int(x) for x in r) for r in zip(*(d[k] for k in cols))]


def _assert_oracle(kind, items, outs, state):
    em, open_, late, early = semantics.keyed_windows(
        kind, [(int(r["key"]), int(r["value"]), int(r["ts"]))
               for r in items],
        **_spec(kind, "jax").oracle_kwargs(CHUNK),
    )
    assert [r for o in outs for r in _rows(o["emissions"])] == em
    assert [r for o in outs for r in _rows(o["early"])] == early
    assert [r for o in outs for r in _rows(
        o["late"], ("key", "value", "ts", "start"))] == late
    assert _rows(state, ("w_key", "w_start", "w_end", "w_value",
                         "w_count")) == [tuple(x) for x in open_]


# ---------------------------------------------------------------------------
# the slice, bit-exact against the reference
# ---------------------------------------------------------------------------

class TestPlaneParity:
    @pytest.mark.parametrize("fused", [True, False])
    @pytest.mark.parametrize("backend", ["host", "device_table"])
    @pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
    def test_resized_run_matches_reference_and_oracle(self, kind, backend,
                                                      fused):
        """Grow 3->7 and shrink back, forced spill + TTL on the device
        table, early firing and late side output on every window kind."""
        items = synthetic_keyed_items(9 * CHUNK + 5, num_keys=9, disorder=7,
                                      seed=1)
        j_outs, j_state, _ = _run("jax", kind, backend, items, (3, 7), fused)
        t_outs, t_state, _ = _run("torch", kind, backend, items, (3, 7),
                                  fused)
        _assert_outputs_equal(j_outs, t_outs)
        _assert_states_equal(j_state, t_state)
        _assert_oracle(kind, items, t_outs, t_state)

    @settings(max_examples=5, deadline=None)
    @given(
        st.sampled_from(["tumbling", "sliding", "session"]),
        st.integers(0, 10_000),
        st.integers(0, 10),
        st.sampled_from([(2, 5), (6, 4), (7, 3)]),
    )
    def test_property_random_streams_and_resizes(self, kind, seed, disorder,
                                                 degrees):
        items = synthetic_keyed_items(8 * CHUNK + 3, num_keys=7,
                                      disorder=disorder, seed=seed)
        for backend in ("host", "device_table"):
            j_outs, j_state, _ = _run("jax", kind, backend, items, degrees)
            t_outs, t_state, _ = _run("torch", kind, backend, items, degrees)
            _assert_outputs_equal(j_outs, t_outs)
            _assert_states_equal(j_state, t_state)

    def test_masked_impl_pipeline_and_health(self):
        """The masked reduce, the chunk pipeline and the exported health
        gauges / counters agree with the reference."""
        items = synthetic_keyed_items(8 * CHUNK, num_keys=11, disorder=4,
                                      seed=5)
        j_outs, j_state, j_ex = _run("jax", "sliding", "device_table",
                                     items, (2, 6), impl="masked",
                                     pipeline=True)
        t_outs, t_state, t_ex = _run("torch", "sliding", "device_table",
                                     items, (2, 6), impl="masked",
                                     pipeline=True)
        _assert_outputs_equal(j_outs, t_outs)
        _assert_states_equal(j_state, t_state)
        jr, tr = JRegistry(), TRegistry()
        j_ex.adapter.export_health(jr)
        t_ex.adapter.export_health(tr)
        assert tr.snapshot() == jr.snapshot()
        assert t_ex.metrics.migration_volume() == j_ex.metrics.migration_volume()

    def test_column_dict_chunks(self):
        """Chunks given as dicts of columns (not record arrays) run the
        same plane; the executor counts items, not dict keys."""
        items = synthetic_keyed_items(5 * CHUNK, num_keys=8, disorder=3,
                                      seed=6)
        cols = [{k: c[k].copy() for k in ("key", "value", "ts")}
                for c in _chunks(items)]
        outs = {}
        for pkg, E in (("jax", JExecutor), ("torch", TExecutor)):
            ex = E(_adapter(pkg, "sliding", "device_table"), degree=3,
                   chunk_size=CHUNK)
            outs[pkg] = (ex.run(cols), ex.state)
        _assert_outputs_equal(outs["jax"][0], outs["torch"][0])
        _assert_states_equal(outs["jax"][1], outs["torch"][1])

    def test_snapshot_per_chunk_path(self):
        items = synthetic_keyed_items(6 * CHUNK, num_keys=8, disorder=3,
                                      seed=2)
        j_outs, j_state, _ = _run("jax", "tumbling", "device_table", items,
                                  (3, 4), live=False)
        t_outs, t_state, _ = _run("torch", "tumbling", "device_table",
                                  items, (3, 4), live=False)
        _assert_outputs_equal(j_outs, t_outs)
        _assert_states_equal(j_state, t_state)


# ---------------------------------------------------------------------------
# state carry-over
# ---------------------------------------------------------------------------

class TestCarryOver:
    @pytest.mark.parametrize("backend", ["host", "device_table"])
    @pytest.mark.parametrize("kind", ["sliding", "session"])
    def test_reference_snapshot_continues_in_the_port(self, kind, backend):
        """A JAX run is cut at chunk 4; its snapshot goes through
        ``state_from_reference`` into a port executor, which must continue
        (with a grow to a non-divisor degree) exactly as a JAX executor
        restored from the same snapshot does; the port's state then goes
        back through ``state_to_reference`` and a JAX executor continues
        it exactly as the port does.  (A restore re-places table rows in
        canonical order, so continuations are compared restore against
        restore: placement counters of a live run may differ.)"""
        items = synthetic_keyed_items(10 * CHUNK, num_keys=9, disorder=5,
                                      seed=4)
        chunks = _chunks(items)

        def restored(pkg, state, degree):
            E = JExecutor if pkg == "jax" else TExecutor
            ex = E(_adapter(pkg, kind, backend), degree=degree,
                   chunk_size=CHUNK)
            ex.state = state
            return ex

        j_ex = JExecutor(_adapter("jax", kind, backend), degree=3,
                         chunk_size=CHUNK)
        head = j_ex.run(chunks[:4])
        snap = j_ex.snapshot_barrier()
        j_cont = restored("jax", snap, 3)
        t_cont = restored("torch", state_from_reference(snap), 3)
        mid = j_cont.run(chunks[4:8], schedule={1: 6})
        _assert_outputs_equal(mid, t_cont.run(chunks[4:8], schedule={1: 6}))
        _assert_states_equal(j_cont.state, t_cont.state)

        t_state = t_cont.state
        back = restored("jax", state_to_reference(t_state), 6)
        t_again = restored("torch", t_state, 6)
        tail = back.run(chunks[8:])
        _assert_outputs_equal(tail, t_again.run(chunks[8:]))
        _assert_states_equal(back.state, t_again.state)
        _assert_oracle(kind, items, head + mid + tail, t_again.state)

    def test_carry_over_rejects_incomplete_snapshots(self):
        with pytest.raises(KeyError):
            state_from_reference({"w_key": np.zeros(0, np.int64)})


# ---------------------------------------------------------------------------
# hygiene and the device rule
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module (the serving slice's models and engine
    included), and what chip_smoke.py imports, loads without pulling in JAX
    or the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "import repro_torch.models.transformer, repro_torch.serving\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules\n"
        "                    if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_device_rule():
    """``device=None`` means the card: without one it raises instead of
    running on the CPU."""
    from repro_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        TAdapter(_spec("tumbling", "torch"), num_slots=4)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (this host) or without the package beside it, the
    smoke script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
