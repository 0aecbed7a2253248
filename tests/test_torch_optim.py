"""The port's optimizer and token stream against the JAX package, on the
CPU.

* ``schedule``: WSD, cosine and constant at step 0, 1, in the warm-up, at
  its end, in the stable phase and in the decay, equal to the reference's
  within float32 rounding (``SCHED_REL``: the two frameworks' ``cos`` and
  divisions may round the last bit apart).
* ``global_norm`` and ``apply_updates`` on random float32 trees, with the
  clip engaged and not, several steps: the new parameters, ``m``, ``v``
  and ``step`` against the reference's.  Both do the same float32
  operations in the same order per element; the tolerance covers the
  global norm's sum, taken over the leaves in another order, which moves
  the clip scale by an ulp.
* ``SyntheticLM.batch_at``: tokens and labels bit-identical to the
  reference's for microbatches 1 and 2 at several positions and seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro_torch.data.pipeline import StreamState, SyntheticLM
from repro_torch.optim import adamw

SCHED_REL = 1e-6
UPDATE = dict(rtol=2e-6, atol=1e-7)


def _cfgs():
    base = dict(peak_lr=1e-2, warmup_steps=10, total_steps=100,
                decay_frac=0.2)
    return [(kind, dict(base, schedule=kind))
            for kind in ("wsd", "cosine", "constant")]


@pytest.mark.parametrize("kind,kw", _cfgs())
def test_schedule_matches_reference(kind, kw):
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    # 0, 1, warm-up, its end, stable, the decay's start, in it, the end, past
    for step in (0, 1, 5, 10, 50, 80, 90, 100, 120):
        want = float(jadamw.schedule(jcfg, jnp.int32(step)))
        got = adamw.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=SCHED_REL, abs=1e-12)
        assert float(adamw.schedule(tcfg, step)) == float(got)
    assert float(adamw.schedule(tcfg, 0)) == 0.0
    if kind == "wsd":
        assert float(adamw.schedule(tcfg, 50)) == pytest.approx(1e-2)
        assert float(adamw.schedule(tcfg, 100)) == pytest.approx(1e-3)


def _tree(rng, scale):
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip off / engaged
def test_apply_updates_matches_reference(grad_scale):
    rng = np.random.default_rng(7)
    params = _tree(rng, 1.0)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20, schedule="wsd",
              clip_norm=1.0)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadamw.init_state(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    tstate = adamw.init_state(tp)
    for _ in range(4):
        grads = _tree(rng, grad_scale)
        jn = float(jadamw.global_norm({k: jnp.asarray(v)
                                       for k, v in grads.items()}))
        tn = float(adamw.global_norm({k: torch.as_tensor(v)
                                      for k, v in grads.items()}))
        assert tn == pytest.approx(jn, rel=1e-6)
        assert (jn > kw["clip_norm"]) == (grad_scale > 1)
        jp, jstate, jm = jadamw.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jcfg)
        tp, tstate, tm = adamw.apply_updates(
            tp, {k: torch.as_tensor(v) for k, v in grads.items()}, tstate,
            tcfg)
        assert int(tstate["step"]) == int(jstate["step"])
        assert tstate["step"].dtype == torch.int32
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k], np.asarray(jp[k]), **UPDATE)
            for key in ("m", "v"):
                np.testing.assert_allclose(tstate[key][k],
                                           np.asarray(jstate[key][k]),
                                           **UPDATE)


def test_apply_updates_keeps_bfloat16_parameters():
    """A bfloat16 parameter is updated in float32 and rounded back; the
    moments stay float32."""
    p = {"w": torch.linspace(-1, 1, 9).to(torch.bfloat16)}
    state = adamw.init_state(p)
    g = {"w": torch.linspace(1, 2, 9).to(torch.bfloat16)}
    before = p["w"].clone()
    adamw.apply_updates(p, g, state, adamw.AdamWConfig(
        peak_lr=0.1, warmup_steps=0, schedule="constant", weight_decay=0.0))
    assert p["w"].dtype == torch.bfloat16
    assert state["m"]["w"].dtype == torch.float32
    want = (before.float() - 0.1 * torch.ones(9)).to(torch.bfloat16)
    torch.testing.assert_close(p["w"], want, atol=0, rtol=0)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_synthetic_stream_tokens_bit_exact(microbatches):
    for seed in (0, 3):
        kw = dict(vocab=1000, seq_len=33, batch=3, microbatches=microbatches,
                  seed=seed)
        ref = JSyntheticLM(**kw)
        port = SyntheticLM(**kw, device="cpu")
        for pos in (0, 1, 7, 1234):
            want, got = ref.batch_at(pos), port.batch_at(pos)
            for key in ("tokens", "labels"):
                assert got[key].dtype == torch.int32
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(want[key]))
    state, batch = next(port.stream(StreamState(5)))
    assert state.position == 6
    assert StreamState.from_dict(state.to_dict()) == state
    np.testing.assert_array_equal(batch["tokens"], port.batch_at(5)["tokens"])
