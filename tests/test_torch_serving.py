"""The port's serving engine against the JAX package's, token for token.

Both engines get the same weights (the reference's, carried over with
``params_from_reference``), the same requests and the same tick schedule,
including a resize in the middle of the run; every request's generated
tokens and the engines' ``resize_events`` must be identical.  Float32
models on the CPU, where the port runs the plain kernel versions: reduced
Gemma2 and paper-synthetic (attention), Mamba2 (recurrent state, prompts
of at least 5 tokens, whose prefill the reference computes right) and
DeepSeekMoE (a dense layer, then MoE layers).  Several requests are
admitted in one tick, one after another through the reused one-slot
prefill cache.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as JT
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference
from repro_torch.models import transformer as TT
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import Request, ServingEngine

S_MAX = 64
#: prompt lengths (few distinct ones: each is one compile of the reference)
LENGTHS = (5, 17, 40, 17, 5, 17, 40)


@pytest.fixture(scope="module", params=["gemma2-27b", "paper-synthetic",
                                        "mamba2-780m", "deepseek-moe-16b"])
def model(request):
    name = request.param
    jcfg = jconfigs.get(name)
    tcfg = tconfigs.get(name)
    if name != "paper-synthetic":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1)))
    return jcfg, tree, tcfg, params_from_reference(tree, tcfg, device="cpu")


def _requests(cls, vocab, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for rid, n in enumerate(LENGTHS):
        prompt = rng.integers(0, vocab, n).astype(np.int32)
        # the last request runs into s_max and is evicted at s_max - 1
        new = 40 if rid == len(LENGTHS) - 1 else int(rng.integers(3, 7))
        out.append(cls(rid=rid, prompt=prompt, max_new_tokens=new))
    return out


def _drive(engine, reqs, resize_at, new_slots):
    for r in reqs:
        engine.submit(r)
    for _ in range(resize_at):
        engine.step()
    engine.resize(new_slots)
    engine.run_to_completion()
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("policy,slots,resize_at,new_slots", [
    ("ondemand", 3, 4, 2),
    ("hash", 4, 3, 3),
])
def test_engine_equals_reference_engine(model, policy, slots, resize_at,
                                        new_slots):
    """Both policies, a shrink mid-run that relocates and requeues
    sessions, prompts of 5-40 tokens across the reduced model's window,
    and one session evicted at s_max - 1."""
    jcfg, tree, tcfg, params = model
    jeng = JEngine(jcfg, tree, num_slots=slots, s_max=S_MAX, policy=policy)
    teng = ServingEngine(tcfg, params, num_slots=slots, s_max=S_MAX,
                         policy=policy, device="cpu")
    want = _drive(jeng, _requests(JRequest, jcfg.vocab_size), resize_at,
                  new_slots)
    got = _drive(teng, _requests(Request, tcfg.vocab_size), resize_at,
                 new_slots)
    assert got == want
    assert teng.resize_events == jeng.resize_events
    assert teng.tokens_out == jeng.tokens_out
    assert teng.steps == jeng.steps
    assert teng.resize_events[0]["requeued"] >= 1
    # evicted at s_max - 1: the prefill's token and one per decode step
    assert len(got[-1]) == S_MAX - LENGTHS[-1]


def test_continuous_batching_equals_sequential(model):
    """Each request alone (prefill + decode, one slot) gives the tokens it
    got while sharing the batch; the logits kept per request are those the
    last token was taken from."""
    _, _, tcfg, params = model
    reqs = _requests(Request, tcfg.vocab_size, seed=3)[:4]
    eng = ServingEngine(tcfg, params, num_slots=3, s_max=S_MAX,
                        device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    for r in reqs:
        caches = TT.init_caches(tcfg, 1, S_MAX, device="cpu")
        logits, caches = TT.prefill_forward(
            params, {"tokens": torch.as_tensor(r.prompt).long()[None]}, tcfg,
            caches)
        out = [int(logits[0, -1].argmax())]
        for pos in range(len(r.prompt), len(r.prompt) + r.max_new_tokens - 1):
            logits, caches = TT.decode_forward(
                params, {"tokens": torch.tensor([[out[-1]]])}, tcfg, caches,
                torch.tensor([pos], dtype=torch.int32))
            out.append(int(logits[0, -1].argmax()))
        assert r.generated == out
        assert int(r.logits.argmax()) == out[-1]
        torch.testing.assert_close(r.logits, logits[0, -1], atol=1e-5,
                                   rtol=1e-5)


def test_each_prefill_starts_from_a_zero_state(model):
    """Requests that finish at their prefill keep its logits: admitted one
    after another through the reused one-slot cache, each must equal a
    prefill into a fresh cache (a Mamba layer's conv history of the
    previous prompt would move the first positions, and through the state
    the last one)."""
    _, _, tcfg, params = model
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=1)
            for i, n in enumerate((9, 5, 6))]
    eng = ServingEngine(tcfg, params, num_slots=2, s_max=S_MAX, device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert all(r.done for r in reqs) and eng.steps == 0
    for r in reqs:
        caches = TT.init_caches(tcfg, 1, S_MAX, device="cpu")
        logits, _ = TT.prefill_forward(
            params, {"tokens": torch.as_tensor(r.prompt).long()[None]}, tcfg,
            caches)
        torch.testing.assert_close(r.logits, logits[0, -1], atol=1e-6,
                                   rtol=1e-6)


def test_observability_and_bad_arguments(model):
    _, _, tcfg, params = model
    tracer, registry = Tracer(recorder=None), MetricsRegistry()
    eng = ServingEngine(tcfg, params, num_slots=2, s_max=S_MAX,
                        device="cpu", tracer=tracer, registry=registry)
    for r in _requests(Request, tcfg.vocab_size)[:3]:
        eng.submit(r)
    eng.step()
    eng.resize(3)
    eng.run_to_completion()
    names = tracer.total_by_name()
    assert {"prefill", "decode", "resize"} <= set(names)
    assert names["prefill"][0] == 3
    hist = registry.snapshot()["histograms"]
    assert hist["serving.decode_step_s"]["count"] == eng.steps
    with pytest.raises(ValueError):
        eng.resize(0)
    with pytest.raises(ValueError):
        ServingEngine(tcfg, params, num_slots=2, s_max=S_MAX, policy="lru",
                      device="cpu")


def test_engine_needs_a_card_unless_told_cpu(model):
    """``device=None`` means the CUDA card: without one the engine (and
    every other entry point) raises instead of running on the CPU."""
    _, _, tcfg, params = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tcfg, params, num_slots=2, s_max=S_MAX)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_caches(tcfg, 1, 8)

