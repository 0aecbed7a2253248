"""The five decoder-only configurations of the twelfth slice against the JAX
package: CodeQwen1.5-7B, Granite-8B and MiniCPM-2B (dense), Kimi-K2 (a
dense first layer, then MoE with 384 routed experts, a shared expert and
an aux-loss-free router bias) and Jamba-1.5-Large (Mamba-2 and attention
1:7, MoE every other layer).

Each runs at ``reduced()`` in float32 on the CPU, where the port takes the
kernels' plain versions: the reference's ``init_params`` carried over with
``params_from_reference``, two slots prefilled one at a time, then 6
decode steps at per-slot positions, logits held at ``atol = rtol = 1e-4``
as ``tests/test_torch_attention.py`` holds reduced Gemma2.  Jamba is held
at the scan's float32 tolerance, 2e-4: the port's plain scan runs in
chunks of 256 positions and the reduced configuration's (the reference's
chunked scan) in chunks of 16, so the scan's sums are taken in another
order.  Its prompts are at least 5 tokens (the reference's Mamba prefill
of 2-4 tokens reads only the first one).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference
from repro_torch.models import transformer as TT
from repro_torch.models.config import DENSE, FULL, MAMBA, MOE

from _torch_model_parity import (assert_round_trip, prefill_and_decode,
                                 reference_tree)

MODEL = 1e-4
#: the SSD scan's float32 tolerance, the reference's for its own kernel
SCAN = 2e-4
#: (architecture, tolerance, prompt lengths of the two slots)
FAMILIES = [
    ("codeqwen1.5-7b", MODEL, (7, 12)),
    ("granite-8b", MODEL, (9, 5)),
    ("minicpm-2b", MODEL, (6, 11)),
    ("kimi-k2-1t-a32b", MODEL, (10, 7)),
    ("jamba-1.5-large-398b", SCAN, (21, 6)),
]


@pytest.fixture(scope="module", params=[f[0] for f in FAMILIES])
def family(request):
    name = request.param
    tol, lengths = {f[0]: f[1:] for f in FAMILIES}[name]
    cfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    tree = reference_tree(cfg, 5, router_bias=cfg.moe is not None
                          and cfg.moe.router_bias)
    model = params_from_reference(tree, tcfg, device="cpu")
    return cfg, tree, tcfg, model, tol, lengths


def test_prefill_and_six_decode_steps(family):
    cfg, tree, tcfg, model, tol, lengths = family
    prefill_and_decode(cfg, tree, tcfg, model, seed=8, lengths=lengths,
                       steps=6, s_max=40, tol=tol)


def test_weights_round_trip(family):
    cfg, tree, tcfg, model, _, _ = family
    assert_round_trip(tree, model, tcfg)


@pytest.mark.parametrize("name", [f[0] for f in FAMILIES])
def test_same_fields_as_reference(name):
    for reduce in (False, True):
        jc, tc = jconfigs.get(name), tconfigs.get(name)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        specs = tuple(jc.prefix) + tuple(jc.unit) * jc.layout()[2]
        assert [dataclasses.astuple(s) for s in tc.layer_specs()] == \
            [dataclasses.astuple(s) for s in specs]


def test_kimi_router_bias_moves_the_choice():
    """The drawn bias is not a no-op: with it zeroed, some token of the
    reduced Kimi's prompts picks other experts, and the logits move."""
    name = "kimi-k2-1t-a32b"
    cfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    model = params_from_reference(reference_tree(cfg, 5, router_bias=True),
                                  tcfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12))).long()
    caches = TT.init_caches(tcfg, 2, 16, device="cpu")
    biased, _ = TT.prefill_forward(model, {"tokens": tokens}, tcfg, caches)
    for layer in model.layers:
        if layer.spec.mlp == MOE:
            assert layer.mlp.router_bias.abs().min() > 0
            layer.mlp.router_bias.data.zero_()
    caches = TT.init_caches(tcfg, 2, 16, device="cpu")
    plain, _ = TT.prefill_forward(model, {"tokens": tokens}, tcfg, caches)
    assert (biased - plain).abs().max() > 1e-3


def test_full_size_layers():
    """The full configurations' layers, built on the meta device: Kimi's
    dense first layer and 384-expert MoE with one shared expert and a
    float32 router bias; Jamba's unit of 8 (attention at position 3, MoE at
    the odd ones, Mamba with 256 heads of 64)."""
    kimi = tconfigs.get("kimi-k2-1t-a32b")
    specs = kimi.layer_specs()
    assert specs[0].mlp == DENSE and {s.mlp for s in specs[1:]} == {MOE}
    dense = TT.DecoderLayer(specs[0], kimi, device="meta")
    assert dense.mlp.wi_gate.shape == (7168, 18432)
    moe = TT.DecoderLayer(specs[1], kimi, device="meta")
    assert moe.mlp.w_gate.shape == (384, 7168, 2048)
    assert moe.mlp.shared.wi_gate.shape == (7168, 2048)
    assert moe.mlp.router_bias.dtype == torch.float32
    assert moe.mixer.wq.shape == (7168, 64, 128)

    jamba = tconfigs.get("jamba-1.5-large-398b")
    unit = jamba.layer_specs()[:8]
    assert [s.mixer for s in unit] == [MAMBA] * 3 + [FULL] + [MAMBA] * 4
    assert [s.mlp for s in unit] == [DENSE, MOE] * 4
    layer = TT.DecoderLayer(unit[1], jamba, device="meta")
    assert layer.mixer.A_log.shape == (256,)
    assert layer.mlp.w_gate.shape == (16, 8192, 24576)
    assert layer.mlp.shared is None
    assert len(jamba.layer_specs()) == 72
