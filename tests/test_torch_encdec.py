"""The prefix-LM and encoder-decoder paths against the JAX package:
attention in mask modes ``PREFIX`` and ``BIDIR`` and cross attention, and
the reduced PaliGemma-3B (prefix embeddings ahead of the tokens) and
SeamlessM4T-medium (a bidirectional encoder, cross attention in every
decoder layer).

Attention takes the same numpy inputs in both packages, layouts
transposed where they differ (the port's flash layout is ``[B, H, S,
hd]``, the reference model's ``[B, S, H, hd]``), and is held at float32
3e-5, the tolerance the reference holds its own kernels to.  The reduced
models run in float32 on the CPU (the kernels' plain versions): two slots
prefilled one at a time, 6 decode steps at per-slot positions, logits at
``atol = rtol = 1e-4`` as reduced Gemma2 is held.  The serving engine
serves both models text-only, as the reference's engine does (its
prefill takes ``tokens`` alone), token for token with it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as TT
from repro_torch.serving import Request, ServingEngine

from _torch_model_parity import (assert_round_trip, prefill_and_decode,
                                 reference_tree)

F32 = dict(atol=3e-5, rtol=3e-5)
MODEL = 1e-4
B, HQ, HKV, HD, S = 2, 4, 2, 16, 40


def t(a):
    return torch.as_tensor(np.array(a))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, sq, skv):
    """q ``[B, Sq, HQ, HD]``, k, v ``[B, Skv, HKV, HD]`` (the reference
    model's layout)."""
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, sq, HQ, HD), _normal(rng, B, skv, HKV, HD),
            _normal(rng, B, skv, HKV, HD))


def _flash(fn, q, k, v, **kw):
    """A flash-layout function on model-layout numpy inputs."""
    out = fn(*(t(a).transpose(1, 2) for a in (q, k, v)), **kw)
    return out.transpose(1, 2).numpy()


# ---------------------------------------------------------------------------
# attention modes
# ---------------------------------------------------------------------------

class TestPrefixLM:
    @pytest.mark.parametrize("prefix_len", [0, 1, 13, S])
    def test_flash_vs_reference_prefix_mode(self, prefix_len):
        """``k <= q or k < P`` against the reference's ``PREFIX`` mode, both
        its oracle and its blocked online softmax (8-row blocks, so the kv
        range of a block reaches past its diagonal to P)."""
        q, k, v = _qkv(prefix_len, S, S)
        kw = dict(mode=jattn.PREFIX, prefix_len=prefix_len)
        want = np.asarray(jattn.attend_naive(q, k, v, **kw))
        np.testing.assert_allclose(
            np.asarray(jattn.attend_chunked(q, k, v, block_q=8, block_k=8,
                                            **kw)), want, **F32)
        for fn in (tref.flash_attention_ref, tops.flash_attention):
            got = _flash(fn, q, k, v, causal=True, prefix_len=prefix_len)
            np.testing.assert_allclose(got, want, **F32)
        got = tattn.attend_naive(t(q), t(k), t(v), **kw).numpy()
        np.testing.assert_allclose(got, want, **F32)

    def test_prefix_changes_what_is_attended(self):
        q, k, v = _qkv(3, S, S)
        causal = _flash(tops.flash_attention, q, k, v, causal=True)
        prefix = _flash(tops.flash_attention, q, k, v, causal=True,
                        prefix_len=13)
        np.testing.assert_array_equal(prefix[:, 12:], causal[:, 12:])
        assert np.abs(prefix[:, :12] - causal[:, :12]).min() > 0

    @pytest.mark.parametrize("kw", [
        dict(prefix_len=-1), dict(prefix_len=S + 1),
        dict(prefix_len=4, causal=False), dict(prefix_len=4, window=8),
    ])
    def test_bad_prefix_refused(self, kw):
        q, k, v = (t(a).transpose(1, 2) for a in _qkv(0, S, S))
        with pytest.raises(ValueError, match="prefix_len"):
            tops.flash_attention(q, k, v, **kw)


class TestBidirectionalAndCross:
    @pytest.mark.parametrize("sq,skv", [(S, S), (12, S), (33, 7)])
    def test_flash_vs_reference_bidir(self, sq, skv):
        """No mask, ``Sq == Skv`` (the encoder) and ``Sq != Skv`` (cross)."""
        q, k, v = _qkv(sq + skv, sq, skv)
        want = np.asarray(jattn.attend_naive(q, k, v, mode=jattn.BIDIR))
        np.testing.assert_allclose(
            np.asarray(jattn.attend_chunked(q, k, v, mode=jattn.BIDIR,
                                            block_q=1024, block_k=1024)),
            want, **F32)
        for fn in (tref.flash_attention_ref, tops.flash_attention):
            np.testing.assert_allclose(_flash(fn, q, k, v, causal=False),
                                       want, **F32)
        got = tattn.attend_naive(t(q), t(k), t(v), mode=tattn.BIDIR)
        np.testing.assert_allclose(got.numpy(), want, **F32)


D = 32


def _block_params(seed):
    rng = np.random.default_rng(seed)
    p = {"wq": _normal(rng, D, HQ, HD) * D ** -0.5,
         "wk": _normal(rng, D, HKV, HD) * D ** -0.5,
         "wv": _normal(rng, D, HKV, HD) * D ** -0.5,
         "wo": _normal(rng, HQ, HD, D) * (HQ * HD) ** -0.5}
    mod = tattn.Attention(D, HQ, HKV, HD, dtype=torch.float32, device="cpu")
    for name, w in p.items():
        getattr(mod, name).data.copy_(t(w))
    return p, mod


class TestBlocks:
    def test_prefix_prefill_writes_cache_and_matches(self):
        p, mod = _block_params(1)
        x = _normal(np.random.default_rng(1), B, 21, D)
        kw = dict(mode="prefix", prefix_len=8, rope_theta=1e4)
        jout, jnew = jattn.attention_block(
            x, p, cache=jattn.init_kv_cache(B, 32, HKV, HD, np.float32), **kw)
        cache = tattn.init_kv_cache(B, 32, HKV, HD, torch.float32, "cpu")
        out, cache = tattn.attention_block(t(x), mod, cache=cache, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache[name].transpose(1, 2).numpy(), np.asarray(jnew[name]),
                **F32)

    def test_bidir_without_cache_is_the_encoder_layer(self):
        p, mod = _block_params(2)
        x = _normal(np.random.default_rng(2), B, 17, D)
        jout, _ = jattn.attention_block(x, p, mode="bidir", rope_theta=1e4)
        out, none = tattn.attention_block(t(x), mod, mode="bidir",
                                          rope_theta=1e4)
        assert none is None
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)

    @pytest.mark.parametrize("s", [1, 9])
    def test_cross_attention_block(self, s):
        """``encode_cross_kv`` (in the flash layout) and the block, a
        prefill of 9 queries and a decode step of one, against 13 source
        positions."""
        p, mod = _block_params(3)
        rng = np.random.default_rng(s)
        x, enc = _normal(rng, B, s, D), _normal(rng, B, 13, D)
        jkv = jattn.encode_cross_kv(enc, p)
        kv = tattn.encode_cross_kv(t(enc), mod)
        for name in ("k", "v"):
            assert kv[name].shape == (B, HKV, 13, HD)
            np.testing.assert_allclose(kv[name].transpose(1, 2).numpy(),
                                       np.asarray(jkv[name]), **F32)
        want = np.asarray(jattn.cross_attention_block(x, p, jkv))
        got = tattn.cross_attention_block(t(x), mod, kv)
        np.testing.assert_allclose(got.numpy(), want, **F32)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------

NAMES = ("paligemma-3b", "seamless-m4t-medium")


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    cfg = jconfigs.get(request.param).reduced()
    tcfg = tconfigs.get(request.param).reduced()
    tree = reference_tree(cfg, 7)
    return cfg, tree, tcfg, params_from_reference(tree, tcfg, device="cpu")


def test_prefill_and_six_decode_steps(model):
    """PaliGemma with its 8 prefix embeddings (mode ``PREFIX``); Seamless
    with 11 source frames at prefill and each slot's encoder output at
    decode."""
    cfg, tree, tcfg, params = model
    caches = prefill_and_decode(cfg, tree, tcfg, params, seed=9,
                                lengths=(7, 12), steps=6, s_max=40,
                                tol=MODEL)
    assert len(caches) == tcfg.num_layers


def test_weights_round_trip(model):
    cfg, tree, tcfg, params = model
    assert_round_trip(tree, params, tcfg)
    if cfg.encoder_layers:
        assert len(params.encoder) == cfg.encoder_layers
        assert all(layer.cross is not None for layer in params.layers)
        assert all(layer.cross is None for layer in params.encoder)


@pytest.mark.parametrize("name", NAMES)
def test_same_fields_as_reference(name):
    for reduce in (False, True):
        jc, tc = jconfigs.get(name), tconfigs.get(name)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_prefix_and_encoder_move_the_logits(model):
    """The batch keys are read: prefix embeddings or source frames change
    the prefill's logits, and tokens alone skip them (text-only)."""
    cfg, _, tcfg, params = model
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 9))).long()
    key = "prefix_embeds" if cfg.num_prefix_embeds else "src_embeds"
    n = cfg.num_prefix_embeds or 11
    extra = torch.as_tensor(_normal(rng, 1, n, cfg.frontend_dim))
    logits = []
    for batch in ({"tokens": tokens}, {"tokens": tokens, key: extra}):
        caches = TT.init_caches(tcfg, 1, 32, device="cpu")
        logits.append(TT.prefill_forward(params, batch, tcfg, caches)[0])
    assert (logits[0] - logits[1]).abs().max() > 1e-3


def test_init_params_stddevs():
    """``frontend_proj`` at ``frontend_dim ** -0.5``, the cross attention
    at the self attention's stddevs, the encoder's layers drawn, the new
    norm scales zero: each leaf's spread within 10% of the reference's
    init of the same configuration."""
    name = "seamless-m4t-medium"
    cfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    tree = reference_tree(cfg, 3)
    model = TT.init_params(tcfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    pairs = [(model.frontend_proj.w, tree["frontend_proj"]["w"])]
    for leaf in ("wq", "wk", "wv", "wo"):
        pairs.append((getattr(model.layers[0].cross, leaf),
                      tree["units"]["l0"]["cross"][leaf][0]))
        pairs.append((getattr(model.encoder[1].mixer, leaf),
                      tree["enc_units"]["mixer"][leaf][1]))
    pairs.append((model.encoder[0].mlp.wo, tree["enc_units"]["mlp"]["wo"][0]))
    for got, want in pairs:
        assert got.shape == want.shape
        assert abs(float(got.std()) / float(np.std(want)) - 1) < 0.1
    assert not model.layers[0].ln_cross.scale.any()
    assert not model.enc_final_norm.scale.any()
    pali = TT.init_params(tconfigs.get("paligemma-3b").reduced(),
                          device="cpu",
                          generator=torch.Generator().manual_seed(3))
    w = pali.frontend_proj.w
    assert w.shape == (32, 64) and len(pali.encoder) == 0
    assert abs(float(w.std()) * 32 ** 0.5 - 0.8796) < 0.1


# ---------------------------------------------------------------------------
# the serving engine: text-only, as the reference's
# ---------------------------------------------------------------------------

def _serve(engine_cls, request_cls, cfg, params, **kw):
    rng = np.random.default_rng(5)
    reqs = [request_cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(((6, 5), (13, 3), (9, 6), (17, 4)))]
    engine = engine_cls(cfg, params, num_slots=3, s_max=40, **kw)
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    return [list(r.generated) for r in reqs], engine


@pytest.mark.parametrize("name", NAMES)
def test_engine_serves_text_only_as_the_reference(name):
    """No prefix embeddings, no encoder, cross attention skipped in both
    engines: the same tokens, request for request."""
    cfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    tree = reference_tree(cfg, 11)
    params = params_from_reference(tree, tcfg, device="cpu")
    want, _ = _serve(JEngine, JRequest, cfg, tree)
    got, engine = _serve(ServingEngine, Request, tcfg, params, device="cpu")
    assert got == want
    assert engine.steps > 0
