"""The MoE slice against the JAX package: routing, dispatch, the gather,
the combine, the MoE FFN and the reduced DeepSeekMoE-16B.

The same numpy inputs go through the reference (its Pallas ``moe_gather``
in interpret mode, its jnp oracles, its model code) and through the port's
plain versions on the CPU.  Integer results (expert ids as sets, the
dispatch tables, the gathered rows) must be exactly equal; float32 results
are held to 1e-5 (the FFN: sums in another order) and the whole reduced
model to 1e-4.  The CUDA kernel is held against the plain version on the
card by ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.moe_dispatch import moe_gather as jgather
from repro.models import moe as jmoe
from repro.models import transformer as JT
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT

FFN = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)


def t(a):
    return torch.as_tensor(np.array(a))


def _moe_cfgs(**changes):
    j = jconfigs.get("deepseek-moe-16b").reduced()
    tc = tconfigs.get("deepseek-moe-16b").reduced()
    return (dataclasses.replace(j.moe, **changes),
            dataclasses.replace(tc.moe, **changes), j.d_model)


def _layer(jm, tm, d, seed, bias=False):
    """The reference's MoE parameters (numpy) and the port's module
    holding the same weights."""
    jm = dataclasses.replace(jm, router_bias=bias)
    tm = dataclasses.replace(tm, router_bias=bias)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), d,
                                                 jm, jnp.float32))
    if bias:
        jp["router_bias"] = np.random.default_rng(seed).standard_normal(
            jm.num_experts).astype(np.float32)
    mod = tmoe.MoE(d, tm, "silu", dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(t(leaf))
    return jm, tm, jp, mod


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("bias", [False, True])
def test_route_selects_the_same_experts(bias):
    jm, tm, d = _moe_cfgs()
    jm, tm, jp, mod = _layer(jm, tm, d, 0, bias)
    x = _x(0, 3, 24, d)
    j_ids, j_w, j_aux = jmoe.route(jnp.asarray(x), jp, jm)
    ids, w, aux = tmoe.route(t(x), mod, tm)
    # the order of the k picks may differ on ties; compare sorted by id
    jo, to = np.argsort(np.asarray(j_ids), -1), torch.argsort(ids, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(np.asarray(j_ids), jo, -1),
        ids.gather(-1, to).numpy())
    np.testing.assert_allclose(w.gather(-1, to).numpy(),
                               np.take_along_axis(np.asarray(j_w), jo, -1),
                               **FFN)
    np.testing.assert_allclose(float(aux), float(j_aux), **FFN)


@pytest.mark.parametrize("capacity_factor,s", [(1.25, 24), (0.5, 40),
                                               (0.5, 1), (8.0, 13)])
def test_dispatch_indices_exactly_equal(capacity_factor, s):
    """The same picks give the same buffer: tokens and weights per row,
    including picks dropped at capacity (factor 0.5)."""
    jm, tm, d = _moe_cfgs(capacity_factor=capacity_factor)
    rng = np.random.default_rng(s)
    e, k = jm.num_experts, jm.top_k
    ids = np.stack([np.stack([rng.choice(e, k, replace=False)
                              for _ in range(s)]) for _ in range(3)])
    w = rng.random((3, s, k)).astype(np.float32)
    cap = jmoe.capacity(s, jm)
    assert tmoe.capacity(s, tm) == cap
    j_tok, j_w = jmoe.dispatch_indices(jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(w), jm, cap)
    tok, tw = tmoe.dispatch_indices(t(ids).long(), t(w), tm, cap)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(j_w))
    if capacity_factor < 1 and s > 1:
        kept = (np.asarray(j_tok) < s).sum()
        assert kept < 3 * s * k          # some picks were dropped


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("n,d,r", [(64, 128, 96), (17, 24, 50)])
def test_moe_gather_exactly_equal(n, d, r, dtype):
    """Dummy rows (token == T) read zeros; bfloat16 values are carried as
    their float32 values in both packages."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    tok = rng.integers(0, n + 1, r).astype(np.int32)
    tok[:3] = n
    want = np.asarray(jref.moe_gather_ref(jnp.asarray(x), jnp.asarray(tok)))
    interp = np.asarray(jgather(jnp.asarray(x), jnp.asarray(tok),
                                interpret=True))
    np.testing.assert_array_equal(interp, want)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = tops.moe_gather(t(x).to(tdt), t(tok))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not tref.moe_gather_ref(t(x), t(tok))[:3].any()


def test_moe_combine_matches_reference():
    rng = np.random.default_rng(9)
    n, d, r = 20, 16, 60
    rows = rng.standard_normal((r, d)).astype(np.float32)
    tok = rng.integers(0, n + 1, r).astype(np.int32)
    w = rng.random(r).astype(np.float32)
    want = jref.moe_combine_ref(jnp.asarray(rows), jnp.asarray(tok),
                                jnp.asarray(w), n)
    most = int(np.bincount(tok[tok < n], minlength=n).max())
    got = tops.moe_combine(t(rows), t(tok), t(w), n, max_rows_per_token=most)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN)
    # a looser bound (the model passes top_k) adds only zero rows
    loose = tops.moe_combine(t(rows), t(tok), t(w), n,
                             max_rows_per_token=most + 3)
    assert torch.equal(loose, got)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(capacity_factor):
    jm, tm, d = _moe_cfgs(capacity_factor=capacity_factor)
    jm, tm, jp, mod = _layer(jm, tm, d, 1)
    x = _x(1, 2, 30, d)
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, jm)
    out, aux = tmoe.moe_ffn(t(x), mod, tm)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FFN)
    np.testing.assert_allclose(float(aux), float(jaux), **FFN)


def test_moe_ffn_equals_dense_oracle_without_drops():
    jm, tm, d = _moe_cfgs(capacity_factor=8.0)
    jm, tm, jp, mod = _layer(jm, tm, d, 2, bias=True)
    x = _x(2, 2, 19, d)
    out, _ = tmoe.moe_ffn(t(x), mod, tm)
    dense, _ = tmoe.moe_ffn_dense_oracle(t(x), mod, tm)
    jdense, _ = jmoe.moe_ffn_dense_oracle(jnp.asarray(x), jp, jm)
    torch.testing.assert_close(out, dense, **FFN)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **FFN)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_small():
    cfg = jconfigs.get("deepseek-moe-16b").reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(6)))
    tcfg = tconfigs.get("deepseek-moe-16b").reduced()
    return cfg, tree, tcfg, params_from_reference(tree, tcfg, device="cpu")


def test_reduced_deepseek_prefill_and_decode(moe_small):
    """The dense prefix layer and two MoE layers: a 23-token prefill and 6
    decode steps (capacity 4 per sequence), logits within 1e-4."""
    cfg, tree, tcfg, model = moe_small
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 23)).astype(np.int32)
    jcaches = JT.init_caches(cfg, 2, 40, cfg.cdtype)
    jlog, jcaches = JT.prefill_forward(tree, {"tokens": prompt}, cfg, jcaches)
    caches = TT.init_caches(tcfg, 2, 40, device="cpu")
    tlog, caches = TT.prefill_forward(model, {"tokens": t(prompt).long()},
                                      tcfg, caches)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for step in range(6):
        idx = np.full(2, 23 + step, np.int32)
        jlog, jcaches = JT.decode_forward(tree, {"tokens": tok}, cfg,
                                          jcaches, jnp.asarray(idx))
        tlog, caches = TT.decode_forward(model, {"tokens": t(tok).long()},
                                         tcfg, caches, t(idx))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]


def test_weights_round_trip_and_float32_router(moe_small):
    cfg, tree, tcfg, model = moe_small
    back = params_to_reference(model, tcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      flat_b[path])
    big = tconfigs.get("deepseek-moe-16b")
    specs = big.layer_specs()
    dense = TT.DecoderLayer(specs[0], big, device="meta")
    assert dense.mlp.wi_gate.shape == (2048, 10944)
    layer = TT.DecoderLayer(specs[1], big, device="meta")
    assert layer.mlp.router.dtype == torch.float32
    assert layer.mlp.w_gate.shape == (64, 2048, 1408)
    assert layer.mlp.shared.wi_gate.shape == (2048, 2816)
    assert layer.mlp.router_bias is None
