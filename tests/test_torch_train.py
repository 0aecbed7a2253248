"""The port's training forward and its gradients against the JAX package,
on the CPU.

* ``cross_entropy_loss`` with ignored labels equals the reference's.
* ``train_forward``: the loss, ``nll``, ``aux`` and every gradient leaf of
  the port's autograd against ``jax.grad`` of the reference's
  ``train_forward``, on the same parameters (``params_from_reference``) and
  the same numpy batch, in float32 for the reduced configurations of
  paper-synthetic, MiniCPM-2B, Gemma2-27B (softcap, sliding window,
  post-norms), PaliGemma-3B (``prefix_embeds``), SeamlessM4T-medium
  (``src_embeds``: gradients reach the encoder), DeepSeekMoE-16B (the
  load-balance loss), Mamba2-780M (the scan), Kimi-K2 (a router bias,
  outside the graph: a zero gradient, as ``jax.grad`` gives it) and Jamba
  (Mamba, attention and MoE layers; at aux weight 0 on both sides, which
  leaves out the reference's known per-unit aux sum).  The losses agree to
  1e-5 relative and each gradient leaf to ``GRAD_REL`` of its largest
  magnitude: both sides sum the same float32 products in another order,
  which moves a gradient by a few ulps of the leaf's largest entries (the
  measured worst is 2.3e-6).  Reduced PaliGemma-3B runs twice: at the
  reduced head_dim of 16 and at its own 256 (``@hd256``: the prefix-LM
  attention whose gradient the bf16 hd-256 flash backward computes on the
  card).
* One training step on reduced Kimi-K2 (``accumulate_grads`` and
  ``apply_updates``) against ``jax.grad`` of the reference's
  ``train_forward`` and its AdamW: the loss, every gradient leaf (the
  router bias's zero) and the parameters after the step (the router bias
  moved by weight decay alone).
* Remat (``torch.utils.checkpoint`` per layer) changes no bit.
* The plain version of the flash backward against ``torch.autograd``
  through ``flash_attention_ref`` for every mask mode, softcap and GQA;
  its ``lse`` against ``logsumexp``; a row that admits no key takes the
  ``lse = +inf`` convention.
* The guard: on the CPU every kernel's plain version is differentiable,
  decode attention's too (only its card version raises;
  ``test_torch_cuda.py``).
* ``count_params`` and ``model_flops_per_token`` equal the reference's.
* Pinned: the reference's scan over a unit of several layers keeps only
  the unit's last load-balance loss (reduced Jamba); the port adds all.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference, reference_tree
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.steps import accumulate_grads
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw

from _torch_model_parity import reference_tree as jax_tree

#: a gradient leaf's largest error as a share of its largest magnitude
GRAD_REL = 2e-5
#: the same for a Mamba mixer's ``A_log``, at the scan's tolerance: its
#: gradient sums cancelling terms over every position, chunked at the
#: reference's 16 positions and the port's plain 256 (reduced Jamba reads
#: up to 4.0e-5 of it, reduced Mamba2-780M under 2e-5)
A_LOG_GRAD_REL = 2e-4
LOSS_REL = 1e-5
B, S = 2, 12


def _grad_rel(path):
    return A_LOG_GRAD_REL if "A_log" in jax.tree_util.keystr(path) \
        else GRAD_REL


def _batch(cfg, seed):
    """Tokens, labels (the first three of row 0 ignored) and a VLM's patch
    or an encoder-decoder's frame embeddings, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
    }
    batch["labels"][0, :3] = -1
    fd = cfg.frontend_dim or cfg.d_model
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_embeds, fd)).astype(np.float32)
    if cfg.encoder_layers:
        batch["src_embeds"] = rng.standard_normal((B, 7, fd)).astype(
            np.float32)
    return batch


def _port_grads(model, tcfg, batch, remat=False, aux_weight=0.01):
    """The port's loss, metrics and gradients, the gradients as the
    reference's tree of numpy leaves (a leaf outside the graph, a router
    bias, gets zeros)."""
    run_cfg = dataclasses.replace(tcfg, remat=remat)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, metrics = TT.train_forward(
        model, {k: torch.as_tensor(v) for k, v in batch.items()}, run_cfg,
        aux_weight=aux_weight)
    grads = dict(zip(named, torch.autograd.grad(
        loss, list(named.values()), allow_unused=True,
        materialize_grads=True)))
    tree = reference_tree(model, tcfg, lambda n: grads[n].numpy(), np.stack)
    return loss.detach(), metrics, tree


#: the aux loss's weight: 0 for Jamba, whose reference keeps only each
#: unit's last aux (pinned below)
AUX_WEIGHT = {"jamba-1.5-large-398b": 0.0}


def _reduced_pair(name):
    """Both packages' reduced configurations of ``name``; ``model@hdN``
    sets head_dim N on both."""
    base, _, hd = name.partition("@hd")
    cfg, tcfg = jconfigs.get(base).reduced(), tconfigs.get(base).reduced()
    if hd:
        cfg = dataclasses.replace(cfg, head_dim=int(hd))
        tcfg = dataclasses.replace(tcfg, head_dim=int(hd))
    return cfg, tcfg


@pytest.mark.parametrize("name", [
    "paper-synthetic", "minicpm-2b", "gemma2-27b", "paligemma-3b",
    "paligemma-3b@hd256", "seamless-m4t-medium", "deepseek-moe-16b",
    "mamba2-780m", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"])
def test_train_forward_and_grads_match_reference(name):
    cfg, tcfg = _reduced_pair(name)
    aux_weight = AUX_WEIGHT.get(name, 0.01)
    tree = jax_tree(cfg, 0)
    model = params_from_reference(tree, tcfg, device="cpu")
    batch = _batch(cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JT.train_forward(p, jb, cfg, aux_weight=aux_weight),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    loss, metrics, grads = _port_grads(model, tcfg, batch,
                                       aux_weight=aux_weight)
    pairs = [(loss, jloss), (metrics["nll"], jm["nll"])]
    if aux_weight:
        pairs.append((metrics["aux"], jm["aux"]))
    for got, want in pairs:
        assert float(got.detach()) == pytest.approx(
            float(want), rel=LOSS_REL, abs=1e-7)
    if cfg.moe is not None:
        assert float(metrics["aux"].detach()) > 0  # the MoE loss is kept
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(want) == len(got)
    for path, leaf in want:
        leaf = np.asarray(leaf)
        err = np.abs(got[path] - leaf).max()
        assert err <= _grad_rel(path) * max(np.abs(leaf).max(), 1e-30), \
            (path, err)
    if cfg.encoder_layers:  # the encoder is trained through _encode
        assert np.abs(got[next(p for p, _ in want
                               if "enc_units" in str(p))]).max() > 0


def test_remat_changes_no_bit():
    tcfg = tconfigs.get("gemma2-27b").reduced()
    batch = _batch(tcfg, 2)
    out = [_port_grads(TT.init_params(tcfg, 0, device="cpu"), tcfg, batch,
                       remat=r) for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(out[0][2]),
                              jax.tree_util.tree_leaves_with_path(out[1][2])):
        np.testing.assert_array_equal(a, b)


def test_cross_entropy_loss_with_ignored_labels():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 5, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 5)).astype(np.int32)
    labels[1] = -1
    labels[2, ::2] = -1
    want = jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tlayers.cross_entropy_loss(torch.as_tensor(logits),
                                     torch.as_tensor(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    none = np.full_like(labels, -1)
    assert float(tlayers.cross_entropy_loss(
        torch.as_tensor(logits), torch.as_tensor(none))) == 0.0
    assert float(jlayers.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(none))) == 0.0


@pytest.mark.parametrize("name", ["minicpm-2b", "deepseek-moe-16b",
                                  "seamless-m4t-medium", "jamba-1.5-large-398b"])
def test_model_accounting_matches_reference(name):
    cfg = jconfigs.get(name).reduced()
    tcfg = tconfigs.get(name).reduced()
    tree = jax_tree(cfg, 0)
    model = params_from_reference(tree, tcfg, device="cpu")
    assert TT.count_params(model) == JT.count_params(tree)
    want = JT.model_flops_per_token(cfg)
    assert TT.model_flops_per_token(tcfg) == want
    assert TT.model_flops_per_token(tcfg, model) == want


# ---------------------------------------------------------------------------
# the flash backward's plain version
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap, prefix_len)
MASKS = {
    "causal": (2, 4, 4, 37, 37, 16, True, 0, 0.0, 0),
    "causal GQA softcap": (1, 6, 2, 40, 40, 8, True, 0, 7.0, 0),
    "sliding": (1, 4, 2, 45, 45, 8, True, 9, 0.0, 0),
    "sliding softcap": (1, 2, 1, 33, 33, 16, True, 5, 3.0, 0),
    "prefix-LM": (2, 4, 1, 30, 30, 8, True, 0, 0.0, 11),
    "bidirectional": (1, 4, 2, 26, 26, 8, False, 0, 5.0, 0),
    "cross": (2, 4, 2, 19, 31, 8, False, 0, 0.0, 0),
}


def _attn_inputs(case, seed):
    b, hq, hkv, sq, skv, hd = case[:6]
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    return r(b, hq, sq, hd), r(b, hkv, skv, hd), r(b, hkv, skv, hd), \
        r(b, hq, sq, hd)


@pytest.mark.parametrize("mode", list(MASKS))
def test_flash_backward_ref_matches_autograd(mode):
    case = MASKS[mode]
    kw = dict(zip(("causal", "window", "softcap", "prefix_len"), case[6:]))
    q, k, v, do = _attn_inputs(case, 5)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = tref.flash_attention_ref(q, k, v, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        lse = tref.flash_attention_lse_ref(q, k, **kw)
        s, _, mask = tref._flash_scores(q, k, kw["causal"], kw["window"],
                                        kw["softcap"], kw["prefix_len"])
        np.testing.assert_allclose(
            lse, torch.logsumexp(s.masked_fill(~mask, -math.inf), -1),
            rtol=1e-6)
        got = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_flash_backward_ref_row_without_keys():
    """Sq > Skv + window - 1: the last rows admit no key.  The forward
    gives them the mean of V (the plain version's softmax over -2e38
    scores) and ``lse = +inf``; the backward gives them no gradient, so
    dK/dV equal autograd's with those rows' dO zeroed, and their dQ is 0."""
    case = (1, 2, 1, 30, 12, 8, True, 5, 0.0, 0)
    kw = dict(causal=True, window=5, softcap=0.0, prefix_len=0)
    q, k, v, do = _attn_inputs(case, 6)
    dead = 12 + 5 - 1
    lse = tref.flash_attention_lse_ref(q, k, **kw)
    assert torch.isinf(lse[..., dead:]).all()
    assert torch.isfinite(lse[..., :dead]).all()
    o = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(o[:, :, dead:],
                               v.mean(dim=2, keepdim=True).expand(
                                   1, 2, 30 - dead, 8), rtol=1e-6, atol=1e-6)
    dq, dk, dv = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    assert (dq[:, :, dead:] == 0).all()
    do_live = do.clone()
    do_live[:, :, dead:] = 0
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(tref.flash_attention_ref(q, k, v, **kw),
                               (q, k, v), do_live)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_router_bias_config_takes_a_step_as_the_reference():
    """Reduced Kimi-K2 with a drawn router bias, one microbatch: the
    port's ``accumulate_grads`` (a leaf outside the graph gets zeros) and
    ``apply_updates`` against ``jax.grad`` of the reference's
    ``train_forward`` and its AdamW.  The loss and every gradient leaf as in
    the parity test above, the router bias's gradient zero; after the step
    every parameter within float32 rounding of the reference's (an element
    whose gradient is within the two sides' noise of zero may differ by up
    to twice the learning rate, AdamW's first step being its sign), the
    router bias moved by weight decay alone."""
    name = "kimi-k2-1t-a32b"
    cfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    tree = jax_tree(cfg, 5, router_bias=True)
    model = params_from_reference(tree, tcfg, device="cpu")
    batch = _batch(cfg, 3)
    kw = dict(peak_lr=1e-3, warmup_steps=0, schedule="constant",
              weight_decay=0.1)
    jtree = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.train_forward(p, jb, cfg)[0])(jtree)
    jparams, _, _ = jadamw.apply_updates(jtree, jgrads,
                                         jadamw.init_state(jtree),
                                         jadamw.AdamWConfig(**kw))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, grads = accumulate_grads(
        model, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_REL)
    bias = [n for n in grads if n.endswith("router_bias")]
    assert bias and all(not grads[n].any() for n in bias)
    tadamw.apply_updates(model, grads, tadamw.init_state(model),
                         tadamw.AdamWConfig(**kw))
    for n in bias:   # zero gradient: weight decay alone moves the leaf
        torch.testing.assert_close(model.get_parameter(n).detach(),
                                   before[n] * (1 - kw["peak_lr"] * 0.1),
                                   rtol=1e-6, atol=1e-7)
    as_tree = {}
    for key, src in (("grads", grads),
                     ("params", dict(model.named_parameters()))):
        as_tree[key] = dict(jax.tree_util.tree_leaves_with_path(
            reference_tree(model, tcfg, lambda n, d=src: d[n].detach()
                           .numpy(), np.stack)))
    jg = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        want, g_ref = np.asarray(want), np.asarray(jg[path])
        got, g = as_tree["params"][path], as_tree["grads"][path]
        scale = max(np.abs(g_ref).max(), 1e-30)
        assert np.abs(g - g_ref).max() <= GRAD_REL * scale, path
        clear = np.abs(g_ref) > 1e-3 * scale   # outside the gradients' noise
        diff = np.abs(got - want)
        assert diff.max() <= 2 * kw["peak_lr"] + 1e-6, path
        assert diff[clear].max(initial=0.0) <= 1e-6, path


def test_guard_does_not_raise_on_the_cpu():
    """Every kernel takes its plain version on the CPU, which autograd
    differentiates: no guard there (on the card only decode attention
    keeps one)."""
    x = torch.randn(6, 4, requires_grad=True)
    tops.moe_gather(x, torch.tensor([0, 6, 3], dtype=torch.int32),
                    max_rows_per_token=1).sum().backward()
    assert x.grad is not None
    out = torch.randn(4, 4, requires_grad=True)
    tops.moe_combine(out, torch.tensor([0, 1, 1, 2]), torch.ones(4), 3,
                     max_rows_per_token=2).sum().backward()
    assert out.grad is not None
    q = torch.randn(2, 2, 8, requires_grad=True)
    cache = torch.randn(2, 1, 5, 8)
    tops.decode_attention(q, cache, cache, 3).sum().backward()
    assert q.grad is not None
    xs = torch.randn(1, 2, 5, 4, requires_grad=True)
    y, _ = tops.ssd_scan(xs, torch.rand(1, 2, 5), -torch.rand(2),
                         torch.randn(1, 2, 5, 4), torch.randn(1, 2, 5, 4))
    y.sum().backward()
    assert xs.grad is not None
    bg = torch.randn(1, 1, 5, 4, requires_grad=True)   # one shared group
    y, _ = tops.ssd_scan(xs, torch.rand(1, 2, 5), -torch.rand(2), bg, bg)
    y.sum().backward()
    assert bg.grad.shape == (1, 1, 5, 4)


def test_reference_keeps_only_each_units_last_aux():
    """Pinned: the reference's ``unit_body`` (``lax.scan`` over units of
    several layers) adds only the unit's last layer's load-balance loss, so
    reduced Jamba (a unit of 8 layers, MoE in every other) reports the sum
    over layers 7 and 15; the port adds every MoE layer's.  The NLL agrees
    (ROADMAP Queue 3)."""
    name = "jamba-1.5-large-398b"
    cfg = jconfigs.get(name).reduced()
    tcfg = tconfigs.get(name).reduced()
    tree = jax_tree(cfg, 0)
    model = params_from_reference(tree, tcfg, device="cpu")
    batch = _batch(cfg, 4)
    _, jm = JT.train_forward(jax.tree.map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             cfg)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        _, tm = TT.train_forward(model, tb, tcfg)
        x, _ = TT._embed_inputs(model, tb, tcfg)
        per_layer = []
        for layer in model.layers:
            x, aux = layer(x, None)
            per_layer.append(0.0 if aux is None else float(aux))
    unit = len(tcfg.layout()[1])
    last_of_units = sum(per_layer[unit - 1::unit])
    assert float(jm["aux"]) == pytest.approx(last_of_units, rel=1e-5)
    assert float(tm["aux"]) == pytest.approx(sum(per_layer), rel=1e-5)
    assert float(tm["aux"]) > 2 * float(jm["aux"])
    assert float(tm["nll"]) == pytest.approx(float(jm["nll"]), rel=1e-5)
