"""Shared helpers of the reduced-model parity tests
(``test_torch_families.py``, ``test_torch_encdec.py``).

The JAX package's parameters (``init_params`` from a PRNG key, leaves as
numpy) go to the port through ``params_from_reference``.  Each of two
slots is prefilled alone, with its own prompt length, in both packages;
the two caches are stacked into one batch and decoded for a few steps at
per-slot positions, every step's token the reference's argmax.  Prefix
embeddings (VLM) and source frames (encoder-decoder) are made with numpy
from the seed and given to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as JT
from repro_torch.interop import params_to_reference
from repro_torch.models import transformer as TT

#: the source frames of an encoder-decoder's slots
SRC_LEN = 11


def reference_tree(cfg, seed, router_bias=False):
    """The reference's parameters as numpy; with ``router_bias`` every MoE
    router bias drawn non-zero (the reference's init gives zeros, which
    would leave the bias out of the expert choice)."""
    tree = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(
        seed)))
    if router_bias:
        rng = np.random.default_rng(seed)

        def draw(path, leaf):
            if any(getattr(k, "key", None) == "router_bias" for k in path):
                return (rng.standard_normal(leaf.shape) * 0.5).astype(
                    leaf.dtype)
            return leaf

        tree = jax.tree_util.tree_map_with_path(draw, tree)
    return tree


def assert_round_trip(tree, model, tcfg):
    """``params_to_reference`` gives back every leaf of ``tree``, equal."""
    back = params_to_reference(model, tcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      flat_b[path])


def _stack_reference(caches):
    """Two batch-1 reference cache trees -> one of batch 2 (the prefix
    layers' leaves have batch first, the stacked units' after the unit)."""
    a, b = caches
    return {
        "prefix": tuple(jax.tree.map(lambda x, y: jnp.concatenate([x, y]),
                                     pa, pb)
                        for pa, pb in zip(a["prefix"], b["prefix"])),
        "units": jax.tree.map(lambda x, y: jnp.concatenate([x, y], axis=1),
                              a["units"], b["units"]),
    }


def prefill_and_decode(cfg, tree, tcfg, model, *, seed, lengths, steps,
                       s_max, tol):
    """Prefill each slot alone (``lengths[i]`` tokens, after the prefix
    embeddings of a VLM; with ``src_embeds`` of an encoder-decoder), then
    decode both slots ``steps`` times at their own positions, holding the
    port's logits to the reference's at ``atol = rtol = tol`` after the
    prefills and after every step.  For an encoder-decoder the decode
    steps take each package's own ``_encode`` output, held to the
    reference's first.  Returns the port's caches."""
    rng = np.random.default_rng(seed)
    jcaches, tcaches, enc = [], [], []
    ext = []
    for n in lengths:
        prompt = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        jb, tb = {"tokens": prompt}, {"tokens": torch.as_tensor(prompt).long()}
        if cfg.num_prefix_embeds:
            pe = rng.standard_normal((1, cfg.num_prefix_embeds,
                                      cfg.frontend_dim)).astype(np.float32)
            jb["prefix_embeds"], tb["prefix_embeds"] = pe, torch.as_tensor(pe)
        if cfg.encoder_layers:
            se = rng.standard_normal((1, SRC_LEN, cfg.frontend_dim)).astype(
                np.float32)
            jb["src_embeds"], tb["src_embeds"] = se, torch.as_tensor(se)
            j_enc = np.asarray(JT._encode(tree, se, cfg))
            t_enc = TT._encode(model, torch.as_tensor(se), tcfg)
            np.testing.assert_allclose(t_enc.numpy(), j_enc, atol=tol,
                                       rtol=tol)
            enc.append((j_enc, t_enc))
        jc = JT.init_caches(cfg, 1, s_max, cfg.cdtype)
        jlog, jc = JT.prefill_forward(tree, jb, cfg, jc)
        tc = TT.init_caches(tcfg, 1, s_max, device="cpu")
        tlog, tc = TT.prefill_forward(model, tb, tcfg, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol,
                                   rtol=tol)
        jcaches.append(jc)
        tcaches.append(tc)
        ext.append((int(np.asarray(jnp.argmax(jlog[0, -1]))),
                    cfg.num_prefix_embeds + n))
    jc = _stack_reference(jcaches)
    tc = [{k: torch.cat([a[k], b[k]]) for k in a}
          for a, b in zip(*tcaches)]
    jextra, textra = {}, {}
    if enc:
        jextra["enc_out"] = np.concatenate([e[0] for e in enc])
        textra["enc_out"] = torch.cat([e[1] for e in enc])
    tok = np.array([[e[0]] for e in ext], np.int32)
    pos = np.array([e[1] for e in ext], np.int32)
    assert len(set(pos.tolist())) == len(pos), "slots share a position"
    for step in range(steps):
        idx = pos + step
        jlog, jc = JT.decode_forward(tree, {"tokens": tok, **jextra}, cfg,
                                     jc, jnp.asarray(idx))
        tlog, tc = TT.decode_forward(
            model, {"tokens": torch.tensor(tok).long(), **textra}, tcfg,
            tc, torch.as_tensor(idx))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol,
                                   rtol=tol)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    return tc
