"""The dense decoder: parameters, KV caches, prefill and decode.

Port of the dense subset of ``repro/models/transformer.py``: attention
mixers (full and sliding) with dense MLPs, optional post-norms, tied or
untied embeddings.  The reference stacks its layers into a prefix and
``lax.scan``-ned units; the port keeps one module per layer, in order:
layer ``len(prefix) + u * len(unit) + i`` is the reference's unit ``u``,
entry ``l{i}`` (:mod:`repro_torch.interop` carries weights across).

Entry points (the reference's names):

* :func:`init_params` -- a :class:`Transformer` with random weights drawn
  from a seeded ``torch.Generator`` at the reference's stddevs;
* :func:`init_caches` -- one ``{"k", "v"}`` cache per layer,
  ``[B, Hkv, S_max, hd]``;
* :func:`prefill_forward` -- the prompt, writing the caches; returns the
  last position's logits;
* :func:`decode_forward` -- one token per slot at per-slot positions
  ``cache_index`` (ragged continuous batching), updating the caches in
  place; returns the logits.

Mamba, MoE, encoder-decoder and prefix-embedding models raise
``NotImplementedError``: they are ROADMAP Queue 1 item 12's later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import (
    DENSE, FULL, MAMBA, MOE, SLIDING, LayerSpec, ModelConfig,
)

Caches = List[Dict[str, torch.Tensor]]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not serve."""
    specs = cfg.layer_specs()
    if any(s.mixer == MAMBA for s in specs):
        raise NotImplementedError(
            f"{cfg.name}: Mamba-2 mixers wait for ROADMAP Queue 1 item 12 "
            f"(models/mamba2.py with the ssd_scan kernel, Queue 2 item 7)")
    if any(s.mlp == MOE for s in specs) or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers wait for ROADMAP Queue 1 item 12 "
            f"(models/moe.py with the moe_gather kernel, Queue 2 item 8)")
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models wait for ROADMAP Queue 1 "
            f"item 12 (cross attention)")
    if cfg.num_prefix_embeds:
        raise NotImplementedError(
            f"{cfg.name}: prefix-embedding frontends wait for ROADMAP Queue 1 "
            f"item 12 (prefix-LM attention)")
    bad = [s for s in specs if s.mixer not in (FULL, SLIDING)
           or s.mlp != DENSE]
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer kinds {set(bad)} are "
                                  f"not ported (ROADMAP Queue 1 item 12)")


class DecoderLayer(nn.Module):
    """``x + post_ln1(attn(ln1(x)))``, then ``x + post_ln2(mlp(ln2(x)))``."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, *, device):
        super().__init__()
        dt, d, eps = cfg.pdtype, cfg.d_model, cfg.norm_eps
        self.spec = spec
        self.ln1 = layers.RMSNorm(d, eps, dtype=dt, device=device)
        self.mixer = attn.Attention(d, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.head_dim_, dtype=dt, device=device)
        self.ln2 = layers.RMSNorm(d, eps, dtype=dt, device=device)
        self.mlp = layers.MLP(d, cfg.d_ff, cfg.mlp_activation, dtype=dt,
                              device=device)
        if cfg.post_norms:
            self.post_ln1 = layers.RMSNorm(d, eps, dtype=dt, device=device)
            self.post_ln2 = layers.RMSNorm(d, eps, dtype=dt, device=device)
        self.post_norms = cfg.post_norms
        self.residual_scale = cfg.residual_scale
        self.attn_kwargs = dict(
            mode=attn.SLIDING if spec.mixer == SLIDING else attn.CAUSAL,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            softcap=cfg.attn_logit_softcap,
        )

    def forward(self, x, cache: Optional[dict], cache_index=None):
        rs = self.residual_scale
        h, cache = attn.attention_block(self.ln1(x), self.mixer, cache=cache,
                                        cache_index=cache_index,
                                        **self.attn_kwargs)
        if self.post_norms:
            h = self.post_ln1(h)
        x = x + rs * h if rs != 1.0 else x + h
        h = self.mlp(self.ln2(x))
        if self.post_norms:
            h = self.post_ln2(h)
        return x + rs * h if rs != 1.0 else x + h


class Transformer(nn.Module):
    """The decoder's weights: embedding table ``[padded_vocab, d]``, the
    layers in order, the final norm, and ``lm_head`` when embeddings are
    untied.  Built with zero weights; :func:`init_params` draws them."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        shape = (cfg.padded_vocab, cfg.d_model)
        self.embed = layers.zeros_param(shape, cfg.pdtype, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else layers.zeros_param(shape, cfg.pdtype, device))
        self.layers = nn.ModuleList(
            DecoderLayer(s, cfg, device=device) for s in cfg.layer_specs())
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps,
                                         dtype=cfg.pdtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_tokens(self, tokens):
        cfg = self.cfg
        return layers.embed(tokens, self.embed, scale=cfg.embed_scale,
                            d_model=cfg.d_model, compute_dtype=cfg.cdtype)

    def logits(self, x):
        table = self.embed if self.lm_head is None else self.lm_head
        return layers.unembed(self.final_norm(x), table,
                              softcap=self.cfg.final_logit_softcap)

    def run(self, tokens, caches: Optional[Caches], cache_index=None):
        x = self.embed_tokens(tokens)
        for i, layer in enumerate(self.layers):
            x = layer(x, caches[i] if caches is not None else None,
                      cache_index)
        return x


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None) -> Transformer:
    """A :class:`Transformer` on ``device`` (``None``: the CUDA card) with
    the reference's initialization: truncated normals with stddev 0.02 for
    the embedding, ``d ** -0.5`` for the input projections,
    ``(Hq * hd) ** -0.5`` and ``ff ** -0.5`` for the output ones, zeros for
    the norm scales.  Drawn from ``generator``, or from a generator on the
    device seeded with ``seed``.  The numbers differ from the reference's
    (another generator); weights that must match are carried over with
    :func:`repro_torch.interop.params_from_reference`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, device=dev)
    layers.truncated_normal_(model.embed.data, 0.02, generator)
    if model.lm_head is not None:
        layers.truncated_normal_(model.lm_head.data, 0.02, generator)
    for layer in model.layers:
        layer.mixer.init_weights(generator)
        layer.mlp.init_weights(generator)
    return model


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=None, *,
                device=None) -> Caches:
    """Zeroed KV caches, one ``{"k", "v"}`` of ``[batch, Hkv, s_max, hd]``
    per layer, in the compute dtype unless ``dtype`` is given."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype
    return [attn.init_kv_cache(batch, s_max, cfg.num_kv_heads, cfg.head_dim_,
                               dtype, dev)
            for _ in cfg.layer_specs()]


@torch.no_grad()
def prefill_forward(params: Transformer, batch: dict, cfg: ModelConfig,
                    caches: Optional[Caches]):
    """The prompt ``batch["tokens"] [B, S]`` from position 0, writing the
    caches' rows ``[0, S)``.  Returns (last-position logits ``[B, 1, V]``
    float32, caches)."""
    x = params.run(batch["tokens"], caches)
    return params.logits(x[:, -1:]), caches


@torch.no_grad()
def decode_forward(params: Transformer, batch: dict, cfg: ModelConfig,
                   caches: Caches, cache_index):
    """One token per slot ``batch["tokens"] [B, 1]`` at positions
    ``cache_index`` (a scalar or ``[B]``), written into the caches in place.
    Returns (logits ``[B, 1, V]`` float32, caches)."""
    x = params.run(batch["tokens"], caches, cache_index)
    return params.logits(x), caches


def param_bytes(params: Transformer) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def cache_bytes(caches: Caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches for t in c.values())
