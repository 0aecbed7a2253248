"""The decoder: parameters, caches, prefill and decode.

Port of ``repro/models/transformer.py`` for decoder-only models: attention
mixers (full and sliding) or Mamba-2 mixers, with dense, MoE or no MLPs,
optional post-norms, tied or untied embeddings.  The reference stacks its
layers into a prefix and ``lax.scan``-ned units; the port keeps one module
per layer, in order: layer ``len(prefix) + u * len(unit) + i`` is the
reference's unit ``u``, entry ``l{i}`` (:mod:`repro_torch.interop` carries
weights across).

Entry points (the reference's names):

* :func:`init_params` -- a :class:`Transformer` with random weights drawn
  from a seeded ``torch.Generator`` at the reference's stddevs;
* :func:`init_caches` -- per layer, a KV cache ``{"k", "v"}`` of
  ``[B, Hkv, S_max, hd]`` or a Mamba state ``{"h", "conv_x", "conv_B",
  "conv_C"}``;
* :func:`prefill_forward` -- the prompt, writing the caches; returns the
  last position's logits;
* :func:`decode_forward` -- one token per slot at per-slot positions
  ``cache_index`` (ragged continuous batching), updating the caches in
  place; returns the logits.

Encoder-decoder and prefix-embedding models raise ``NotImplementedError``:
they are a later part of ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, mamba2, moe
from repro_torch.models.config import (
    DENSE, FULL, MAMBA, MOE, NONE, SLIDING, LayerSpec, ModelConfig,
)

Caches = List[Dict[str, torch.Tensor]]
#: the leaves of a KV cache; every other cache leaf is recurrent state
KV_LEAVES = ("k", "v")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models wait for ROADMAP Queue 1 "
            f"item 12 (cross attention)")
    if cfg.num_prefix_embeds:
        raise NotImplementedError(
            f"{cfg.name}: prefix-embedding frontends wait for ROADMAP Queue 1 "
            f"item 12 (prefix-LM attention)")
    specs = cfg.layer_specs()
    bad = [s for s in specs if s.mixer not in (FULL, SLIDING, MAMBA)
           or s.mlp not in (DENSE, MOE, NONE)]
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer kinds {set(bad)} are "
                                  f"not ported (ROADMAP Queue 1 item 12)")
    if any(s.mixer == MAMBA for s in specs) and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: Mamba layers need an SSMConfig")
    if any(s.mlp == MOE for s in specs) and cfg.moe is None:
        raise ValueError(f"{cfg.name}: MoE layers need a MoEConfig")


class DecoderLayer(nn.Module):
    """``x + post_ln1(mixer(ln1(x)))``, then, unless the layer has no MLP,
    ``x + post_ln2(mlp(ln2(x)))``; the mixer is attention or Mamba-2, the
    MLP dense or MoE."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, *, device):
        super().__init__()
        dt, d, eps = cfg.pdtype, cfg.d_model, cfg.norm_eps
        self.spec = spec
        self.cfg = cfg
        self.ln1 = layers.RMSNorm(d, eps, dtype=dt, device=device)
        if spec.mixer == MAMBA:
            self.mixer = mamba2.Mamba(d, cfg.ssm, eps, dtype=dt,
                                      device=device)
        else:
            self.mixer = attn.Attention(d, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.head_dim_, dtype=dt,
                                        device=device)
        if cfg.post_norms:
            self.post_ln1 = layers.RMSNorm(d, eps, dtype=dt, device=device)
        if spec.mlp == MOE:
            self.mlp = moe.MoE(d, cfg.moe, cfg.mlp_activation, dtype=dt,
                               device=device)
        elif spec.mlp == DENSE:
            self.mlp = layers.MLP(d, cfg.d_ff, cfg.mlp_activation, dtype=dt,
                                  device=device)
        if spec.mlp != NONE:
            self.ln2 = layers.RMSNorm(d, eps, dtype=dt, device=device)
            if cfg.post_norms:
                self.post_ln2 = layers.RMSNorm(d, eps, dtype=dt,
                                               device=device)
        self.post_norms = cfg.post_norms
        self.residual_scale = cfg.residual_scale
        self.attn_kwargs = dict(
            mode=attn.SLIDING if spec.mixer == SLIDING else attn.CAUSAL,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            softcap=cfg.attn_logit_softcap,
        )

    def forward(self, x, cache: Optional[dict], cache_index=None):
        rs = self.residual_scale
        if self.spec.mixer == MAMBA:
            h, _ = mamba2.mamba_block(self.ln1(x), self.mixer, self.cfg.ssm,
                                      norm_eps=self.cfg.norm_eps, state=cache)
        else:
            h, _ = attn.attention_block(self.ln1(x), self.mixer, cache=cache,
                                        cache_index=cache_index,
                                        **self.attn_kwargs)
        if self.post_norms:
            h = self.post_ln1(h)
        x = x + rs * h if rs != 1.0 else x + h
        if self.spec.mlp == NONE:
            return x
        if self.spec.mlp == MOE:
            h, _ = moe.moe_ffn(self.ln2(x), self.mlp, self.cfg.moe)
        else:
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
    the norm scales (the Mamba and MoE modules say their own).  Drawn from
    ``generator``, or from a generator on the device seeded with ``seed``.
    The numbers differ from the reference's (another generator); weights
    that must match are carried over with
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
        if layer.spec.mlp != NONE:
            layer.mlp.init_weights(generator)
    return model


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=None, *,
                device=None) -> Caches:
    """Zeroed caches, one per layer, in the compute dtype unless ``dtype``
    is given: ``{"k", "v"}`` of ``[batch, Hkv, s_max, hd]`` for attention,
    the Mamba state (``h`` float32, conv histories in ``dtype``) for
    Mamba-2."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype

    def one(spec: LayerSpec) -> dict:
        if spec.mixer == MAMBA:
            return mamba2.init_mamba_state(batch, cfg.d_model, cfg.ssm,
                                           dtype, dev)
        return attn.init_kv_cache(batch, s_max, cfg.num_kv_heads,
                                  cfg.head_dim_, dtype, dev)

    return [one(spec) for spec in cfg.layer_specs()]


def zero_recurrent_(caches: Caches) -> Caches:
    """Zero every recurrent (non-KV) leaf in place: a prefill from position
    0 starts from a zero Mamba state and conv history."""
    for cache in caches:
        for name, leaf in cache.items():
            if name not in KV_LEAVES:
                leaf.zero_()
    return caches


@torch.no_grad()
def prefill_forward(params: Transformer, batch: dict, cfg: ModelConfig,
                    caches: Optional[Caches]):
    """The prompt ``batch["tokens"] [B, S]`` from position 0, writing the
    KV caches' rows ``[0, S)`` and the Mamba states.  A Mamba layer's conv
    continues from the state it is given (the reference's semantics), so a
    reused cache is zeroed first (:func:`zero_recurrent_`).  Returns
    (last-position logits ``[B, 1, V]`` float32, caches)."""
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
