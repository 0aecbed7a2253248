"""The language model: parameters, caches, prefill and decode.

Port of ``repro/models/transformer.py``: attention mixers
(full and sliding) or Mamba-2 mixers, with dense, MoE or no MLPs, optional
post-norms, tied or untied embeddings; the prefix-LM VLM (stub patch
embeddings projected by ``frontend_proj`` and put ahead of the tokens,
full-attention layers in mask mode ``PREFIX``) and the encoder-decoder (a
bidirectional encoder over stub frame embeddings, and per decoder layer a
cross attention to its output).  The reference stacks its layers into a
prefix and ``lax.scan``-ned units; the port keeps one module per layer, in
order: layer ``len(prefix) + u * len(unit) + i`` is the reference's unit
``u``, entry ``l{i}``, and encoder layer ``i`` is entry ``i`` of its
``enc_units`` (:mod:`repro_torch.interop` carries weights across).

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
  place; returns the logits;
* :func:`train_forward` -- the training loss (mean token NLL plus the MoE
  load-balance loss), differentiable, with per-layer remat; and the
  reference's accounting, :func:`count_params` and
  :func:`model_flops_per_token`.

Their batch keys are the reference's: ``tokens``; ``prefix_embeds``
``[B, P, frontend_dim]`` (prefill of a VLM: the cache then holds ``P +
S`` rows); ``src_embeds`` ``[B, S_src, frontend_dim]`` (prefill of an
encoder-decoder: the encoder runs) and ``enc_out`` ``[B, S_src, d]``
(decode of one: :func:`_encode`'s output).  Cross attention runs only when
the encoder output is given, as in the reference, so a batch of tokens
alone runs an encoder-decoder as a plain decoder (the serving engine's
text-only path).  Each cross layer computes its k/v from the encoder
output at every call, as the reference does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import (
    active_rules, constrain, gather_params_for_compute, gathered, tp_group,
)
from repro_torch.models import attention as attn
from repro_torch.models import layers, mamba2, moe
from repro_torch.models.config import (
    DENSE, FULL, MAMBA, MOE, NONE, SLIDING, LayerSpec, ModelConfig,
)

Caches = List[Dict[str, torch.Tensor]]
#: the leaves of a KV cache; every other cache leaf is recurrent state
KV_LEAVES = ("k", "v")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration the model cannot be built from: an unknown
    layer kind (``NotImplementedError``), or Mamba / MoE layers without
    their ``SSMConfig`` / ``MoEConfig`` (``ValueError``)."""
    specs = cfg.layer_specs()
    bad = [s for s in specs if s.mixer not in (FULL, SLIDING, MAMBA)
           or s.mlp not in (DENSE, MOE, NONE)]
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer kinds {set(bad)} are "
                                  f"not ported")
    if any(s.mixer == MAMBA for s in specs) and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: Mamba layers need an SSMConfig")
    if any(s.mlp == MOE for s in specs) and cfg.moe is None:
        raise ValueError(f"{cfg.name}: MoE layers need a MoEConfig")


class DecoderLayer(nn.Module):
    """``x + post_ln1(mixer(ln1(x)))``, then, with ``cross`` and an encoder
    output, ``x + cross(ln_cross(x))``, then, unless the layer has no MLP,
    ``x + post_ln2(mlp(ln2(x)))`` (each branch times the residual scale);
    the mixer is attention or Mamba-2, the MLP dense or MoE.  The encoder's
    layers are of this class too (``FULL``, ``DENSE``, no cross)."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, *, device,
                 cross: bool = False):
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
        self.cross = None
        if cross:
            self.ln_cross = layers.RMSNorm(d, eps, dtype=dt, device=device)
            self.cross = attn.Attention(d, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.head_dim_, dtype=dt,
                                        device=device)
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
        self.attn_kwargs = dict(rope_theta=cfg.rope_theta,
                                window=cfg.sliding_window,
                                softcap=cfg.attn_logit_softcap)

    def forward(self, x, cache: Optional[dict], cache_index=None, *,
                mode: str = attn.CAUSAL, prefix_len: int = 0, enc_out=None):
        """-> ``(x, aux)``: ``aux`` is an MoE layer's load-balance loss
        (float32, 0-d), None for other layers.  ``mode`` and ``prefix_len``
        are a full-attention layer's mask (a sliding layer's is always
        ``SLIDING``); ``enc_out`` drives the cross attention, when the layer
        has one.  Under sharding rules the layer computes with its weights
        gathered at use (ZeRO's gather; the reference's per-layer
        ``gather_params_for_compute``)."""
        return gather_params_for_compute(self)._apply(
            x, cache, cache_index, mode=mode, prefix_len=prefix_len,
            enc_out=enc_out)

    def _apply(self, x, cache, cache_index, *, mode, prefix_len, enc_out):
        rs = self.residual_scale
        if self.spec.mixer == MAMBA:
            h, _ = mamba2.mamba_block(self.ln1(x), self.mixer, self.cfg.ssm,
                                      norm_eps=self.cfg.norm_eps, state=cache)
        else:
            h, _ = attn.attention_block(
                self.ln1(x), self.mixer, cache=cache, cache_index=cache_index,
                mode=attn.SLIDING if self.spec.mixer == SLIDING else mode,
                prefix_len=prefix_len, **self.attn_kwargs)
        if self.post_norms:
            h = self.post_ln1(h)
        x = x + rs * h if rs != 1.0 else x + h
        if self.cross is not None and enc_out is not None:
            h = attn.cross_attention_block(
                self.ln_cross(x), self.cross,
                attn.encode_cross_kv(enc_out, self.cross))
            x = x + rs * h if rs != 1.0 else x + h
        aux = None
        if self.spec.mlp == NONE:
            return x, aux
        if self.spec.mlp == MOE:
            h, aux = moe.moe_ffn(self.ln2(x), self.mlp, self.cfg.moe)
        else:
            h = self.mlp(self.ln2(x))
        if self.post_norms:
            h = self.post_ln2(h)
        return (x + rs * h if rs != 1.0 else x + h), aux


class FrontendProj(nn.Module):
    """The stub frontend's projection ``w [frontend_dim or d, d]``: patch
    or frame embeddings into the model's width, in the compute dtype."""

    def __init__(self, fd: int, d: int, *, dtype, device):
        super().__init__()
        self.w = layers.zeros_param((fd, d), dtype, device)

    def forward(self, e, compute_dtype):
        return e.to(compute_dtype) @ gathered(self.w).to(compute_dtype)


class Transformer(nn.Module):
    """The model's weights: embedding table ``[padded_vocab, d]``, the
    decoder layers in order, the final norm, and ``lm_head`` when
    embeddings are untied; with a frontend (prefix embeddings or an
    encoder) ``frontend_proj``, and with an encoder its layers
    (``encoder``), ``enc_final_norm`` and a cross attention in every
    decoder layer.  Built with zero weights; :func:`init_params` draws
    them."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        shape = (cfg.padded_vocab, cfg.d_model)
        self.embed = layers.zeros_param(shape, cfg.pdtype, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else layers.zeros_param(shape, cfg.pdtype, device))
        self.layers = nn.ModuleList(
            DecoderLayer(s, cfg, device=device, cross=cfg.encoder_layers > 0)
            for s in cfg.layer_specs())
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps,
                                         dtype=cfg.pdtype, device=device)
        self.frontend_proj = None
        if cfg.num_prefix_embeds or cfg.encoder_layers:
            self.frontend_proj = FrontendProj(
                cfg.frontend_dim or cfg.d_model, cfg.d_model,
                dtype=cfg.pdtype, device=device)
        self.encoder = nn.ModuleList(
            DecoderLayer(LayerSpec(FULL, DENSE), cfg, device=device)
            for _ in range(cfg.encoder_layers))
        self.enc_final_norm = (
            layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=cfg.pdtype,
                           device=device) if cfg.encoder_layers else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _table(self, table):
        """A vocabulary table as computed with (fsdp shards gathered) and
        the offset of its block when the model axis splits the vocabulary
        (None when it holds it all)."""
        table = gathered(table)
        if table.shape[0] == self.cfg.padded_vocab:
            return table, None
        return table, tp_group().index * table.shape[0]

    def embed_tokens(self, tokens):
        """Token embeddings in the compute dtype.  Under rules that split
        the vocabulary over the model axis: each rank's rows of its block
        (zeros elsewhere), summed over the axis."""
        cfg = self.cfg
        table, offset = self._table(self.embed)
        x = layers.embed(tokens, table, scale=cfg.embed_scale,
                         d_model=cfg.d_model, compute_dtype=cfg.cdtype,
                         offset=offset)
        if offset is None:
            return x
        return constrain(x, "batch", None, None, partial="tp")

    def logits(self, x):
        """Float32 logits of the final-normed ``x``; under rules that split
        the vocabulary over the model axis, this rank's block of them (the
        reference's ``constrain(logits, "batch", None, "tp")``)."""
        table, offset = self._table(self.embed if self.lm_head is None
                                    else self.lm_head)
        x = self.final_norm(x)
        if offset is not None:
            tp = tp_group()
            x = mesh_lib.copy_in(x, tp.live, tp.axis)
        return layers.unembed(x, table, softcap=self.cfg.final_logit_softcap)

    def run(self, x, caches: Optional[Caches], cache_index=None, *,
            remat: bool = False, **kw):
        """The decoder layers over embeddings ``x`` -> ``(x, aux)``, ``aux``
        the sum of the MoE layers' load-balance losses (float32, 0-d; None
        without MoE layers); ``kw`` goes to each layer (mask mode, prefix
        length, encoder output).  ``remat`` (training, no caches) runs each
        layer under ``torch.utils.checkpoint``: its activations are dropped
        after the forward and recomputed in the backward, as the
        reference's ``jax.checkpoint`` of a unit."""
        aux = None
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            if remat:
                # the layers draw no random numbers: no RNG state to keep
                x, a = checkpoint(layer, x, cache, cache_index,
                                  use_reentrant=False,
                                  preserve_rng_state=False, **kw)
            else:
                x, a = layer(x, cache, cache_index, **kw)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None) -> Transformer:
    """A :class:`Transformer` on ``device`` (``None``: the CUDA card) with
    the reference's initialization: truncated normals with stddev 0.02 for
    the embedding, ``frontend_dim ** -0.5`` for ``frontend_proj``,
    ``d ** -0.5`` for the input projections (cross attention's too),
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
    if model.frontend_proj is not None:
        w = model.frontend_proj.w
        layers.truncated_normal_(w.data, w.shape[0] ** -0.5, generator)
    for layer in (*model.layers, *model.encoder):
        layer.mixer.init_weights(generator)
        if layer.cross is not None:
            layer.cross.init_weights(generator)
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


def _encode(params: Transformer, src_embeds, cfg: ModelConfig):
    """The bidirectional encoder over stub frontend embeddings ``[B, S_src,
    frontend_dim]`` -> its output ``[B, S_src, d]`` (after
    ``enc_final_norm``), in the compute dtype.  Differentiable (training
    reaches the encoder through it); the serving entry points call it under
    their own ``torch.no_grad``."""
    x = params.frontend_proj(src_embeds, cfg.cdtype)
    for layer in params.encoder:
        x, _ = layer(x, None, mode=attn.BIDIR)
    return params.enc_final_norm(x)


def _embed_inputs(params: Transformer, batch: dict, cfg: ModelConfig):
    """The tokens' embeddings, with a VLM's ``prefix_embeds`` projected
    and put ahead of them -> (x ``[B, P + S, d]``, ``P``; 0 without)."""
    x = params.embed_tokens(batch["tokens"])
    if not (cfg.num_prefix_embeds and "prefix_embeds" in batch):
        return x, 0
    pe = params.frontend_proj(batch["prefix_embeds"], cfg.cdtype)
    return torch.cat([pe, x], dim=1), pe.shape[1]


@torch.no_grad()
def prefill_forward(params: Transformer, batch: dict, cfg: ModelConfig,
                    caches: Optional[Caches]):
    """The prompt ``batch["tokens"] [B, S]`` from position 0 (after
    ``prefix_embeds``' ``P`` positions, which every position attends),
    writing the KV caches' rows ``[0, P + S)`` and the Mamba states; with
    ``src_embeds`` the encoder runs and every decoder layer attends its
    output.  A Mamba layer's conv continues from the state it is given (the
    reference's semantics), so a reused cache is zeroed first
    (:func:`zero_recurrent_`).  Returns (last-position logits ``[B, 1, V]``
    float32, caches)."""
    x, prefix_len = _embed_inputs(params, batch, cfg)
    enc_out = None
    if cfg.encoder_layers and "src_embeds" in batch:
        enc_out = _encode(params, batch["src_embeds"], cfg)
    x, _ = params.run(x, caches,
                      mode=attn.PREFIX if prefix_len else attn.CAUSAL,
                      prefix_len=prefix_len, enc_out=enc_out)
    return params.logits(x[:, -1:]), caches


@torch.no_grad()
def decode_forward(params: Transformer, batch: dict, cfg: ModelConfig,
                   caches: Caches, cache_index):
    """One token per slot ``batch["tokens"] [B, 1]`` at positions
    ``cache_index`` (a scalar or ``[B]``), written into the caches in place;
    with ``enc_out`` every decoder layer attends it.  Returns (logits
    ``[B, 1, V]`` float32, caches)."""
    enc_out = batch.get("enc_out") if cfg.encoder_layers else None
    x, _ = params.run(params.embed_tokens(batch["tokens"]), caches,
                      cache_index, enc_out=enc_out)
    return params.logits(x), caches


def train_forward(params: Transformer, batch: dict, cfg: ModelConfig, *,
                  aux_weight: float = 0.01):
    """The training loss of ``batch`` (``tokens``, ``labels`` ``[B, S]``,
    and a VLM's ``prefix_embeds`` or an encoder-decoder's ``src_embeds``)
    -> ``(loss, {"nll", "aux"})``: the mean token NLL of the logits at the
    token positions (the prefix's are cut, as in the reference) plus
    ``aux_weight`` times the MoE layers' load-balance losses (float32, 0
    without MoE layers).  Differentiable: the caller takes the gradients
    (``loss.backward()`` or ``torch.autograd.grad``) of the parameters
    that require grad.  With ``cfg.remat`` every decoder layer runs under
    ``torch.utils.checkpoint``.  The reference's scan over a unit of
    several layers adds only the unit's last layer's aux
    (``repro/models/transformer.py``, ``unit_body``); the port adds every
    layer's, as its unrolled paths do (equal for every configuration whose
    unit is one layer)."""
    x, prefix_len = _embed_inputs(params, batch, cfg)
    enc_out = None
    if cfg.encoder_layers and "src_embeds" in batch:
        enc_out = _encode(params, batch["src_embeds"], cfg)
    x, aux = params.run(x, None, remat=cfg.remat,
                        mode=attn.PREFIX if prefix_len else attn.CAUSAL,
                        prefix_len=prefix_len, enc_out=enc_out)
    logits = params.logits(x)
    if prefix_len:
        logits = logits[:, prefix_len:]
    rules = active_rules()
    if rules is None:
        nll = layers.cross_entropy_loss(logits, batch["labels"])
    else:
        nll = _sharded_nll(logits, batch["labels"], cfg, rules)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=nll.device)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _sharded_nll(logits, labels, cfg: ModelConfig, rules):
    """The global batch's mean token NLL from this rank's batch shard (and
    block of the vocabulary, when ``logits`` hold fewer than
    ``padded_vocab`` columns): each shard's sum over the global count of
    counted labels, summed over the data-parallel axes by ``reduce_out``.
    Every rank gets the global value; its gradient is this shard's share,
    and the step sums the shares' parameter gradients over those axes."""
    live = rules.live
    mask = labels != -1
    if logits.shape[-1] == cfg.padded_vocab:
        safe = torch.where(mask, labels, 0).long()
        logits = logits.float()
        tok = (torch.logsumexp(logits, dim=-1)
               - logits.gather(-1, safe[..., None])[..., 0]) * mask
    else:
        tp = tp_group()
        tok = layers.vocab_parallel_nll(logits, labels,
                                        tp.index * logits.shape[-1], tp)
    count = mesh_lib.all_reduce(mask.sum().float(), live, rules.dp_axes)
    return mesh_lib.reduce_out(tok.sum() / count.clamp_min(1), live,
                               rules.dp_axes)


def count_params(params: Transformer) -> int:
    """Parameters, each counted once (a tied embedding is one table)."""
    return sum(p.numel() for p in params.parameters())


def model_flops_per_token(cfg: ModelConfig, params: Optional[Transformer] =
                          None) -> float:
    """``6 * N`` (dense) or ``6 * N_active`` (MoE): the reference's model
    FLOPs per trained token.  The embedding and ``lm_head`` tables are left
    out (a lookup is not a product), and an MoE layer's expert weights
    count ``top_k / num_experts`` of their size.  Without ``params`` the
    model is built on the ``meta`` device (no memory)."""
    if params is None:
        params = Transformer(cfg, device="meta")
    active = 0
    for name, p in params.named_parameters():
        if name in ("embed", "lm_head"):
            continue
        n = p.numel()
        if cfg.moe and name.rsplit(".", 1)[-1] in ("w_gate", "w_up",
                                                   "w_down"):
            n = int(n * (cfg.moe.top_k / cfg.moe.num_experts))
        active += n
    return 6.0 * active


def param_bytes(params: Transformer) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def cache_bytes(caches: Caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches for t in c.values())
