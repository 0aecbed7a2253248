"""Step builders and input specs for every (arch x shape) cell.

Port of ``repro/launch/steps.py``.  The training step is the paper's S3
and S5 at the training level: the ``k`` microbatches' gradients are summed
locally in ``grad_accum_dtype`` (an accumulator whose flush period is
``k``), and the optimizer's update commits them (the separate state
section).  The serve steps are S2: each data shard owns its requests'
caches.

The spec functions return trees of ``torch.empty(..., device="meta")``
tensors, the reference's ``jax.ShapeDtypeStruct`` stand-ins (no memory),
beside trees of specs (:mod:`repro_torch.launch.sharding`): the batch
(:func:`batch_specs`), the parameters (:func:`model_specs`: a
:class:`~repro_torch.models.transformer.Transformer` on ``meta`` and
``{parameter name: spec}``), the AdamW state (:func:`opt_specs`) and the
caches (:func:`cache_specs`, :func:`cache_pspecs`).  Leaf names, shapes and
dtypes are the reference's, with two differences of layout: the port keeps
one tensor per layer where the reference stacks a unit's layers
(:func:`repro_torch.interop.reference_param_paths`,
:func:`cache_reference_paths`), and a KV cache leaf is ``[B, Hkv, S, hd]``
(the decode kernel's layout), the reference's ``[B, S, Hkv, hd]`` with its
dimensions in the order :data:`KV_REFERENCE_DIMS`; its spec is permuted
the same way.

The step builders take the reference's ``rules`` (None: one rank, every
leaf whole) and run their bodies under :func:`~repro_torch.launch.
sharding.use_rules`.  With rules that carry a live mesh, every argument is
the rank's shard (:func:`~repro_torch.launch.sharding.distribute_params`,
:func:`local_zeros`, :func:`~repro_torch.launch.sharding.distribute`) and
the steps run the layers on the shards, as the reference's run under
``jax.jit`` with ``in_shardings``.  The training step then computes the
loss of the rank's batch shard (its share of the global batch's mean),
sums every gradient over the data-parallel axes its leaf is not split over
(the fsdp leaves' sum over ``data`` is their gather's reduce-scatter), so
each rank holds its shard of the global batch's gradient, clips by the
norm over all shards and applies AdamW to the shards.

:func:`build_cell` is the eager counterpart of the reference's
``lower_cell``: there is no lowering in eager PyTorch, so it returns the
step with its input specs and the reference's ``meta`` record; given a
live mesh, the step runs on real placements.  The dry-run
(:mod:`repro_torch.launch.dryrun`) runs a cell's step on ``meta``, with
no rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.cells import CellKnobs, knobs_for
from repro_torch.launch.sharding import (
    ShardingRules, local_shape, param_pspecs, spec_divisor, tp_group,
    use_rules,
)
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2
from repro_torch.models import transformer as T
from repro_torch.models.config import (
    MAMBA, ModelConfig, ShapeConfig, torch_dtype,
)
from repro_torch.optim import adamw

__all__ = ["Cell", "KV_REFERENCE_DIMS", "accumulate_grads", "batch_specs",
           "build_cell", "build_prefill_step", "build_serve_step",
           "build_train_step", "cache_pspecs", "cache_reference_paths",
           "cache_specs", "default_opt_config", "local_zeros", "make_rules",
           "model_specs", "next_token", "opt_specs", "reduce_grads",
           "sharded_grad_norm"]

#: a KV cache leaf's dims in the reference's order: the port's ``[B, Hkv,
#: S, hd]`` is the reference's ``[B, S, Hkv, hd]`` permuted by this
KV_REFERENCE_DIMS = (0, 2, 1, 3)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def make_rules(layout: mesh_lib.MeshLayout, cfg: ModelConfig,
               knobs: CellKnobs) -> ShardingRules:
    """The reference's rules of a cell on ``layout``."""
    if knobs.pure_dp:
        dp = mesh_lib.dp_axes(layout) + ("model",)
        return ShardingRules(mesh=layout, dp_axes=dp, tp_axis="model",
                             tp_enabled=False,
                             fsdp_axis=dp if knobs.fsdp else None,
                             shard_kv_heads=False, zero1=knobs.zero1)
    return ShardingRules(mesh=layout, dp_axes=mesh_lib.dp_axes(layout),
                         tp_axis="model",
                         fsdp_axis="data" if knobs.fsdp else None,
                         shard_kv_heads=knobs.shard_kv_heads,
                         moe_a2a=knobs.moe_a2a, zero1=knobs.zero1)


# ---------------------------------------------------------------------------
# input specs (meta tensors + specs)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules,
                knobs: CellKnobs) -> Tuple[dict, dict]:
    """(meta tensors, specs) of the data batch: ``tokens`` / ``labels``
    ``[k, mb, S]`` int32 for training, ``tokens [B, S]`` for prefill,
    ``tokens [B, 1]`` and a scalar ``index`` for decode, with a VLM's
    ``prefix_embeds`` and an encoder-decoder's ``src_embeds`` (``enc_out``
    at decode)."""
    dp = rules.dp
    b, s = shape.global_batch, shape.seq_len
    fd = cfg.frontend_dim or cfg.d_model
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "train":
        k = knobs.microbatches
        if b % k:
            raise ValueError(f"global batch {b} does not split into {k} "
                             f"microbatches")
        mb = b // k
        specs = {"tokens": _meta((k, mb, s), i32),
                 "labels": _meta((k, mb, s), i32)}
        pspecs = {"tokens": (None, dp, None), "labels": (None, dp, None)}
        if cfg.num_prefix_embeds:
            specs["prefix_embeds"] = _meta((k, mb, cfg.num_prefix_embeds,
                                            fd), f32)
            pspecs["prefix_embeds"] = (None, dp, None, None)
        if cfg.encoder_layers:
            specs["src_embeds"] = _meta((k, mb, s // 4, fd), f32)
            pspecs["src_embeds"] = (None, dp, None, None)
        return specs, pspecs
    if shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), i32)}
        pspecs = {"tokens": (dp, None)}
        if cfg.num_prefix_embeds:
            specs["prefix_embeds"] = _meta((b, cfg.num_prefix_embeds, fd),
                                           f32)
            pspecs["prefix_embeds"] = (dp, None, None)
        if cfg.encoder_layers:
            specs["src_embeds"] = _meta((b, s // 4, fd), f32)
            pspecs["src_embeds"] = (dp, None, None)
        return specs, pspecs
    specs = {"tokens": _meta((b, 1), i32), "index": _meta((), i32)}
    bdp = dp if b % rules.dp_size() == 0 else None
    pspecs = {"tokens": (bdp, None), "index": ()}
    if cfg.encoder_layers:
        specs["enc_out"] = _meta((b, s // 4, cfg.d_model), cfg.cdtype)
        pspecs["enc_out"] = (bdp, None, None)
    return specs, pspecs


def _kv_heads(cfg: ModelConfig, tp: int) -> int:
    """The KV caches' heads after the TP head padding.  A model with no
    attention layer has none to pad (the reference pads its head counts
    anyway, and a reduced Mamba2, 4 q heads over 0 kv heads, divides by
    zero there)."""
    if all(spec.mixer == MAMBA for spec in cfg.layer_specs()):
        return cfg.num_kv_heads
    return attn_lib.padded_head_counts(cfg.num_heads, cfg.num_kv_heads,
                                       tp)[1]


def cache_reference_paths(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    """Per port layer, the reference's path of its cache (``"prefix/0"``
    or ``"units/l0"``) and whether that leaf stacks the unit's layers."""
    prefix, unit, n_units = cfg.layout()
    return ([(f"prefix/{j}", False) for j in range(len(prefix))]
            + [(f"units/l{i}", True) for _ in range(n_units)
               for i in range(len(unit))])


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 rules: ShardingRules) -> List[dict]:
    """Per port layer, the specs of its cache's leaves (the reference's,
    a KV leaf's permuted to the port's ``[B, Hkv, S, hd]``): the batch over
    the data axes when it divides them, else (long-context decode) the
    sequence; kv heads over the model axis when they divide it (after the
    TP head padding); a Mamba state's heads over every axis they divide."""
    dp, tp = rules.dp, rules.tp_axis
    batch_shardable = shape.global_batch % rules.dp_size() == 0
    kv_heads = _kv_heads(cfg, rules.tp_size())
    kv_tp = tp if (rules.shard_kv_heads and kv_heads
                   and kv_heads % rules.tp_size() == 0) else None
    # the reference's [B, S, Hkv, hd] specs, in the port's order
    kv_ref = (dp, None, kv_tp, None) if batch_shardable \
        else (None, dp, kv_tp, None)
    kv = tuple(kv_ref[d] for d in KV_REFERENCE_DIMS)

    def mamba_spec():
        d_inner, h = mamba2.dims(cfg.d_model, cfg.ssm)
        inner = tp if d_inner % rules.tp_size() == 0 else None
        if batch_shardable:
            h_spec = (dp, tp if h % rules.tp_size() == 0 else None, None,
                      None)
            return {"h": h_spec, "conv_x": (dp, None, inner),
                    "conv_B": (dp, None, None), "conv_C": (dp, None, None)}
        # long-context decode, batch 1: heads over every axis they divide
        h_spec = (None, mamba2.long_decode_heads(h, rules), None, None)
        return {"h": h_spec, "conv_x": (None, None, inner),
                "conv_B": (None,) * 3, "conv_C": (None,) * 3}

    return [mamba_spec() if spec.mixer == MAMBA else {"k": kv, "v": kv}
            for spec in cfg.layer_specs()]


def model_specs(cfg: ModelConfig, rules: ShardingRules):
    """(the parameters: a Transformer on ``meta``, ``{name: spec}``)."""
    params = T.Transformer(cfg, device="meta")
    return params, param_pspecs(cfg, params, rules)


def opt_specs(params, params_pspecs):
    """(AdamW state of meta tensors, its specs): float32 ``m`` and ``v``
    per parameter with the parameter's spec, an int32 scalar ``step``."""
    m = {name: _meta(tuple(p.shape), torch.float32)
         for name, p in params.named_parameters()}
    v = {name: _meta(t.shape, t.dtype) for name, t in m.items()}
    state = {"m": m, "v": v, "step": _meta((), torch.int32)}
    return state, {"m": params_pspecs, "v": params_pspecs, "step": ()}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, tp: int = 1):
    """The caches of a cell on ``meta``: rows ``s_max = seq_len +
    num_prefix_embeds`` (a VLM prompt puts its patch embeddings ahead),
    kv heads after the TP head padding of a model axis of ``tp``."""
    b = shape.global_batch
    s_max = shape.seq_len + (cfg.num_prefix_embeds or 0)
    kv_heads = _kv_heads(cfg, tp)
    dev = torch.device("meta")
    return [mamba2.init_mamba_state(b, cfg.d_model, cfg.ssm, cfg.cdtype, dev)
            if spec.mixer == MAMBA else
            attn_lib.init_kv_cache(b, s_max, kv_heads, cfg.head_dim_,
                                   cfg.cdtype, dev)
            for spec in cfg.layer_specs()]


def default_opt_config(cfg: ModelConfig) -> adamw.AdamWConfig:
    """The reference's choice: WSD for MiniCPM-2B, cosine otherwise."""
    return adamw.AdamWConfig(
        schedule="wsd" if cfg.name == "minicpm-2b" else "cosine")


def accumulate_grads(params, batch, run_cfg: ModelConfig,
                     accum_dtype: torch.dtype = torch.float32):
    """The S3 half of the step: ``(mean loss, {name: gradient})``, the
    gradients of the ``k`` microbatches of ``batch`` (leaves ``[k, mb,
    ...]``; ``[mb, S]`` leaves are one microbatch) summed in
    ``accum_dtype`` and divided by ``k``, each microbatch's by autograd
    through ``train_forward(params, mb, run_cfg)``.  Marks the parameters
    as requiring grad."""
    named = adamw.named_params(params)
    leaves = list(named.values())
    for p in leaves:
        p.requires_grad_(True)
    if batch["tokens"].dim() == 2:
        batch = {key: val[None] for key, val in batch.items()}
    k = batch["tokens"].shape[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = None
    for i in range(k):
        mb = {key: val[i] for key, val in batch.items()}
        with torch.enable_grad():
            loss, _ = T.train_forward(params, mb, run_cfg)
            # a leaf outside the graph (a router bias only picks experts)
            # gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if acc is None:
            acc = [g.to(accum_dtype) for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.to(accum_dtype))
        loss_sum = loss_sum + loss.detach()
        del grads, loss
    return loss_sum / k, {name: a.div_(k) for name, a in zip(named, acc)}


def reduce_grads(params, grads: Dict[str, torch.Tensor],
                 rules: ShardingRules) -> Dict[str, torch.Tensor]:
    """Each rank's gradient shards -> the global batch's: every leaf summed
    over the data-parallel axes its storage spec does not split it over
    (one all-reduce a leaf; a leaf split over ``data`` got its sum over
    ``data`` from its gather's reduce-scatter, an expert-parallel one from
    the all-to-all's backward)."""
    live = rules.live
    out = {}
    for name, p in adamw.named_params(params).items():
        named = {a for entry in p.mesh_spec
                 for a in (entry if isinstance(entry, tuple) else (entry,))}
        axes = tuple(a for a in rules.dp_axes if a not in named)
        out[name] = mesh_lib.all_reduce(grads[name], live, axes)
    return out


def sharded_grad_norm(params, grads: Dict[str, torch.Tensor],
                      rules: ShardingRules) -> torch.Tensor:
    """The global norm of the whole gradient from the shards: each leaf's
    sum of squares over its copies (the ranks that hold the same shard),
    summed over every axis."""
    live, layout = rules.live, rules.live.layout
    total = None
    for name, p in adamw.named_params(params).items():
        copies = layout.size // spec_divisor(p.mesh_spec, layout)
        sq = (grads[name].float() ** 2).sum() / copies
        total = sq if total is None else total + sq
    return torch.sqrt(mesh_lib.all_reduce(total, live, layout.axis_names))


def build_train_step(cfg: ModelConfig, knobs: CellKnobs,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     rules: Optional[ShardingRules] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``.

    ``batch`` leaves have a leading ``[k, mb, ...]`` (``k`` microbatches
    of ``mb`` rows, :class:`~repro_torch.data.pipeline.SyntheticLM` with
    ``microbatches=k``); a batch of ``[mb, S]`` leaves is one microbatch.
    The step takes :func:`accumulate_grads` (``train_forward`` with
    ``knobs.remat``, gradients summed in ``knobs.grad_accum_dtype`` and
    divided by ``k``) and applies
    :func:`~repro_torch.optim.adamw.apply_updates`.  The parameters
    (marked as requiring grad) and the optimizer state are updated in
    place and returned.  ``loss`` is the mean of the microbatches' losses;
    all three metrics are float32 0-d tensors.  Under ``rules`` with a
    live mesh the arguments are the rank's shards (module docstring): the
    gradients are reduced by :func:`reduce_grads`, the clip's norm is
    :func:`sharded_grad_norm`, and every rank reports the global loss."""
    run_cfg = dataclasses.replace(cfg, remat=knobs.remat)
    accum_dtype = torch_dtype(knobs.grad_accum_dtype)
    if opt_cfg is None:
        opt_cfg = default_opt_config(cfg)

    def train_step(params, opt_state, batch):
        with use_rules(rules):
            loss, grads = accumulate_grads(params, batch, run_cfg,
                                           accum_dtype)
        gnorm = None
        if rules is not None:
            grads = reduce_grads(params, grads, rules)
            gnorm = sharded_grad_norm(params, grads, rules)
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg, grad_norm=gnorm)
        return params, opt_state, {"loss": loss, **om}

    return train_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def next_token(logits: torch.Tensor,
               vocab: Optional[int] = None) -> torch.Tensor:
    """The greedy token of each row: argmax over the last position's
    float32 logits -> int32 ``[B]``.  Logits with fewer than ``vocab``
    columns are this rank's block of the model axis (active rules): the
    block's maximum and index, then over the blocks the largest, the
    lowest index on ties, as a global argmax gives."""
    last = logits[:, -1].float()
    if vocab is None or last.shape[-1] == vocab:
        return last.argmax(dim=-1).to(torch.int32)
    live, axis, _, r = tp_group()
    idx = last.argmax(dim=-1)
    val = last.gather(-1, idx[:, None])[:, 0]
    mine = torch.stack([val.double(), (idx + r * last.shape[-1]).double()],
                       dim=-1)
    every = mesh_lib.all_gather(mine[None], live, axis, 0)  # [n, B, 2]
    best = every[..., 0].argmax(dim=0)          # the first block on ties
    return every[..., 1].gather(0, best[None])[0].to(torch.int32)


def build_prefill_step(cfg: ModelConfig,
                       rules: Optional[ShardingRules] = None):
    """``prefill_step(params, caches, batch) -> (next_tok int32 [B],
    caches)``: ``prefill_forward`` over the batch (the reference's keys),
    the caches written in place; under ``rules``, on the rank's shards."""
    def prefill_step(params, caches, batch):
        with use_rules(rules):
            logits, caches = T.prefill_forward(params, batch, cfg, caches)
            return next_token(logits, cfg.padded_vocab), caches

    return prefill_step


def build_serve_step(cfg: ModelConfig,
                     rules: Optional[ShardingRules] = None):
    """``serve_step(params, caches, batch) -> (next_tok int32 [B],
    caches)``: one decode step of ``tokens [B, 1]`` at the reference's
    scalar ``index`` (the position every slot's token takes), with an
    encoder-decoder's ``enc_out`` passed through.  The reference attends
    the cache below ``index`` plus the token's own k/v and commits them
    after; the port writes them at ``index`` first and attends ``index +
    1`` rows, so the scalar becomes one position per slot.  Under
    ``rules``, on the rank's shards."""
    def serve_step(params, caches, batch):
        tokens = batch["tokens"]
        index = torch.as_tensor(batch["index"], device=tokens.device)
        index = index.to(torch.int64).reshape(-1).expand(tokens.shape[0])
        dec = {"tokens": tokens}
        if "enc_out" in batch:
            dec["enc_out"] = batch["enc_out"]
        with use_rules(rules):
            logits, caches = T.decode_forward(params, dec, cfg, caches,
                                              index)
            return next_token(logits, cfg.padded_vocab), caches

    return serve_step


# ---------------------------------------------------------------------------
# one (arch x shape x mesh) cell
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """A cell built eagerly: ``step`` called as ``step(*specs.values())``
    on tensors of ``specs``' shapes (the specs are on ``meta``); ``specs``
    and ``pspecs`` hold ``params`` (a Transformer / ``{name: spec}``),
    ``opt_state`` (training) or ``caches``, and ``batch``, in the step's
    argument order; ``meta`` is the reference's record of the cell;
    ``rules`` the rules the step runs under (None without a live mesh)."""
    step: Callable
    specs: Dict[str, Any]
    pspecs: Dict[str, Any]
    meta: Dict[str, Any]
    device: torch.device
    rules: Optional[ShardingRules] = None


def local_zeros(tree, specs, rules: ShardingRules, device):
    """Zeros of each rank's shard of a tree of meta tensors (the caches of
    :func:`cache_specs`) with matching ``specs``."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(local_shape(tree.shape, specs, rules.live),
                           dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: local_zeros(v, specs[k], rules, device)
                for k, v in tree.items()}
    return type(tree)(local_zeros(v, s, rules, device)
                      for v, s in zip(tree, specs))


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               layout: mesh_lib.MeshLayout, *, device=None, mesh=None,
               **knob_overrides) -> Cell:
    """The eager counterpart of the reference's ``lower_cell``: the cell's
    step (``build_train_step``, ``build_prefill_step`` or
    ``build_serve_step``) for ``device`` (None: the CUDA card; ``"meta"``
    for a dry-run), its inputs' meta tensors and specs on ``layout``, and
    the reference's ``meta`` (arch, shape, mesh sizes, knobs).  With a
    live ``mesh`` (:func:`~repro_torch.launch.mesh.live_mesh` of
    ``layout``) the step runs under the cell's rules on the rank's shards
    (``cell.rules``; the specs stay the whole leaves').  A decode cell
    whose batch does not divide the data axes is the long-context decode:
    its live rules carry ``seq_axis``, the data axes its KV caches'
    sequence is split over."""
    dev = resolve_device(device)
    knobs = knobs_for(cfg, shape, **knob_overrides)
    rules = make_rules(layout, cfg, knobs)
    run = None
    if mesh is not None:
        if mesh.layout != layout:
            raise ValueError(f"the live mesh is {mesh.layout}, the cell's "
                             f"layout {layout}")
        run = dataclasses.replace(rules, live=mesh)
        if shape.kind != "train" and shape.global_batch % rules.dp_size():
            if shape.kind == "prefill":
                raise ValueError(
                    f"{shape.name}: a prefill batch of {shape.global_batch} "
                    f"does not split over {rules.dp_size()} data-parallel "
                    f"ranks (its tokens' spec splits the batch)")
            # the long-context decode: every rank serves the whole batch,
            # the caches' sequence split over the data axes (cache_pspecs)
            run = dataclasses.replace(run, seq_axis=rules.dp)
    params, params_ps = model_specs(cfg, rules)
    batch, batch_ps = batch_specs(cfg, shape, rules, knobs)
    meta = {"arch": cfg.name, "shape": shape.name, "mesh": layout.shape,
            "knobs": dataclasses.asdict(knobs)}
    if shape.kind == "train":
        opt, opt_ps = opt_specs(params, params_ps)
        return Cell(build_train_step(cfg, knobs, rules=run),
                    {"params": params, "opt_state": opt, "batch": batch},
                    {"params": params_ps, "opt_state": opt_ps,
                     "batch": batch_ps}, meta, dev, run)
    serve_cfg = dataclasses.replace(cfg, decode_unroll=knobs.decode_unroll)
    build = build_prefill_step if shape.kind == "prefill" \
        else build_serve_step
    return Cell(build(serve_cfg, run),
                {"params": params,
                 "caches": cache_specs(cfg, shape, tp=rules.tp_size()),
                 "batch": batch},
                {"params": params_ps,
                 "caches": cache_pspecs(cfg, shape, rules),
                 "batch": batch_ps}, meta, dev, run)
