"""Sharding rules as data: logical axes -> mesh axes, parameter specs.

Port of ``repro/launch/sharding.py``'s rules half.  The mesh axes are
``("pod", "data", "model")`` (multi-pod) or ``("data", "model")`` (single
pod) of a :class:`~repro_torch.launch.mesh.MeshLayout`.  Logical roles:

* batch     -> all data-parallel axes (``"pod"`` + ``"data"``);
* model/TP  -> ``"model"`` (attention heads, ff hidden, experts, vocab);
* fsdp/ZeRO -> ``"data"`` (parameter and optimizer-state sharding within
  a pod; across pods pure data parallelism, so the gradient sync is the
  paper's hierarchical S3 accumulator).

A spec is the reference's ``PartitionSpec`` as plain data: a tuple with one
entry per dimension, each ``None`` (replicated), an axis name, or a tuple
of axis names.  :func:`param_pspecs` keys the port's parameters by their
reference leaf paths (``embed/table``, ``units/l0/mixer/wq``, ...; the map
of :func:`repro_torch.interop.reference_param_paths`), so each parameter
gets its reference leaf's spec minus the stacked layer axis.

Not here, and coming with the execution half (ROADMAP): ``constrain``
(the reference's ``with_sharding_constraint`` of an activation under the
active rules) and ``gather_params_for_compute`` (ZeRO-1's per-use weight
gather), which need live collectives over a ``DeviceMesh``; the rules
context that ``constrain`` reads (``use_rules``, ``active_rules``,
``logical``, ``_resolve`` and the ``seq_axis`` it resolves), which nothing
else reads (the reference's attention pads heads and its MoE takes the
all-to-all route only under active rules); and ``named`` /
``tree_shardings``, which wrap specs in jax shardings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.launch.mesh import MeshLayout

__all__ = ["ShardingRules", "make_param_rule", "param_pspecs",
           "spec_divisor"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: MeshLayout
    dp_axes: Tuple[str, ...]            # ("pod", "data") or ("data",)
    tp_axis: str = "model"
    tp_enabled: bool = True             # False => pure DP (model joins dp)
    fsdp_axis: Optional[object] = "data"  # str | tuple | None (ZeRO axes)
    shard_kv_heads: bool = True
    moe_a2a: bool = False               # expert-parallel all_to_all MoE (S2)
    zero1: bool = False                 # gather fsdp-sharded weights at use

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis] if self.tp_enabled else 1

    def dp_size(self) -> int:
        return self.axis_size(self.dp_axes)

    def axis_size(self, axis) -> int:
        if axis is None:
            return 1
        names = axis if isinstance(axis, tuple) else (axis,)
        n = 1
        for a in names:
            n *= self.mesh.shape[a]
        return n

    def divisible(self, n: int, axis) -> bool:
        return axis is not None and n % self.axis_size(axis) == 0


def spec_divisor(spec, layout: MeshLayout) -> int:
    """How many ways a leaf of ``spec`` is split: the product of the mesh
    sizes of the axes it names (its bytes per chip are its bytes over
    this)."""
    shape = layout.shape
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n *= shape[a]
    return n


def make_param_rule(cfg, rules: ShardingRules):
    """``rule(path, shape) -> spec``, the reference's rules by leaf path
    and shape (an unstacked leaf's).  (The reference's ``fsdp_override``,
    the compute-time specs of ZeRO-1's gather, comes with that gather.)"""
    tp = rules.tp_axis if rules.tp_enabled else None
    fsdp = rules.fsdp_axis
    tp_n = rules.tp_size()
    heads_tp = cfg.num_heads % tp_n == 0 if cfg.num_heads else False
    kv_tp = (rules.shard_kv_heads and cfg.num_kv_heads
             and cfg.num_kv_heads % tp_n == 0)
    vocab_tp = cfg.padded_vocab % tp_n == 0
    ff_tp = cfg.d_ff % tp_n == 0 if cfg.d_ff else True
    exp_tp = cfg.moe is not None and cfg.moe.num_experts % tp_n == 0
    shared_ff_tp = (cfg.moe is not None and cfg.moe.num_shared
                    and (cfg.moe.d_ff_expert * cfg.moe.num_shared) % tp_n == 0)
    inner_tp = (cfg.ssm is not None
                and (cfg.ssm.expand * cfg.d_model) % tp_n == 0)

    def guard(ok, axis):
        return axis if ok else None

    def fix(spec, shape):
        """Drop any axis whose mesh size does not divide its dim."""
        padded = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(a if a is not None and dim % rules.axis_size(a) == 0
                     else None for dim, a in zip(shape, padded))

    def rule(path: str, shape) -> tuple:
        r = len(shape)
        if "embed/table" in path or "lm_head" in path:
            return (guard(vocab_tp, tp), fsdp)
        if path.endswith("scale") or r <= 1:  # norms, biases, A_log, ...
            return (None,) * r
        if "router" in path:
            return (None, None)
        # attention
        if "wq" in path and r == 3:
            return (fsdp, guard(heads_tp, tp), None)
        if ("wk" in path or "wv" in path) and r == 3:
            return (fsdp, guard(kv_tp, tp), None)
        if "wo" in path and r == 3:
            return (guard(heads_tp, tp), None, fsdp)
        # moe experts
        if rules.moe_a2a:
            # expert-parallel a2a: E over "data", expert ff over the model
            # axis
            if ("w_gate" in path or "w_up" in path) and r == 3:
                return ("data", None, tp)
            if "w_down" in path and r == 3:
                return ("data", tp, None)
        if ("w_gate" in path or "w_up" in path) and r == 3:
            return (guard(exp_tp, tp), fsdp, None)
        if "w_down" in path and r == 3:
            return (guard(exp_tp, tp), None, fsdp)
        # moe shared-expert mlp
        if "shared/wi" in path:
            return (fsdp, guard(shared_ff_tp, tp))
        if "shared/wo" in path:
            return (guard(shared_ff_tp, tp), fsdp)
        # mamba
        if "w_z" in path or "w_x" in path:
            return (fsdp, guard(inner_tp, tp))
        if "w_B" in path or "w_C" in path or "w_dt" in path:
            return (fsdp, None)
        if "conv_x" in path:
            return (None, guard(inner_tp, tp))
        if "conv_B" in path or "conv_C" in path:
            return (None, None)
        if "mixer/w_out" in path:
            return (guard(inner_tp, tp), fsdp)
        # dense mlp
        if "wi_gate" in path or "wi_up" in path:
            return (fsdp, guard(ff_tp, tp))
        if path.endswith("wo") and r == 2:
            return (guard(ff_tp, tp), fsdp)
        # frontend projection etc.
        if r == 2:
            return (None, fsdp)
        return (None,) * r

    def fixed_rule(path, shape):
        return fix(rule(path, shape), shape)

    return fixed_rule


def param_pspecs(cfg, params, rules: ShardingRules) -> Dict[str, tuple]:
    """``{parameter name: spec}`` for the port's
    :class:`~repro_torch.models.transformer.Transformer` ``params`` (on any
    device, ``meta`` too): each parameter's rule by its reference leaf path
    and its own (unstacked) shape; the reference's spec of a stacked leaf
    is ``(None, *this)``."""
    from repro_torch.interop import reference_param_paths

    rule = make_param_rule(cfg, rules)
    paths = reference_param_paths(params, cfg)
    return {name: rule(paths[name][0], tuple(p.shape))
            for name, p in params.named_parameters()}
