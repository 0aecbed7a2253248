"""Sharding rules: logical axes -> mesh axes, parameter specs, and their
execution on a live mesh.

Port of ``repro/launch/sharding.py``.  The mesh axes are ``("pod", "data",
"model")`` (multi-pod) or ``("data", "model")`` (single pod) of a
:class:`~repro_torch.launch.mesh.MeshLayout`.  Logical roles:

* batch     -> all data-parallel axes (``"pod"`` + ``"data"``);
* model/TP  -> ``"model"`` (attention heads, ff hidden, experts, vocab);
* fsdp/ZeRO -> ``"data"`` (parameter and optimizer-state sharding within
  a pod; across pods pure data parallelism, so the gradient sync is the
  paper's hierarchical S3 accumulator).

A spec is the reference's ``PartitionSpec`` as plain data: a tuple with one
entry per dimension, each ``None`` (replicated), an axis name, or a tuple
of axis names (one dimension split over several axes, the first
outermost).  :func:`param_pspecs` keys the port's parameters by their
reference leaf paths (``embed/table``, ``units/l0/mixer/wq``, ...; the map
of :func:`repro_torch.interop.reference_param_paths`), so each parameter
gets its reference leaf's spec minus the stacked layer axis.

Execution (explicit SPMD, the counterpart of GSPMD plus ``shard_map``):
each rank holds its shard of every leaf as a plain tensor
(:func:`distribute_params`, :func:`shard`), exactly the bytes the dry-run
counts, and the layers compute on those local tensors, so every kernel
wrapper gets plain tensors.  Under :func:`use_rules` with rules
that carry a live mesh (``ShardingRules.live``) the models place the
collectives where the reference's ``constrain`` and ``shard_map`` put them:

* :func:`constrain` brings a local tensor to the placement the logical
  axes name (a no-op without active rules);
* :func:`gather_params_for_compute` gathers the fsdp (ZeRO) shards of a
  module's weights at use, keeping their TP shards.  The reference does
  this only under ``zero1`` and otherwise lets GSPMD choose; in eager code
  the gather at use is the only sound choice, so the port always gathers.
  The results are the same either way.

``named`` and ``tree_shardings`` wrap specs in jax shardings and have no
counterpart.  ``seq_axis`` is the axis a long-context decode splits its
caches' sequence over (the logical ``"seq"``): :func:`~repro_torch.launch.
steps.make_rules` leaves it None, as the reference's does, and
``build_cell`` sets it to the data-parallel axes on the live rules of a
decode cell whose batch does not divide them (``cache_pspecs`` split the
KV caches' sequence there); the attention and Mamba layers read it.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MeshLayout

__all__ = ["ShardingRules", "TPGroup", "active_rules", "constrain",
           "distribute", "distribute_params", "gather_params_for_compute",
           "gathered", "local_shape", "logical", "make_param_rule",
           "param_pspecs", "shard", "spec_divisor", "tp_group", "use_rules"]

_ACTIVE: contextvars.ContextVar[Optional["ShardingRules"]] = \
    contextvars.ContextVar("sharding_rules", default=None)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: MeshLayout
    dp_axes: Tuple[str, ...]            # ("pod", "data") or ("data",)
    tp_axis: str = "model"
    tp_enabled: bool = True             # False => pure DP (model joins dp)
    fsdp_axis: Optional[object] = "data"  # str | tuple | None (ZeRO axes)
    shard_kv_heads: bool = True
    seq_axis: Optional[object] = None   # sequence sharding for long decode
    moe_a2a: bool = False               # expert-parallel all_to_all MoE (S2)
    zero1: bool = False                 # gather fsdp-sharded weights at use
    #: the ranks the layout runs on (None: rules as data, for the specs)
    live: Optional[mesh_lib.LiveMesh] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def tp(self) -> Optional[str]:
        """The TP axis, None when TP is off."""
        return self.tp_axis if self.tp_enabled else None

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


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    token = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_rules() -> Optional[ShardingRules]:
    return _ACTIVE.get()


def _live(rules: ShardingRules) -> mesh_lib.LiveMesh:
    if rules.live is None:
        raise RuntimeError("the active sharding rules have no live mesh "
                           "(ShardingRules.live): rules as data only give "
                           "specs")
    return rules.live


class TPGroup(NamedTuple):
    """This rank's place on the TP (model) axis: the live mesh, the axis,
    its ranks and this rank's index along it."""
    live: mesh_lib.LiveMesh
    axis: str
    size: int
    index: int


def tp_group() -> Optional[TPGroup]:
    """This rank's :class:`TPGroup` under active rules whose model axis
    spans more than one rank; None otherwise."""
    rules = _ACTIVE.get()
    if rules is None or rules.tp is None:
        return None
    live = _live(rules)
    n = live.size(rules.tp)
    if n == 1:
        return None
    return TPGroup(live, rules.tp, n, live.index(rules.tp))


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


# ---------------------------------------------------------------------------
# logical activation specs
# ---------------------------------------------------------------------------

def logical(*axes: Optional[str]) -> Tuple[Optional[str], ...]:
    """Logical axes as a tuple, the form :func:`constrain` and
    :func:`_resolve` read."""
    return axes


def _resolve(rules: ShardingRules, axes) -> tuple:
    """Logical axes -> a spec: ``"batch"`` the data-parallel axes, ``"tp"``
    the model axis (None with TP off), ``"seq"`` the rules' ``seq_axis``;
    any other entry is a mesh axis name or tuple, kept."""
    out = []
    for a in axes:
        if a == "batch":
            out.append(rules.dp)
        elif a == "tp":
            out.append(rules.tp)
        elif a == "seq":
            out.append(rules.seq_axis)
        else:
            out.append(a)
    return tuple(out)


def _fixed(rules: ShardingRules, shape, spec) -> tuple:
    """``spec`` padded to ``len(shape)`` with every axis whose mesh size
    does not divide its dimension dropped."""
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(a if a is not None and dim % rules.axis_size(a) == 0
                 else None for dim, a in zip(shape, padded))


def constrain(x, *axes: Optional[str], have=None, partial=None):
    """Bring the local tensor ``x`` to the placement of the logical
    ``axes`` under the active rules (``x`` itself without them).  Axes
    whose mesh size does not divide the (global) dimension are dropped.

    ``have`` is the logical placement ``x`` is in (default: already the
    target), ``partial`` a logical axis over which ``x`` is a partial sum.
    A partial sum is all-reduced (:func:`~repro_torch.launch.mesh.
    reduce_out`); then a dimension replicated but wanted sharded is sliced
    to this rank's shard, and one sharded but wanted replicated is
    all-gathered."""
    rules = _ACTIVE.get()
    if rules is None:
        return x
    live = _live(rules)
    have_spec = _resolve(rules, axes if have is None else have)
    have_spec = tuple(have_spec) + (None,) * (x.dim() - len(have_spec))
    shape = [n * live.size(a) for n, a in zip(x.shape, have_spec)]
    have_spec = _fixed(rules, shape, have_spec)
    want = _fixed(rules, shape, _resolve(rules, axes))
    if partial is not None:
        axis = _resolve(rules, (partial,))[0]
        if any(a is not None and set(live.names(a)) & set(live.names(axis))
               for a in want):
            raise NotImplementedError("constrain: a partial sum into a "
                                      "dimension sharded over its axis")
        x = mesh_lib.reduce_out(x, live, axis)
    for dim, (h, w) in enumerate(zip(have_spec, want)):
        if h == w:
            continue
        if h is not None:
            x = mesh_lib.all_gather(x, live, h, dim)
        if w is not None:
            x = shard(x, w, live, dim)
    return x


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def make_param_rule(cfg, rules: ShardingRules, *, fsdp_override="keep"):
    """``rule(path, shape) -> spec``, the reference's rules by leaf path
    and shape (an unstacked leaf's).  ``fsdp_override=None`` gives the
    compute-time specs of ZeRO's gather: fsdp stripped, TP kept."""
    tp = rules.tp
    fsdp = rules.fsdp_axis if fsdp_override == "keep" else fsdp_override
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


def param_pspecs(cfg, params, rules: ShardingRules, *,
                 fsdp_override="keep") -> Dict[str, tuple]:
    """``{parameter name: spec}`` for the port's
    :class:`~repro_torch.models.transformer.Transformer` ``params`` (on any
    device, ``meta`` too): each parameter's rule by its reference leaf path
    and its own (unstacked) shape; the reference's spec of a stacked leaf
    is ``(None, *this)``.  ``fsdp_override=None``: the compute-time
    specs."""
    from repro_torch.interop import reference_param_paths

    rule = make_param_rule(cfg, rules, fsdp_override=fsdp_override)
    paths = reference_param_paths(params, cfg)
    return {name: rule(paths[name][0], tuple(p.shape))
            for name, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def shard(t: torch.Tensor, entry, live: mesh_lib.LiveMesh,
          dim: int) -> torch.Tensor:
    """This rank's shard (a view) of ``t`` split along ``dim`` over the
    axes of one spec ``entry``."""
    n = live.size(entry)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {entry} ({n} ranks)")
    size = t.shape[dim] // n
    return t.narrow(dim, live.index(entry) * size, size)


def local_shape(shape, spec, live: mesh_lib.LiveMesh) -> tuple:
    """The shape of one rank's shard of a leaf of ``shape`` and ``spec``."""
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // live.size(a) for n, a in zip(shape, padded))


def _local(t: torch.Tensor, spec, live) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        t = shard(t, entry, live, dim)
    return t.clone(memory_format=torch.contiguous_format)


def distribute(tree, specs, rules: ShardingRules):
    """Each rank's shards of a tree (tensors in dicts, lists or tuples)
    with matching ``specs``: contiguous copies of the local blocks."""
    live = _live(rules)
    if isinstance(tree, torch.Tensor):
        return _local(tree, specs, live)
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], rules) for k, v in tree.items()}
    return type(tree)(distribute(v, s, rules) for v, s in zip(tree, specs))


def distribute_params(params, pspecs: Dict[str, tuple],
                      rules: ShardingRules):
    """The counterpart of ``jit``'s ``in_shardings`` for the parameters:
    a :class:`~repro_torch.models.transformer.Transformer` of this rank's
    shards of ``params`` (the whole model, the same on every rank) by
    ``pspecs`` (:func:`param_pspecs`).  Each parameter keeps its storage
    spec (``mesh_spec``) and its compute-time spec (``compute_spec``), which
    :func:`gather_params_for_compute` reads."""
    live = _live(rules)
    cfg = params.cfg
    compute = param_pspecs(cfg, params, rules, fsdp_override=None)
    local = type(params)(cfg, device="meta")
    for name, p in params.named_parameters():
        new = nn.Parameter(_local(p.detach(), pspecs[name], live),
                           requires_grad=False)
        new.mesh_spec = tuple(pspecs[name])
        new.compute_spec = tuple(compute[name])
        owner, _, leaf = name.rpartition(".")
        setattr(local.get_submodule(owner), leaf, new)
    return local


def _with_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor],
                  prefix: str = "") -> nn.Module:
    """A shallow copy of ``module`` whose parameters named in ``tensors``
    (qualified names) read as those tensors."""
    clone = copy.copy(module)
    params = {n: tensors.get(prefix + n, p)
              for n, p in module._parameters.items()}
    subs = {}
    for n, m in module._modules.items():
        inner = prefix + n + "."
        subs[n] = (_with_tensors(m, tensors, inner) if m is not None
                   and any(k.startswith(inner) for k in tensors) else m)
    object.__setattr__(clone, "_parameters", params)
    object.__setattr__(clone, "_modules", subs)
    return clone


def gathered(p: torch.Tensor) -> torch.Tensor:
    """One weight as the layers compute with it under active rules: the
    fsdp shards of a distributed parameter all-gathered (every axis its
    storage spec ``mesh_spec`` names and its compute-time spec
    ``compute_spec`` does not; the TP shards stay), through the
    autograd-aware all-gather, whose gradient is reduce-scattered back to
    the shards.  ``p`` itself without active rules or with nothing to
    gather."""
    rules = _ACTIVE.get()
    store = getattr(p, "mesh_spec", None)
    want = getattr(p, "compute_spec", None)
    if rules is None or store is None or store == want:
        return p
    live = _live(rules)
    t = p
    for dim, (s, c) in enumerate(zip(store, want)):
        if s != c:
            if c is not None:
                raise ValueError(f"storage spec {store} and compute spec "
                                 f"{want} shard one dimension differently")
            t = mesh_lib.all_gather(t, live, s, dim)
    return t


def gather_params_for_compute(module: nn.Module) -> nn.Module:
    """ZeRO's gather at use: under active rules, a copy of ``module`` whose
    weights read as :func:`gathered` gives them; ``module`` itself without
    active rules or with nothing to gather.  The reference's ``cfg``
    argument has no counterpart: each parameter carries its specs."""
    if _ACTIVE.get() is None:
        return module
    out = {}
    for name, p in module.named_parameters():
        t = gathered(p)
        if t is not p:
            out[name] = t
    return _with_tensors(module, out) if out else module
