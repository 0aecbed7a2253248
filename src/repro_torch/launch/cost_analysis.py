"""One rank's step counted on ``meta``: the port's counterpart of the
reference's ``launch/hlo_analysis.py``.

The reference reads XLA's partitioned HLO text, whose shapes are one
partition's, and sums per chip: the FLOPs (2 M N K per ``dot``, one per
element of other operations), the HBM bytes (operands and results at every
fusion boundary) and the collectives' wire bytes by the ring formulas.
Eager PyTorch has no such text, but the same three numbers come from
running one rank's step once on ``meta`` tensors under
:func:`analyze_step`'s ``TorchDispatchMode``:

* every aten operation that is not a view adds its operand and result
  bytes (eager's kernel boundaries stand where XLA's fusion boundaries do;
  views, ``detach`` and the allocations themselves are free, as the
  reference's ``_FREE_OPS``; a gather reads only its region and an
  in-place scatter, such as a KV cache's new row, writes only its update,
  as the reference counts gathers and dynamic-update-slices), the
  products of ``mm``, ``bmm``, ``addmm``
  and ``baddbmm`` 2 M N K FLOPs (``torch.utils.flop_counter``'s formulas),
  and every other operation that computes one FLOP per element of its
  result (data movement none);
* each hand kernel counts as the one launch the card makes: inside the
  count its CUDA wrapper runs on ``meta``, allocates what it allocates on
  the card and adds the kernel's closed form
  (:mod:`repro_torch.kernels.costs`) instead of launching
  (``kernels/ops.py``'s :func:`~repro_torch.kernels.ops.cost_count`); in
  ops mode ``ref`` the plain versions run and are counted op by op, as
  ``FlopCounterMode`` counts them;
* the collectives of the step's mesh (a :func:`~repro_torch.launch.mesh.
  counting_mesh` of any layout, or none) add their wire bytes by family
  (``mesh.WIRE_BYTES``, the reference's ring formulas);
* the live ``meta`` bytes above the arguments are tracked through weak
  references on the results' storages, so a freed activation leaves the
  count: their high-water mark is the step's peak temp bytes, the
  counterpart of the reference's ``memory_analysis`` temps.

:class:`CostSummary` has the reference's fields plus ``peak_bytes``,
``kernel_launches`` (entry -> launches) and the argument and output bytes.
Every loop iteration runs, so there are no trip counts to recover.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import costs, ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.optim import adamw

__all__ = ["CostSummary", "PRODUCT_OPS", "analyze_step", "count_cell",
           "rank_inputs", "tensors_of"]

#: the operators whose FLOPs are products (the reference's ``dot``)
PRODUCT_OPS = ("mm", "bmm", "addmm", "baddbmm")
#: bookkeeping: no bytes, no FLOPs
FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
    "resize_", "_local_scalar_dense", "_unsafe_view"})
#: data movement: bytes, no FLOPs
MOVEMENT_OPS = frozenset({
    "copy_", "_to_copy", "clone", "cat", "stack", "constant_pad_nd",
    "repeat", "repeat_interleave", "fill_", "zero_", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones",
    "new_full", "arange", "slice_scatter", "select_scatter", "flip", "roll",
    "narrow_copy", "expand_copy", "scalar_tensor", "masked_select"})
#: reads of a region of the first operand: the region (the result) read
#: and written, and the indices, as the reference's gather and slices
GATHER_OPS = frozenset({"index", "_unsafe_index", "index_select", "gather",
                        "embedding"})
#: in-place writes of a region of the first operand (a KV cache row): the
#: update read and written into the region, and the indices, as the
#: reference's scatter and dynamic-update-slice; the adds one FLOP an
#: element of the update
SCATTER_OPS = frozenset({"index_put", "index_put_", "_index_put_impl_",
                         "index_copy", "index_copy_", "masked_scatter",
                         "masked_scatter_", "scatter", "scatter_"})
SCATTER_ADD_OPS = frozenset({"scatter_add", "scatter_add_", "index_add",
                             "index_add_"})


@dataclasses.dataclass
class CostSummary:
    """Per-chip costs of one step (the reference's ``CostSummary`` and
    more): ``flops`` and ``dot_flops`` (products), ``hbm_bytes``,
    ``collective_bytes`` and its ``collective_breakdown`` by family,
    ``num_partitions`` (the layout's chips), ``warnings``; ``peak_bytes``
    (the high-water mark of live bytes above the arguments),
    ``argument_bytes``, ``output_bytes`` and ``kernel_launches``."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_flops: float = 0.0
    num_partitions: int = 1
    warnings: List[str] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def global_flops(self) -> float:
        return self.flops * self.num_partitions

    @property
    def global_hbm_bytes(self) -> float:
        return self.hbm_bytes * self.num_partitions

    @property
    def global_collective_bytes(self) -> float:
        return self.collective_bytes * self.num_partitions

    def roofline_ms(self) -> float:
        """The step's least time on one H100: its FLOPs at the bf16
        tensor-core rate or its HBM bytes at the memory rate."""
        return costs.roofline_ms(self.flops, self.hbm_bytes)


def tensors_of(tree) -> List[torch.Tensor]:
    """The tensors of a step's arguments or results: a module's parameters
    and buffers, dicts, lists and tuples of tensors."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes an operation reads of ``t``: the view's, at most its
    storage's (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class _Counter(TorchDispatchMode):
    """The dispatch mode of :func:`analyze_step`."""

    def __init__(self, summary: CostSummary, arguments):
        super().__init__()
        self.s = summary
        # storages that existed before the step: never counted as live
        self.known = {id(t.untyped_storage()): None for t in arguments}
        self._keep = [t.untyped_storage() for t in arguments]
        self.live = {}
        self.live_bytes = 0

    def _free(self, key):
        self.live_bytes -= self.live.pop(key)

    def _track(self, outputs):
        for t in outputs:
            st = t.untyped_storage()
            key = id(st)
            if key in self.known or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.live_bytes += self.live[key]
            weakref.finalize(st, self._free, key)
        self.s.peak_bytes = max(self.s.peak_bytes, self.live_bytes)

    def kernel(self, entry, cost, note):
        self.s.flops += cost.flops
        self.s.dot_flops += cost.products
        self.s.hbm_bytes += cost.bytes
        self.s.kernel_launches[entry] = \
            self.s.kernel_launches.get(entry, 0) + 1
        if note and note not in self.s.warnings:
            self.s.warnings.append(note)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = [t for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)]
        for t in inputs:
            key = id(t.untyped_storage())
            if key not in self.live and key not in self.known:
                # made before the step and not an argument (a constant)
                self.known[key] = None
                self._keep.append(t.untyped_storage())
        out = func(*args, **kwargs)
        outputs = [t for t in tree_flatten(out)[0]
                   if isinstance(t, torch.Tensor)]
        self._track(outputs)
        name = func._overloadpacket.__name__
        if name in FREE_OPS or _is_view(func):
            return out
        if name in GATHER_OPS:
            region = sum(t.numel() * t.element_size() for t in outputs)
            self.s.hbm_bytes += 2 * region + sum(_read_bytes(t)
                                                 for t in inputs[1:])
            return out
        if name in SCATTER_OPS or name in SCATTER_ADD_OPS:
            update = inputs[-1].numel() * inputs[0].element_size()
            self.s.hbm_bytes += 2 * update + sum(_read_bytes(t)
                                                 for t in inputs[1:])
            if name in SCATTER_ADD_OPS:
                self.s.flops += inputs[-1].numel()
            return out
        self.s.hbm_bytes += sum(_read_bytes(t) for t in inputs) \
            + sum(t.numel() * t.element_size() for t in outputs)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.s.flops += f
            if name in PRODUCT_OPS:
                self.s.dot_flops += f
        elif name not in MOVEMENT_OPS and outputs:
            self.s.flops += outputs[0].numel()
        return out


def analyze_step(step, args, *, num_partitions: int = 1) -> CostSummary:
    """Run ``step(*args)`` once on ``meta`` tensors and count it
    (:class:`CostSummary`, per chip: the arguments are one rank's).  The
    hand kernels count as the card's launches (in ops mode ``ref``, their
    plain versions op by op).  ``mesh.WIRE_BYTES`` is left as it was."""
    arguments = tensors_of(args)
    off = [t.device for t in arguments if not t.is_meta]
    if off:
        raise ValueError(f"analyze_step runs meta tensors only, got {off[0]}")
    summary = CostSummary(num_partitions=num_partitions,
                          argument_bytes=_storage_bytes(arguments))
    wire0 = mesh_lib.wire_bytes()
    counter = _Counter(summary, arguments)
    try:
        with counter, ops.cost_count(counter.kernel):
            out = step(*args)
        summary.output_bytes = _storage_bytes(tensors_of(out))
        del out
    finally:
        wire = mesh_lib.wire_bytes()
        mesh_lib.WIRE_BYTES.update(wire0)
    summary.collective_breakdown = {k: wire[k] - wire0[k]
                                    for k in mesh_lib.FAMILIES}
    summary.collective_bytes = sum(summary.collective_breakdown.values())
    return summary


def rank_inputs(cell: steps.Cell) -> dict:
    """One rank's arguments of ``cell``'s step on ``meta``, in its order:
    under live rules (a counting mesh's) the shards that
    :func:`~repro_torch.launch.sharding.distribute_params`,
    :func:`~repro_torch.launch.steps.local_zeros` and
    :func:`~repro_torch.launch.sharding.distribute` give, and a training
    cell's AdamW state of those shards; without rules the cell's own meta
    leaves."""
    rules = cell.rules
    if rules is None:
        return dict(cell.specs)
    params = sh.distribute_params(cell.specs["params"],
                                  cell.pspecs["params"], rules)
    out = {"params": params}
    if "opt_state" in cell.specs:
        out["opt_state"] = adamw.init_state(params)
    else:
        out["caches"] = steps.local_zeros(cell.specs["caches"],
                                          cell.pspecs["caches"], rules,
                                          "meta")
    out["batch"] = sh.distribute(cell.specs["batch"], cell.pspecs["batch"],
                                 rules)
    return out


def count_cell(cell: steps.Cell) -> CostSummary:
    """:func:`analyze_step` of ``cell``'s step on :func:`rank_inputs`,
    per chip of its layout."""
    args = rank_inputs(cell)
    layout = cell.rules.live.layout if cell.rules is not None else None
    return analyze_step(cell.step, list(args.values()),
                        num_partitions=layout.size if layout else 1)

