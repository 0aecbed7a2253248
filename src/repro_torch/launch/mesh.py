"""Mesh layouts, a live mesh over ``torch.distributed``, and the
collectives the sharded steps run.

Port of ``repro/launch/mesh.py``.  A :class:`MeshLayout` is data: axis
names and sizes, the axes the sharding rules
(:mod:`repro_torch.launch.sharding`) map leaves onto and the dry-run
divides bytes and FLOPs by.  Single pod: ``(16, 16)`` = 256 chips, axes
``("data", "model")``; multi-pod: ``(2, 16, 16)`` = 512 chips, ``("pod",
"data", "model")``, the pod axis pure data parallelism.

:func:`live_mesh` makes a layout live over the ranks of an initialised
process group: a ``DeviceMesh`` (``init_device_mesh`` with the layout's
axis names) and one process group for every set of axes a collective can
run over.  Rank ``r`` sits at the row-major coordinates of ``r`` in the
layout's sizes, the ``DeviceMesh`` convention.  :func:`counting_mesh` is
one rank's view of a layout of any size with no process group: a step
runs on it with ``meta`` tensors (the dry-run's cost count,
:mod:`repro_torch.launch.cost_analysis`), each collective returning a
tensor of its result's shape and counting its wire bytes as on a live
mesh.

The collectives (:func:`all_reduce`, :func:`reduce_out`,
:func:`copy_in`, :func:`all_gather`, :func:`reduce_scatter`,
:func:`all_to_all`) take an axis name or a tuple of names and do nothing
over an axis of size 1.  Each is autograd-aware: the backward of an
``all_gather`` is a ``reduce_scatter`` and the other way round, the
backward of an ``all_to_all`` the reverse ``all_to_all``.  Three kinds of
all-reduce keep the sharded steps' gradients exact:

* :func:`reduce_out` -- all-reduce forward, identity backward: a partial
  sum whose total every rank then uses alike (a row-parallel product's
  output, the loss's share of each data shard);
* :func:`copy_in` -- identity forward, all-reduce backward: a value every
  rank holds alike that the ranks then use for different parts (the input
  of a column-parallel product);
* :func:`all_reduce` -- all-reduce both ways: a sum that every rank uses
  for its own part (the sum of squares of a norm over a sharded width).

The patterns' rank meshes (:class:`repro_torch.core.mesh.RankMesh`) run
over a process group of the first ``g`` ranks, not a layout's axes: for
them :func:`prefix_groups` makes those groups (collectively, once);
:func:`group_all_reduce` (sum, min or max) and :func:`group_all_gather`
take a group and its size (the layout's collectives above run through
them), and :func:`group_all_to_all_rows` moves uneven rows over the world
(the S2 handoff).

Every collective adds its per-rank wire bytes to :data:`WIRE_BYTES` by
family, by the ring formulas of the reference's ``hlo_analysis.py``
(``b`` the bytes of the tensor named, ``n`` the ranks of the group):
all-reduce ``2 b (n-1)/n`` (b its input), all-gather and all-to-all
``b (n-1)/n`` (b their result), reduce-scatter ``b (n-1)/n`` (b its
input); an all-to-all of uneven rows counts the rows a rank receives from
the others.  Gloo runs all four single-tensor collectives on CUDA tensors
(the card's ``torch`` 2.11, probed at two ranks on one card; also the min
and max all-reduces and ``all_to_all_single`` with uneven and zero
splits), so no collective is staged through host memory.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["FAMILIES", "LiveMesh", "MeshLayout", "WIRE_BYTES", "all_gather",
           "all_reduce", "all_to_all", "copy_in", "counting_mesh", "dp_axes",
           "group_all_gather", "group_all_reduce", "group_all_to_all_rows",
           "live_mesh", "make_host_mesh", "make_production_mesh",
           "prefix_groups", "reduce_out", "reduce_scatter",
           "reset_wire_bytes", "wire_bytes"]

#: the collective families the wire-byte counter keeps apart
FAMILIES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
#: per-rank wire bytes by family since the last reset (this process's)
WIRE_BYTES: Dict[str, float] = dict.fromkeys(FAMILIES, 0.0)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A logical mesh: ``axis_names`` with their ``sizes``."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(
                n < 1 for n in self.sizes):
            raise ValueError(f"a layout needs one positive size per axis, "
                             f"got {self.axis_names} x {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as a jax mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of chips."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_host_mesh(tp: int = 1) -> MeshLayout:
    """``(ranks // tp, tp)`` over ``("data", "model")``, the ranks being
    ``torch.distributed``'s world size, or 1 when it is not initialised
    (one card)."""
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if tp < 1 or n % tp:
        raise ValueError(f"tp {tp} does not divide {n} ranks")
    return MeshLayout(("data", "model"), (n // tp, tp))


def dp_axes(layout: MeshLayout) -> Tuple[str, ...]:
    """The data-parallel axes: ``("pod", "data")`` or ``("data",)``."""
    return ("pod", "data") if "pod" in layout.axis_names else ("data",)


# ---------------------------------------------------------------------------
# the live mesh
# ---------------------------------------------------------------------------

class LiveMesh:
    """A :class:`MeshLayout` over the live ranks: ``device_mesh`` (the
    ``DeviceMesh``), this rank's ``coords`` ``{axis: index}``, and a process
    group per set of axes (:meth:`group`).  Given ``coords`` (and no
    groups) it is a counting mesh (:func:`counting_mesh`)."""

    def __init__(self, layout: MeshLayout, device_mesh, groups,
                 coords: Optional[Dict[str, int]] = None):
        self.layout = layout
        self.device_mesh = device_mesh
        self._groups = groups
        self.counting = coords is not None
        if coords is None:
            rest = dist.get_rank()
            coords = {}
            for name, size in reversed(list(zip(layout.axis_names,
                                                layout.sizes))):
                coords[name] = rest % size
                rest //= size
        elif sorted(coords) != sorted(layout.axis_names) or any(
                not 0 <= coords[a] < n for a, n in layout.shape.items()):
            raise ValueError(f"coords {coords} do not lie in {layout.shape}")
        self.coords = {name: coords[name] for name in layout.axis_names}

    def __repr__(self):
        kind = "CountingMesh" if self.counting else "LiveMesh"
        return f"{kind}({self.layout.shape}, coords={self.coords})"

    @property
    def rank(self) -> int:
        """This rank's place in the world: the row-major index of its
        coordinates."""
        r = 0
        for name, size in zip(self.layout.axis_names, self.layout.sizes):
            r = r * size + self.coords[name]
        return r

    def names(self, axis) -> Tuple[str, ...]:
        """``axis`` (None, a name or a tuple of names) as a tuple of the
        names whose size is above 1, in the layout's order."""
        if axis is None:
            return ()
        names = axis if isinstance(axis, tuple) else (axis,)
        unknown = [a for a in names if a not in self.layout.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in {self.layout}")
        order = [self.layout.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"axes {names} are not in the mesh's order "
                             f"{self.layout.axis_names}")
        return tuple(a for a in names if self.layout.shape[a] > 1)

    def size(self, axis) -> int:
        """The ranks spanned by ``axis``."""
        return math.prod(self.layout.shape[a] for a in self.names(axis))

    def index(self, axis) -> int:
        """This rank's position along ``axis`` (the first name outermost):
        which shard of a dimension split over ``axis`` it holds."""
        i = 0
        for a in self.names(axis):
            i = i * self.layout.shape[a] + self.coords[a]
        return i

    def group(self, axis):
        """The process group of this rank's ranks along ``axis`` (ordered as
        :meth:`index`), or None for a single rank."""
        names = self.names(axis)
        return self._groups[names] if names and not self.counting else None


def counting_mesh(layout: MeshLayout,
                  coords: Optional[Dict[str, int]] = None) -> LiveMesh:
    """One rank's view of ``layout`` (any size; ``coords`` ``{axis:
    index}``, rank 0's by default) with no process group: the rules and
    the layers run on it as on a live mesh, on ``meta`` tensors, and every
    collective adds the bytes it would move to :data:`WIRE_BYTES`."""
    if coords is None:
        coords = dict.fromkeys(layout.axis_names, 0)
    return LiveMesh(layout, None, None, coords=dict(coords))


def live_mesh(layout: MeshLayout, device_type: str = "cuda") -> LiveMesh:
    """``layout`` over the ranks of the initialised default process group,
    whose world size must equal ``layout.size``.  Every rank must call it
    (it creates process groups collectively)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("live_mesh needs torch.distributed initialised "
                           "(init_process_group with this layout's size)")
    world = dist.get_world_size()
    if world != layout.size:
        raise ValueError(f"{world} ranks for a layout of {layout.size} "
                         f"({layout.shape})")
    device_mesh = init_device_mesh(device_type, layout.sizes,
                                   mesh_dim_names=layout.axis_names)
    ranks = torch.arange(world).reshape(layout.sizes)
    live = [i for i, n in enumerate(layout.sizes) if n > 1]
    groups = {}
    for k in range(1, len(live) + 1):
        for dims in itertools.combinations(live, k):
            names = tuple(layout.axis_names[i] for i in dims)
            if k == 1:
                groups[names] = device_mesh.get_group(names[0])
                continue
            # the ranks that differ only along ``dims``, one list each
            others = [i for i in range(len(layout.sizes)) if i not in dims]
            moved = ranks.permute(*others, *dims).reshape(
                -1, math.prod(layout.sizes[i] for i in dims))
            groups[names], _ = dist.new_subgroups_by_enumeration(
                [row.tolist() for row in moved])
    return LiveMesh(layout, device_mesh, groups)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def reset_wire_bytes() -> None:
    for k in FAMILIES:
        WIRE_BYTES[k] = 0.0


def wire_bytes() -> Dict[str, float]:
    """A copy of :data:`WIRE_BYTES`."""
    return dict(WIRE_BYTES)


def _count(family: str, nbytes: int, n: int) -> None:
    scale = 2 if family == "all_reduce" else 1
    WIRE_BYTES[family] += scale * nbytes * (n - 1) / n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def group_all_reduce(x, group, n, op="sum"):
    """The sum (or ``op`` ``"min"`` / ``"max"``) of ``x`` over the ``n``
    ranks of ``group``, in a new tensor; counted as an all-reduce.  On
    ``meta`` (a counting mesh) only counted, as every collective below."""
    out = x.contiguous().clone()
    _count("all_reduce", _nbytes(out), n)
    if not out.is_meta:
        dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def group_all_gather(x, group, n, dim=0):
    """The ``n`` ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    _count("all_gather", _nbytes(out), n)
    if not x.is_meta:
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def group_all_to_all_rows(x, send_rows, recv_rows,
                          mesh: Optional[LiveMesh] = None):
    """``x``'s rows cut in ``send_rows[q]`` rows for each rank ``q`` of the
    world, in rank order; returns the rows received, ``recv_rows[q]`` from
    each rank ``q`` in rank order.  The rows a rank keeps are a local copy:
    only those received from the other ranks are counted (as the
    all-to-all's ``b (n-1)/n`` counts them).  This rank is ``mesh``'s when
    given (a counting mesh's coordinates), else the process group's."""
    me = mesh.rank if mesh is not None else dist.get_rank()
    x = x.contiguous()
    out = x.new_empty((sum(recv_rows),) + x.shape[1:])
    row = _nbytes(x[:1]) if x.shape[0] else _nbytes(out[:1])
    WIRE_BYTES["all_to_all"] += row * (sum(recv_rows) - recv_rows[me])
    if not x.is_meta:
        dist.all_to_all_single(out, x, list(recv_rows), list(send_rows))
    return out


def _check_counting(x, mesh) -> None:
    if mesh.counting and not x.is_meta:
        raise ValueError(f"a counting mesh runs meta tensors only, got "
                         f"{x.device}")


def _raw_all_reduce(x, mesh, axis, op="sum"):
    _check_counting(x, mesh)
    return group_all_reduce(x, mesh.group(axis), mesh.size(axis), op)


def _raw_all_gather(x, mesh, axis, dim):
    _check_counting(x, mesh)
    return group_all_gather(x, mesh.group(axis), mesh.size(axis), dim)


def _raw_reduce_scatter(x, mesh, axis, dim):
    _check_counting(x, mesh)
    n = mesh.size(axis)
    x = x.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter of {x.shape[0]} rows over {n} "
                         f"ranks")
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    _count("reduce_scatter", _nbytes(x), n)
    if not x.is_meta:
        dist.reduce_scatter_tensor(out, x, group=mesh.group(axis))
    return out.movedim(0, dim)


def _raw_all_to_all(x, mesh, axis):
    _check_counting(x, mesh)
    n = mesh.size(axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all of {x.shape[0]} slices over {n} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("all_to_all", _nbytes(out), n)
    if not x.is_meta:
        dist.all_to_all_single(out, x, group=mesh.group(axis))
    return out


def prefix_groups(sizes) -> Dict[int, tuple]:
    """For each ``g`` of ``sizes`` (each in ``[1, world]``): the process
    group of the first ``g`` ranks (None for one rank) and the group of
    rank 0 and the ranks from ``g`` on (None when ``g`` is the world), by
    which rank 0 hands the ranks outside the first ``g`` their results.
    Collective: every rank calls it with the same ``sizes``, since
    ``new_group`` is (a group made later on some ranks only would hang)."""
    world = dist.get_world_size()
    out = {}
    for g in sorted(set(sizes)):
        if not 1 <= g <= world:
            raise ValueError(f"a group of {g} ranks in a world of {world}")
        head = tail = None
        if g == world:
            head = dist.group.WORLD
        elif g > 1:
            head = dist.new_group(list(range(g)))
        if g == 1 and world > 1:
            tail = dist.group.WORLD
        elif 1 < g < world:
            tail = dist.new_group([0] + list(range(g, world)))
        out[g] = (head, tail)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, fwd, bwd):
        ctx.mesh, ctx.axis, ctx.bwd = mesh, axis, bwd
        return _raw_all_reduce(x, mesh, axis) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd:
            g = _raw_all_reduce(g, ctx.mesh, ctx.axis)
        return g, None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_raw_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_raw_all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _raw_all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_to_all(g, ctx.mesh, ctx.axis), None, None


def all_reduce(x, mesh: LiveMesh, axis, op: str = "sum"):
    """The sum (or, with ``op="max"``, the maximum, which has no gradient)
    of ``x`` over ``axis``; its gradient is the sum of the gradients over
    ``axis`` (each rank uses the total for its own part)."""
    if mesh.size(axis) == 1:
        return x
    if op == "max":
        return _raw_all_reduce(x.detach(), mesh, axis, op="max")
    return _AllReduce.apply(x, mesh, axis, True, True)


def reduce_out(x, mesh: LiveMesh, axis):
    """The sum of the partial sums ``x`` over ``axis``; the gradient passes
    unchanged (every rank uses the total alike)."""
    if mesh.size(axis) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis, True, False)


def copy_in(x, mesh: LiveMesh, axis):
    """``x`` unchanged; its gradient is the sum of the gradients over
    ``axis`` (the ranks use the value for different parts)."""
    if mesh.size(axis) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis, False, True)


def all_gather(x, mesh: LiveMesh, axis, dim: int):
    """The shards ``x`` of a tensor split along ``dim`` over ``axis``,
    concatenated in :meth:`LiveMesh.index` order; the gradient is
    reduce-scattered back."""
    if mesh.size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def reduce_scatter(x, mesh: LiveMesh, axis, dim: int):
    """The sum of ``x`` over ``axis``, this rank's shard of it along
    ``dim``; the gradient is all-gathered back."""
    if mesh.size(axis) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_to_all(x, mesh: LiveMesh, axis):
    """``x [n, ...]``: slice ``j`` goes to the rank at index ``j`` along
    ``axis``, and slice ``j`` of the result came from it; the gradient
    travels back the same way."""
    if mesh.size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)
