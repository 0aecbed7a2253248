"""Meshes of workers, and the collectives the patterns use.

The reference runs a pattern as a ``jax.shard_map`` over the ``n_w``
devices of a mesh.  Here a process steps its workers together: the worker
axis is the **leading tensor dimension**, and a worker-stacked value holds
worker ``w``'s copy at index ``w`` of dim 0.  A pattern calls its mesh's
methods, so it runs unchanged on either mesh.

:class:`RankMesh` lays the ``n_w`` workers over the ranks of the
initialised ``torch.distributed`` process group, each rank on its own
device.  At degree ``n`` over ``R`` ranks it takes the first ``g`` ranks,
``g`` the largest divisor of ``n`` not above ``R``: rank ``r < g`` holds
workers ``[r n/g, (r+1) n/g)`` as its local dim 0 (one worker a rank, the
reference's layout, when ``R = n``), so

* the emitter's sharding ``P(axis)`` of a chunk is :meth:`~RankMesh.shard`:
  this rank's workers' rows, ``[n_local, m // n, ...]``;
* a replicated value ``P()`` is :meth:`~RankMesh.replicate`, an
  ``expand`` (no copy);
* the collectives ``psum``, ``pmin``, ``pmax`` and the tiled
  ``all_gather`` reduce or reshape over the local dim 0 first, then make
  one collective over the group of the first ``g`` ranks (counted in
  ``launch.mesh.WIRE_BYTES`` by family), and return the result broadcast
  to every local worker, as ``lax``'s collectives hand every device the
  same value.

The ranks from ``g`` on are *idle*: a pattern's ``run`` hands them its
outputs from rank 0 (:meth:`RankMesh.deliver` / :meth:`RankMesh.receive`,
counted in :data:`IDLE_BYTES`).

:class:`WorkerMesh` is a rank mesh over a world of this process alone: all
``n_w`` workers on one device, ``g = 1``, no process group and no
collective.  The module-level functions are its collectives and map over
pytrees (:mod:`repro_torch.core.tree`).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device

#: bytes this process received from rank 0 as an idle rank
IDLE_BYTES: Dict[str, float] = {"broadcast": 0.0}

#: the groups of a world of one process: no group of the first g ranks,
#: no idle ranks to hand outputs to (``prefix_groups``' form)
_ALONE = {1: (None, None)}

#: each collective's reduction over the local dim 0
_LOCAL = {"sum": lambda x: x.sum(0, dtype=x.dtype),
          "min": lambda x: x.amin(0), "max": lambda x: x.amax(0)}


def _reduce(tree, op, group=None, size=1):
    """``op`` over dim 0, then over the ``size`` ranks of ``group``; the
    result broadcast to every worker of dim 0."""
    def one(leaf):
        part = _LOCAL[op](leaf)
        if size > 1:
            from repro_torch.launch.mesh import group_all_reduce

            part = group_all_reduce(part, group, size, op)
        return part.unsqueeze(0).expand(leaf.shape)

    return tree_map(one, tree)


def _all_gather(tree, group=None, size=1):
    """``[k, c, ...]`` -> ``[k, size * k * c, ...]``: the workers' shards
    of every rank of ``group`` in worker order, on every worker."""
    def gather(leaf):
        whole = leaf.reshape((-1,) + leaf.shape[2:])
        if size > 1:
            from repro_torch.launch.mesh import group_all_gather

            whole = group_all_gather(whole, group, size)
        return whole.unsqueeze(0).expand((leaf.shape[0],) + whole.shape)

    return tree_map(gather, tree)


def shard(tree, n: int):
    """The emitter: each leaf ``[m, ...]`` viewed as ``[n, m // n, ...]``."""
    return tree_map(
        lambda leaf: leaf.reshape((n, leaf.shape[0] // n) + leaf.shape[1:]),
        tree)


def unshard(tree):
    """The workers' shards ``[n, k, ...]`` concatenated in worker order
    (an out_spec ``P(axis)``): ``[n * k, ...]``."""
    return tree_map(lambda leaf: leaf.reshape((-1,) + leaf.shape[2:]), tree)


def replicate(tree, n: int):
    """Every worker holds the same value: ``[...]`` -> ``[n, ...]``."""
    return tree_map(lambda leaf: leaf.unsqueeze(0).expand(
        (n,) + leaf.shape), tree)


def psum(tree):
    """The sum over workers, on every worker; in the leaf's own dtype
    (integers wrap as ``lax.psum``'s do)."""
    return _reduce(tree, "sum")


def pmin(tree):
    """The minimum over workers, on every worker (exact)."""
    return _reduce(tree, "min")


def pmax(tree):
    """The maximum over workers, on every worker (exact)."""
    return _reduce(tree, "max")


def all_gather(tree):
    """Every worker's shard on every worker, concatenated in worker order
    (``lax.all_gather(..., tiled=True)``): ``[n, k, ...]`` ->
    ``[n, n * k, ...]``."""
    return _all_gather(tree)


def prefix_size(n: int, world: int) -> int:
    """The ranks a degree-``n`` rank mesh takes over a world of ``world``:
    the largest divisor of ``n`` not above ``world``."""
    return max(d for d in range(1, min(n, world) + 1) if n % d == 0)


class RankMesh:
    """``n`` workers along ``axis`` over the ranks of a process group (see
    the module docstring for the layout).

    ``ranks`` is :func:`~repro_torch.launch.mesh.prefix_groups`'s result
    and must hold this degree's group of the first ``g`` ranks (a factory
    makes every degree's once, collectively: ``new_group`` is collective,
    and a group made later on some ranks only would hang).  It is required
    over an initialised process group; without one (``torch.distributed``
    not initialised) the mesh is a world of this process alone, as
    :class:`WorkerMesh` is.  ``device=None`` is this rank's CUDA card (rank
    modulo the cards; raises without one).
    """

    def __init__(self, n: int, axis: str = "workers", device=None,
                 ranks=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            self._lay(n, axis, device, 0, 1, _ALONE)
            return
        if ranks is None:
            raise ValueError("a RankMesh over a process group needs "
                             "ranks=prefix_groups(...), made on every rank")
        rank = dist.get_rank()
        if device is None:  # this rank's card
            resolve_device(None)  # raises without one
            device = torch.device("cuda", rank % torch.cuda.device_count())
        self._lay(n, axis, device, rank, dist.get_world_size(), ranks)

    def _lay(self, n, axis, device, rank, world, ranks):
        if n < 1:
            raise ValueError(f"worker count must be >= 1, got {n}")
        self.n = int(n)
        self.axis = axis
        self.shape = {axis: self.n}
        self.device = resolve_device(device)
        self.rank, self.world = rank, world
        self.g = prefix_size(self.n, world)
        if self.g not in ranks:
            raise ValueError(f"degree {n} needs the group of the first "
                             f"{self.g} ranks, which was not made")
        self._group, self._tail = ranks[self.g]
        self.n_local = self.n // self.g
        self.active = rank < self.g

    def __repr__(self) -> str:
        return (f"RankMesh({self.n}, axis={self.axis!r}, rank {self.rank}, "
                f"{self.g} of {self.world} ranks, device={self.device})")

    # -- placement ------------------------------------------------------------
    def axis_index(self, axis: str) -> torch.Tensor:
        """This rank's workers' indices along ``axis`` (each worker's
        ``lax.axis_index``): ``[n_local]`` int64."""
        lo = self.rank * self.n_local
        return torch.arange(lo, lo + self.n_local, device=self.device)

    def put(self, tree):
        """``tree`` with every leaf a tensor on this mesh's device (numpy,
        Python numbers and tensors elsewhere are copied; a tensor already
        there is returned as it is)."""
        return tree_map(lambda leaf: torch.as_tensor(leaf, device=self.device),
                        tree)

    def ingest(self, chunk):
        """A stream chunk as the executor hands it to a step: a process
        that holds every worker takes it to its device whole, once; on a
        rank of several, it stays where the caller has it and
        :meth:`shard` copies this rank's rows only."""
        return self.put(chunk) if self.g == 1 and self.active else chunk

    def block(self, length: int):
        """The ``[start, stop)`` of a length split over the workers in
        worker order that this rank's workers hold (empty when idle)."""
        if length % self.g:
            raise ValueError(f"{length} does not split over {self.g} ranks")
        if not self.active:
            return 0, 0
        size = length // self.g
        return self.rank * size, (self.rank + 1) * size

    # -- the emitter and the out_specs ---------------------------------------
    def shard(self, tree):
        """The emitter: this rank's workers' rows of each leaf ``[m, ...]``
        on its device, as ``[n_local, m // n, ...]``."""
        def mine(leaf):
            lo, hi = self.block(len(leaf))
            return torch.as_tensor(leaf[lo:hi], device=self.device)

        return shard(tree_map(mine, tree), self.n_local)

    def unshard(self, tree):
        """``[n_local, k, ...]`` on each rank -> every worker's shards in
        worker order, ``[n * k, ...]``, on every rank of the group."""
        return tree_map(lambda leaf: leaf[0], self.all_gather(tree))

    def replicate(self, tree):
        return replicate(tree, self.n_local)

    # -- collectives ------------------------------------------------------------
    def psum(self, tree):
        """The sum over all ``n`` workers on each, in the leaf's dtype
        (integers wrap modulo their width, as ``lax.psum``'s do)."""
        return _reduce(tree, "sum", self._group, self.g)

    def pmin(self, tree):
        return _reduce(tree, "min", self._group, self.g)

    def pmax(self, tree):
        return _reduce(tree, "max", self._group, self.g)

    def all_gather(self, tree):
        """``[n_local, k, ...]`` -> ``[n_local, n * k, ...]``: every worker's
        shard on every worker, in worker order."""
        return _all_gather(tree, self._group, self.g)

    # -- the idle ranks -------------------------------------------------------
    def deliver(self, out):
        """``out`` (this active rank's result, the same on every active
        rank) handed to the idle ranks by rank 0; returns ``out``."""
        if self._tail is None or self.rank != 0:
            return out
        import torch.distributed as dist

        spec = tree_map(lambda t: _Leaf(tuple(t.shape), str(t.dtype)[6:]),
                        out)
        dist.broadcast_object_list([spec], src=0, group=self._tail)
        for t in tree_leaves(out):
            dist.broadcast(t.contiguous(), src=0, group=self._tail)
        return out

    def receive(self):
        """On an idle rank: what rank 0's :meth:`deliver` hands over."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self._tail)

        def alloc(spec):
            t = torch.empty(spec.shape, dtype=getattr(torch, spec.dtype),
                            device=self.device)
            dist.broadcast(t, src=0, group=self._tail)
            IDLE_BYTES["broadcast"] += t.numel() * t.element_size()
            return t

        # leaves in tree_leaves order: the order deliver sent them in
        return tree_map(alloc, box[0])


class WorkerMesh(RankMesh):
    """``n`` workers along ``axis`` on one device: the counterpart of a
    one-axis ``jax.sharding.Mesh``, a rank mesh over a world of this
    process alone whether or not a process group is initialised.
    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` to run on the host."""

    def __init__(self, n: int, axis: str = "workers", device=None):
        self._lay(n, axis, device, 0, 1, _ALONE)

    def __repr__(self) -> str:
        return f"WorkerMesh({self.n}, axis={self.axis!r}, device={self.device})"


class _Leaf:
    """A tensor's shape and dtype name, as :meth:`RankMesh.deliver` sends
    them ahead of the tensor."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype
