"""A mesh of workers on one device, and the collectives the patterns use.

The reference runs a pattern as a ``jax.shard_map`` over the ``n_w``
devices of a mesh.  Here the ``n_w`` workers share one card: the worker
axis is the **leading tensor dimension**.  A worker-stacked value holds
worker ``w``'s copy at index ``w`` of dim 0, so

* the emitter's sharding ``P(axis)`` of a chunk is :func:`shard`, a
  ``view(n, m // n, ...)``, and worker-local state is a view of the flat
  state (block ownership's ``v.view(n, N // n)``: no copy);
* a replicated value ``P()`` is :func:`replicate`, an ``expand`` (no copy);
* the collectives :func:`psum`, :func:`pmin`, :func:`pmax` and the tiled
  :func:`all_gather` reduce or reshape over dim 0 and return the result
  broadcast to every worker, as ``lax``'s collectives hand every device the
  same value.

Every function maps over pytrees (:mod:`repro_torch.core.tree`).  A
multi-card realization of the same interface over ``torch.distributed`` is
queued in ``ROADMAP.md``.
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device


class WorkerMesh:
    """``n`` workers along ``axis`` on one device: the counterpart of a
    one-axis ``jax.sharding.Mesh``.  ``device=None`` means the CUDA card
    (raises without one); pass ``device="cpu"`` to run on the host."""

    def __init__(self, n: int, axis: str = "workers", device=None):
        if n < 1:
            raise ValueError(f"worker count must be >= 1, got {n}")
        self.n = int(n)
        self.axis = axis
        self.device = resolve_device(device)
        self.shape = {axis: self.n}

    def axis_index(self, axis: str) -> torch.Tensor:
        """Every worker's index along ``axis`` at once: ``[n]`` int64 (each
        worker's ``lax.axis_index``)."""
        return torch.arange(self.shape[axis], device=self.device)

    def put(self, tree):
        """``tree`` with every leaf a tensor on this mesh's device (numpy,
        Python numbers and tensors elsewhere are copied; a tensor already
        there is returned as it is)."""
        return tree_map(lambda leaf: torch.as_tensor(leaf, device=self.device),
                        tree)

    def __repr__(self) -> str:
        return f"WorkerMesh({self.n}, axis={self.axis!r}, device={self.device})"


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


def _broadcast(reduced, like):
    return reduced.unsqueeze(0).expand(like.shape)


def psum(tree):
    """The sum over workers, on every worker; in the leaf's own dtype
    (integers wrap as ``lax.psum``'s do)."""
    return tree_map(
        lambda leaf: _broadcast(leaf.sum(0, dtype=leaf.dtype), leaf), tree)


def pmin(tree):
    """The minimum over workers, on every worker (exact)."""
    return tree_map(lambda leaf: _broadcast(leaf.amin(0), leaf), tree)


def pmax(tree):
    """The maximum over workers, on every worker (exact)."""
    return tree_map(lambda leaf: _broadcast(leaf.amax(0), leaf), tree)


def all_gather(tree):
    """Every worker's shard on every worker, concatenated in worker order
    (``lax.all_gather(..., tiled=True)``): ``[n, k, ...]`` ->
    ``[n, n * k, ...]``."""
    def gather(leaf):
        whole = leaf.reshape((-1,) + leaf.shape[2:])
        return whole.unsqueeze(0).expand((leaf.shape[0],) + whole.shape)

    return tree_map(gather, tree)
