"""Task-farm and pipeline runners over a worker mesh (paper §2).

Port of ``repro/core/farm.py``.  The farm maps the paper's emitter /
workers / collector onto a :class:`~repro_torch.core.mesh.WorkerMesh` or a
:class:`~repro_torch.core.mesh.RankMesh`: a stream chunk arrives sharded
over the worker axis (emitter = the mesh's ``shard``, ``[n_local, m //
n_w]``), each worker applies the worker function, and (optionally) a
collector collective merges results.  A gpipe-style pipeline
runner is included for completeness (the paper's other canonical stream
pattern) and exercised at smoke scale.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch.func import vmap

from repro_torch.core.mesh import WorkerMesh
from repro_torch.core.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TaskFarm:
    """Stateless farm: ``ys = map(f, xs)`` with xs sharded over ``axis``.

    ``ordered=False`` reflects the paper's collector-less variant (no global
    reordering); per-shard order is preserved.
    """

    mesh: WorkerMesh
    axis: str

    @property
    def n_workers(self) -> int:
        return self.mesh.shape[self.axis]

    def map(self, f: Callable, xs, *, collector: Optional[Callable] = None):
        """Each worker ``vmap(f)`` over its local items; without a
        collector the ys come back in stream order.

        ``collector(ys_local, mesh)`` differs from the reference's
        ``collector(ys_local, axis)``: it is called once with this
        process's workers' ys stacked (``[n_local, m // n_w, ...]``), not
        once per worker, and merges them with the mesh's collective methods
        (``mesh.psum``, ``mesh.pmin``, ``mesh.pmax``, ``mesh.all_gather``,
        which reduce over dim 0 and, on a rank mesh, across ranks); it
        returns a worker-stacked value whose rows agree, and ``map``
        returns its first row (the reference's replicated ``P()`` output),
        on every rank.  E.g. the reference's ``lambda y, ax:
        lax.psum(jnp.sum(y), ax)`` is ``lambda y, mesh: mesh.psum(y.sum(1))``.
        """
        mesh = self.mesh
        if not mesh.active:
            return mesh.receive()
        ys_local = vmap(vmap(f))(mesh.shard(xs))
        if collector is None:
            return mesh.deliver(mesh.unshard(ys_local))
        return mesh.deliver(tree_map(lambda leaf: leaf[0],
                                     collector(ys_local, mesh)))

    def run_stream(self, step: Callable, stream: Sequence, state, *run_args):
        """Drive a stateful pattern over successive stream chunks.

        ``step(state, chunk) -> (state, out)`` where ``step`` is typically a
        closed-over ``pattern.run(mesh, axis, ...)``.

        Subsumed by :class:`repro_torch.runtime.executor.StreamExecutor`,
        which adds online resizing, metrics and a per-degree step cache;
        this wrapper delegates to the executor module's chunked fold and is
        kept for fixed-degree callers.
        """
        from repro_torch.runtime import executor as _executor  # no cycle

        return _executor.run_stream(step, stream, state, *run_args)


def pipeline_stages(
    stage_fns: Sequence[Callable],
    xs,
    *,
    num_microbatches: int,
):
    """Reference gpipe-style pipeline over stages (paper's pipeline pattern).

    Single-program form: microbatches flow through `stage_fns` with a rolled
    schedule; stage ``i`` processes microbatch ``t - i`` at tick ``t``.  Used
    at smoke scale to validate the schedule math.
    """
    mb = tree_map(
        lambda leaf: leaf.reshape((num_microbatches, -1) + leaf.shape[1:]), xs
    )
    # simple sequential-fill schedule: correctness reference, not a perf model
    outs = []
    for i in range(num_microbatches):
        x = tree_map(lambda leaf: leaf[i], mb)
        for fn in stage_fns:
            x = fn(x)
        outs.append(x)
    return tree_map(lambda *ls: torch.cat(ls, dim=0), *outs)
