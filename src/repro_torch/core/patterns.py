"""Parallel implementations of the paper's state access patterns (paper §4).

Port of ``repro/core/patterns.py``.  Each pattern is a small, composable
object with three faces:

* ``run(mesh, axis, ...)`` — an SPMD execution of a stream chunk over the
  worker axis of a :class:`~repro_torch.core.mesh.WorkerMesh` (every
  worker on one card) or a :class:`~repro_torch.core.mesh.RankMesh` (the
  workers in blocks over ``torch.distributed`` ranks).  Where the
  reference's ``shard_map`` runs the worker program once per device, here
  each process steps its workers together as the leading tensor dimension,
  with every per-item user function ``torch.func.vmap``-ed over them: the
  farm's *emitter* is the mesh's ``shard`` of the chunk (``[n_local, m //
  n_w]``), and the *collector* (the paper's mutually-exclusive
  global-state commit) is the mesh's collective (``psum``, ``pmin``,
  ``all_gather``), over dim 0 and then, on a rank mesh, across ranks.
  Outputs leave ``run`` as the reference's global arrays, on every rank
  (an out_spec ``P(axis)`` is the mesh's ``unshard``); the ranks a rank
  mesh leaves idle get them from rank 0 (``deliver`` / ``receive``).
* ``reference(...)`` — the serial oracle (delegates to
  :mod:`repro_torch.core.semantics`).
* adaptivity helpers — the paper's §4.x "Adaptivity" protocols: repartition /
  merge / re-init state when the parallelism degree changes.

User callables are the reference's: per-item functions of tensors, pure,
with no Python branch on a tensor's value (``lax.cond`` becomes
``torch.where``, so both branches run).  Whatever ``zero()``, ``s_init`` or
``v0`` return — numpy, a Python number, a tensor on the host — is moved to
the mesh's device once per ``run``; the caller's state is never modified.
``run`` reads nothing back to the host inside its loops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import semantics
from repro_torch.core.mesh import WorkerMesh
from repro_torch.core.tree import scan, tree_leaves, tree_map

# The reference's ``_pvary`` / ``_unvary`` re-type values for JAX's
# device-varying type system inside ``shard_map``; worker-stacked tensors
# carry no such type, so they have no counterpart here.


def _axis_size(mesh: WorkerMesh, axis: str) -> int:
    return mesh.shape[axis]


def _blocks(xs_w, size: int):
    """Worker-stacked items ``[n, k, ...]`` cut into blocks of ``size``
    along the scan axis, scan axes first: ``[k // size, n, size, ...]``."""
    return tree_map(lambda leaf: leaf.reshape(
        (leaf.shape[0], -1, size) + leaf.shape[2:]).movedim(1, 0), xs_w)


def _by_step(tree):
    """Worker-stacked items ``[n, k, ...]`` as ``k`` steps of ``[n, ...]``."""
    return tree_map(lambda leaf: leaf.movedim(1, 0), tree)


def _by_worker(tree, scan_dims: int):
    """A scanned worker-stacked output ``[s_1, ..., s_d, n, ...]`` as each
    worker's outputs in its stream order: ``[n, s_1 * ... * s_d, ...]``."""
    return tree_map(lambda leaf: leaf.movedim(scan_dims, 0).reshape(
        (leaf.shape[scan_dims], -1) + leaf.shape[scan_dims + 1:]), tree)


def _mask(cond, leaf):
    """``cond`` ``[n]`` shaped to broadcast over ``leaf`` ``[n, ...]``."""
    return cond.reshape(cond.shape + (1,) * (leaf.dim() - cond.dim()))


# ---------------------------------------------------------------------------
# §4.1 Serial
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SerialState:
    """The degenerate pattern: state serializes the whole computation.

    Kept as (a) the semantic oracle and (b) an honest implementation — the
    paper's point is that this class admits *no* parallelism, so ``run``
    is simply the sequential fold, on the mesh's device.
    """

    f: Callable
    ns: Callable

    def reference(self, xs, s0):
        return semantics.serial(self.f, self.ns, xs, s0)

    def run(self, mesh: WorkerMesh, axis: str, xs, s0):
        # State dependence chains every task: no decomposition is sound.
        return semantics.serial(self.f, self.ns, mesh.put(xs), mesh.put(s0))


# ---------------------------------------------------------------------------
# §4.2 Fully partitioned
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionedState:
    """State is a vector ``v[0..N)``; ``h`` maps tasks to slots; every slot
    has exactly one owning worker (paper §4.2).

    Two ownership modes:

    * ``ownership="block"`` (the paper's distribution): slot ``p`` is owned
      by ``p // (N // n_w)``; only divisors of ``num_slots`` are feasible
      degrees, and each worker's state is its block: a view of the flat
      vector.
    * ``ownership="slotmap"`` (generalized, `repro_torch.keyed`-style):
      ownership is an explicit balanced slot -> owner table
      (``owner(p) = (p * n_w) // N``), so **any** degree in
      ``[1, num_slots]`` is feasible; the state vector is replicated
      (``[n_w, N]``) and each worker commits only its owned slots
      (reassembled by `psum`).

    ``run`` routes every task to its owner: each worker scans the *whole*
    stream chunk in order, masking in the tasks it owns.  Per-slot update
    order equals stream order (the paper's guarantee), outputs are exchanged
    with a `psum` (each task is computed by exactly one worker).  This is the
    semantically-exact farm; the high-throughput realization (the
    `repro_torch.keyed` sort+segment-reduce plane) is tested against it.
    """

    f: Callable
    ns: Callable
    h: Callable
    num_slots: int
    ownership: str = "block"   # "block" | "slotmap"

    def __post_init__(self):
        if self.ownership not in ("block", "slotmap"):
            raise ValueError(f"unknown ownership mode {self.ownership!r}")

    def reference(self, xs, v0):
        return semantics.partitioned(self.f, self.ns, self.h, xs, v0)

    # -- ownership -----------------------------------------------------------
    def slots_per_worker(self, n_w: int) -> int:
        if n_w < 1:
            raise ValueError(f"worker count must be >= 1, got {n_w}")
        if self.num_slots % n_w:
            raise ValueError(
                f"block ownership needs num_slots % n_w == 0: "
                f"num_slots={self.num_slots} does not divide over {n_w} workers "
                f"(remainder {self.num_slots % n_w}); choose a worker count "
                f"from the divisors of {self.num_slots}"
            )
        return self.num_slots // n_w

    def owner_table(self, n_w: int) -> np.ndarray:
        """slot -> owner, length ``num_slots``.  Balanced-contiguous in
        slotmap mode (reduces to the block rule when ``n_w`` divides);
        the block rule (validated) otherwise."""
        if self.ownership == "slotmap":
            if not 1 <= n_w <= self.num_slots:
                raise ValueError(
                    f"worker count must be in [1, {self.num_slots}], got {n_w}"
                )
            return ((np.arange(self.num_slots, dtype=np.int64) * n_w)
                    // self.num_slots).astype(np.int32)
        return (np.arange(self.num_slots) // self.slots_per_worker(n_w)
                ).astype(np.int32)

    def owner(self, slot, n_w: int):
        if self.ownership == "slotmap":
            return (slot * n_w) // self.num_slots
        return slot // self.slots_per_worker(n_w)

    def validate_degree(self, n_w: int) -> None:
        self.owner_table(n_w)  # raises on an infeasible degree

    def feasible_degrees(self, max_degree: int) -> list:
        """Degrees this ownership mode admits — the autoscaler's clamp.
        Derived from :meth:`validate_degree` so the feasibility rule has a
        single source of truth."""
        out = []
        for n in range(1, min(max_degree, self.num_slots) + 1):
            try:
                self.validate_degree(n)
            except ValueError:
                continue
            out.append(n)
        return out

    # -- SPMD execution -------------------------------------------------------
    def run(self, mesh: WorkerMesh, axis: str, xs, v0):
        """xs sharded over ``axis`` (emitter); v0 the flat state vector
        (block mode: each rank's workers start from their block of it;
        slotmap mode: replicated).  Returns ``(ys, v_final)``: the workers'
        ys in stream order and the flat final vector, on every rank.
        ``v0`` is not modified."""
        if self.ownership == "slotmap":
            return self._run_slotmap(mesh, axis, xs, v0)
        if not mesh.active:
            return mesh.receive()
        lo, hi = mesh.block(self.num_slots)
        ys, v_block = self._scan_block(
            mesh, axis, xs, tree_map(lambda leaf: leaf[lo:hi], v0))
        spw = self.slots_per_worker(mesh.shape[axis])
        # out_spec P(axis): the workers' blocks gathered in worker order
        v_final = mesh.unshard(tree_map(
            lambda leaf: leaf.view((-1, spw) + leaf.shape[1:]), v_block))
        return mesh.deliver((ys, v_final))

    def run_block(self, mesh: WorkerMesh, axis: str, xs, v_block):
        """Block mode on this rank's block of the state, ``v_block`` (the
        slots ``mesh.block(num_slots)``: every slot on one card, the rank's
        workers' slots on a rank mesh).  Returns ``(ys, v_block_final)``:
        the ys in stream order on every rank (an idle rank receives them
        and keeps its empty block); ``v_block`` is not modified.  The
        executor keeps the state partitioned between chunks this way."""
        if not mesh.active:
            return mesh.receive(), v_block
        ys, v_block = self._scan_block(mesh, axis, xs, v_block)
        return mesh.deliver(ys), v_block

    def _scan_block(self, mesh, axis, xs, v_block):
        n_w = _axis_size(mesh, axis)
        spw = self.slots_per_worker(n_w)
        f, ns, h = self.f, self.ns, self.h
        per_worker_f = vmap(f, in_dims=(None, 0))
        per_worker_ns = vmap(ns, in_dims=(None, 0))
        w = mesh.axis_index(axis)
        rows = torch.arange(mesh.n_local, device=mesh.device)
        base = w * spw
        v_local = tree_map(
            lambda leaf: leaf.view((mesh.n_local, spw) + leaf.shape[1:]),
            tree_map(torch.clone, mesh.put(v_block)))
        # all_gather(tiled) of the emitter's shards gives every worker the
        # whole chunk, in stream order; the copies are identical, so one
        # serves all of a process's workers, and so does the slot h
        # computes from it
        xs_all = tree_map(lambda leaf: leaf[0],
                          mesh.all_gather(mesh.shard(xs)))

        def step(v, x):
            slot = h(x)
            mine = (slot // spw) == w
            local_slot = torch.where(mine, slot - base, 0).long()
            sp = tree_map(lambda leaf: leaf[rows, local_slot], v)
            y = per_worker_f(x, sp)
            new_sp = per_worker_ns(x, sp)
            tree_map(lambda leaf, nl, old: leaf.index_put_(
                (rows, local_slot), semantics.select(mine, nl, old)),
                v, new_sp, sp)
            y = tree_map(lambda leaf: torch.where(_mask(mine, leaf), leaf, 0),
                         y)
            return v, y

        v_local, ys_all = scan(step, v_local, xs_all)
        # each y computed by exactly one worker -> psum reassembles stream;
        # worker w hands back its emitter slice ys[w*c:(w+1)*c], and the
        # slices in worker order are the whole reassembled stream
        ys_all = mesh.psum(tree_map(lambda leaf: leaf.movedim(1, 0), ys_all))
        return (tree_map(lambda leaf: leaf[0], ys_all),
                tree_map(lambda leaf: leaf.reshape((-1,) + leaf.shape[2:]),
                         v_local))

    def _run_slotmap(self, mesh: WorkerMesh, axis: str, xs, v0):
        """Slot-map ownership run: the state vector is replicated, each
        worker scans the chunk committing only its owned slots, and the
        final vector is reassembled slot-by-slot from the owners (exactly
        one worker contributes each slot, so `psum` of the masked vectors
        is exact)."""
        if not mesh.active:
            return mesh.receive()
        n_w = _axis_size(mesh, axis)
        table = torch.as_tensor(self.owner_table(n_w), device=mesh.device)
        f, ns, h = self.f, self.ns, self.h
        per_worker_f = vmap(f, in_dims=(None, 0))
        per_worker_ns = vmap(ns, in_dims=(None, 0))
        w = mesh.axis_index(axis)
        v_rep = tree_map(torch.clone, mesh.replicate(mesh.put(v0)))
        # the gathered chunk, as in block mode
        xs_all = tree_map(lambda leaf: leaf[0],
                          mesh.all_gather(mesh.shard(xs)))

        def step(v, x):
            slot = h(x).reshape(1).long()
            mine = table.index_select(0, slot) == w
            sp = tree_map(lambda leaf: leaf.index_select(1, slot).squeeze(1),
                          v)
            y = per_worker_f(x, sp)
            new_sp = per_worker_ns(x, sp)
            tree_map(lambda leaf, nl, old: leaf.index_copy_(
                1, slot, semantics.select(mine, nl, old).unsqueeze(1)),
                v, new_sp, sp)
            y = tree_map(lambda leaf: torch.where(_mask(mine, leaf), leaf, 0),
                         y)
            return v, y

        v_scanned, ys_all = scan(step, v_rep, xs_all)
        ys_all = mesh.psum(tree_map(lambda leaf: leaf.movedim(1, 0), ys_all))
        own = table.unsqueeze(0) == w.unsqueeze(1)
        v_final = mesh.psum(tree_map(
            lambda leaf: torch.where(_mask(own, leaf), leaf, 0), v_scanned))
        return mesh.deliver((tree_map(lambda leaf: leaf[0], ys_all),
                             tree_map(lambda leaf: leaf[0], v_final)))

    # -- adaptivity (paper §4.2): repartition slots over a new worker count ---
    @staticmethod
    def reshard(v: Any, n_old: int, n_new: int) -> Any:
        """Block repartitioning of the state vector onto ``n_new`` workers.

        With block ownership the repartition is a pure re-slicing: worker ``i``
        of the new farm owns slots ``[i*N/n_new, (i+1)*N/n_new)``; the handoff
        volume matches the paper's neighbour-transfer accounting.  Returns the
        (logically identical) state vector — on one card the new degree's
        ``run`` views the same flat vector in its new blocks.
        """
        del n_old, n_new  # block layout: value is placement-invariant
        return v

    @staticmethod
    def handoff_volume(num_slots: int, n_old: int, n_new: int) -> int:
        """Number of slots that change owner when n_old -> n_new (paper's
        adaptivity cost).

        Both degrees must divide ``num_slots`` — with a ragged block size the
        floor-division owner map silently mis-assigns the tail slots, so the
        count would be wrong rather than approximate.
        """
        for name, n in (("n_old", n_old), ("n_new", n_new)):
            if n < 1:
                raise ValueError(f"{name} must be >= 1, got {n}")
            if num_slots % n:
                raise ValueError(
                    f"handoff accounting needs num_slots % {name} == 0: "
                    f"num_slots={num_slots}, {name}={n} "
                    f"(remainder {num_slots % n})"
                )
        old_owner = np.arange(num_slots) // (num_slots // n_old)
        new_owner = np.arange(num_slots) // (num_slots // n_new)
        return int(np.sum(old_owner != new_owner))

    def transition_volume(self, n_old: int, n_new: int) -> int:
        """Slots changing owner for *this* pattern's ownership mode.

        Block mode delegates to :meth:`handoff_volume` (divisor degrees
        only); slotmap mode diffs the canonical balanced tables — each
        degree's step uses the canonical table, so a transition moves
        exactly the slots on which the two tables disagree.
        """
        if self.ownership == "slotmap":
            return int(
                np.sum(self.owner_table(n_old) != self.owner_table(n_new))
            )
        return self.handoff_volume(self.num_slots, n_old, n_new)


# ---------------------------------------------------------------------------
# §4.3 Accumulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AccumulatorState:
    """``s = g(x) (+) s`` with associative+commutative ``(+)``.

    Workers keep local accumulators initialized to the identity and flush to
    the collector every ``flush_every`` tasks; the collector *is* a `psum`
    over the worker axis, and the reduced value arriving at every worker is
    the paper's collector->emitter->workers feedback broadcast.

    ``flush_every`` trades collector pressure against staleness of the view
    read by ``f`` — the paper's Fig. 4 knob, and exactly the gradient
    accumulation period in the training substrate.
    """

    f: Callable           # f : alpha x gamma -> beta, reads the *view*
    g: Callable           # g : alpha -> gamma
    combine: Callable     # (+)
    zero: Callable        # () -> gamma identity

    def reference(self, xs):
        return semantics.accumulator(self.f, self.g, self.combine, xs, self.zero())

    def run(self, mesh: WorkerMesh, axis: str, xs, flush_every: int, s0=None):
        """xs sharded over ``axis``; returns (ys in stream order, s_global).

        The returned global state is exact (associativity/commutativity);
        per-item ys read the latest flushed global view plus the local
        accumulator — matching the paper's first implementation variant.

        ``s0`` seeds the global view — the long-running runtime threads the
        committed state across successive stream chunks with it, so chunk
        N+1's views include chunk N's flushes.  Defaults to the identity (a
        single-chunk run).
        """
        if not mesh.active:
            return mesh.receive()
        combine = vmap(self.combine)
        f, g = vmap(self.f), vmap(self.g)
        xs_local = mesh.shard(xs)
        m_local = tree_leaves(xs_local)[0].shape[1]
        if m_local % flush_every:
            raise ValueError("flush_every must divide the local chunk size")
        zero = mesh.put(self.zero())  # once: every block starts from it
        acc0 = mesh.replicate(zero)

        def flush_block(s_global_view, x_block):
            def one(acc, x):
                view = combine(acc, s_global_view)
                y = f(x, view)
                return combine(g(x), acc), y

            acc, ys = scan(one, acc0, _by_step(x_block))
            # collector commit: exact because (+) is assoc+comm
            return combine(mesh.psum(acc), s_global_view), ys

        s_init = mesh.replicate(zero if s0 is None else mesh.put(s0))
        s_final, ys = scan(flush_block, s_init, _blocks(xs_local, flush_every))
        return mesh.deliver((mesh.unshard(_by_worker(ys, 2)),
                             tree_map(lambda leaf: leaf[0], s_final)))

    # -- adaptivity (paper §4.3) ----------------------------------------------
    def merge_workers(self, s_i, s_j):
        """Merged worker's accumulator = ``s_i (+) s_j`` (paper's merge rule)."""
        return self.combine(s_i, s_j)

    def new_worker_state(self):
        """New workers start from the identity."""
        return self.zero()


# ---------------------------------------------------------------------------
# §4.4 Successive approximation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SuccessiveApproximationState:
    """Monotone best-so-far state with stale local copies.

    Workers evaluate the condition ``c`` against a *local* copy; proposals are
    committed by a monotone collective (`pmin`/`pmax`) every ``sync_every``
    tasks — non-improving proposals are discarded by the reduction itself,
    which is the collector's monotonic filter.  Stale local copies only cause
    *extra* proposals (paper's third overhead), never wrong final state.
    """

    c: Callable        # c : alpha x gamma -> bool
    s_prime: Callable  # s' : alpha x gamma -> gamma, monotone w.r.t. `better`
    direction: str = "min"  # "min": s' <= s ; "max": s' >= s

    def _commit(self, mesh, s):
        return (mesh.pmin if self.direction == "min" else mesh.pmax)(s)

    def _merge(self, a, b):
        op = torch.minimum if self.direction == "min" else torch.maximum
        return tree_map(op, a, b)

    def reference(self, xs, s_init):
        return semantics.successive_approximation(self.c, self.s_prime, xs, s_init)

    def run(self, mesh: WorkerMesh, axis: str, xs, s_init, sync_every: int):
        """xs sharded over ``axis``; returns (the workers' local traces in
        stream order, s_global)."""
        if not mesh.active:
            return mesh.receive()
        c, s_prime = vmap(self.c), vmap(self.s_prime)
        xs_local = mesh.shard(xs)
        m_local = tree_leaves(xs_local)[0].shape[1]
        if m_local % sync_every:
            raise ValueError("sync_every must divide the local chunk size")

        def one(s, x):
            # lax.cond(c, s', id) per worker: both computed, one selected
            s_new = semantics.select(c(x, s), s_prime(x, s), s)
            return s_new, s_new

        def sync_block(ls, x_block):
            ls, trace = scan(one, ls, _by_step(x_block))
            # collector: monotone commit + feedback broadcast in one collective
            return self._commit(mesh, ls), trace

        s_final, trace = scan(sync_block, mesh.replicate(mesh.put(s_init)),
                              _blocks(xs_local, sync_every))
        return mesh.deliver((mesh.unshard(_by_worker(trace, 2)),
                             tree_map(lambda leaf: leaf[0], s_final)))

    # -- adaptivity (paper §4.4) ----------------------------------------------
    def new_worker_state(self, s_global):
        """New workers join with the current global value (or a safe s_init —
        paper notes both; we hand them the global value to avoid the
        convergence slowdown)."""
        return s_global


# ---------------------------------------------------------------------------
# §4.5 Separate task/state function
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeparateTaskState:
    """``y = f(x)`` embarrassingly parallel; ``s = s(y, s)`` serialized.

    The "mutex section" becomes a collective fold: worker-local ys are
    all-gathered and the commit fold is replayed in canonical stream order,
    yielding a replicated state.  The reference replays it on every shard
    (bit-identical by construction); here each process replays it once,
    and its workers read that one result.

    The speedup bound eq.(1) ``t_f/t_s + 1`` governs this pattern.
    """

    f: Callable  # f : alpha -> beta
    s: Callable  # s : beta x gamma -> gamma

    def reference(self, xs, s0):
        return semantics.separate_task_state(self.f, self.s, xs, s0)

    def run(self, mesh: WorkerMesh, axis: str, xs, s0):
        if not mesh.active:
            return mesh.receive()
        # each worker: vmap(f) over its local items (no state access)
        ys_local = vmap(vmap(self.f))(mesh.shard(xs))
        # every worker's ys in worker order: the stream's (out_spec P(axis))
        ys_all = tree_map(lambda leaf: leaf[0], mesh.all_gather(ys_local))

        def commit(st, y):
            st_new = self.s(y, st)
            return st_new, st_new

        s_final, trace = scan(commit, mesh.put(s0), ys_all)
        # worker w's trace slice is trace[w*c:(w+1)*c]: in worker order,
        # the whole trace
        return mesh.deliver((ys_all, trace, s_final))

    @staticmethod
    def speedup_bound(t_f: float, t_s: float) -> float:
        """Paper eq. (1)."""
        return t_f / t_s + 1.0
