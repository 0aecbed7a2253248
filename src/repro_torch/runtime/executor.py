"""Pattern-agnostic elastic executor.

Port of ``repro/runtime/executor.py``.  A :class:`PatternAdapter` wraps a
state pattern behind a uniform interface the runtime drives over successive
stream chunks:

* ``step(state, chunk)`` — one execution of ``pattern.run`` over a
  :class:`~repro_torch.core.mesh.WorkerMesh` at the current degree (the
  SPMD adapters: S2 :class:`PartitionedAdapter`, S3
  :class:`AccumulatorAdapter`, S4 :class:`SuccessiveAdapter`, S5
  :class:`SeparateAdapter`), or host code that launches its own device work
  (``is_host`` adapters such as the keyed window plane, which get no mesh);
* ``resize(state, n_old, n_new)`` — the pattern's §4.x adaptivity protocol,
  returning the re-placed state and an accounting record.

:class:`StreamExecutor` owns the degree, one mesh per degree, a per-degree
step cache, the live-state attach/detach lifecycle and the optional
double-buffered chunk pipeline.  An SPMD adapter's state is placed on the
mesh's device once (and after a resize) and stays there between chunks;
each chunk is moved there once, as the emitter.

Because every chunk is identical in shape and chunk boundaries are the only
resize points, a run with any schedule of degree changes processes exactly
the same chunks in exactly the same order as a fixed-degree run.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core import patterns
from repro_torch.core.mesh import WorkerMesh
from repro_torch.core.tree import tree_leaves
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.metrics import ChunkRecord, MetricsBus, ResizeRecord


def default_mesh_factory(n: int, axis: str, device=None) -> WorkerMesh:
    """``n`` workers on one device; ``device=None`` is the CUDA card (bind
    ``device="cpu"`` with ``functools.partial`` to run on the host)."""
    return WorkerMesh(n, axis, device)


@dataclasses.dataclass(frozen=True)
class ResizeInfo:
    """What a §4.x transition did (fed to the metrics bus / benchmarks).

    ``handoff_items`` counts ownership units (S2 slots); ``handoff_rows`` /
    ``handoff_bytes`` count the *physical* migration payload when the
    pattern ships state rows between live shards — zero for metadata-only
    transitions.
    """

    protocol: str
    handoff_items: int = 0
    handoff_rows: int = 0
    handoff_bytes: int = 0
    detail: str = ""


class PatternAdapter:
    """Uniform driving interface over a §4 pattern instance."""

    #: per-worker granularity: each worker's local chunk slice must be a
    #: multiple of this (1 except for flush/sync-period patterns)
    granularity: int = 1

    #: observability hook: adapters wrap their internal stages in
    #: ``self.tracer.span(...)``; the executor re-points this at its own
    #: tracer when one is supplied
    tracer = NULL_TRACER

    #: host-driven adapters run their step as plain host code (launching
    #: their own device work) with state as a host pytree: no mesh is
    #: built — the executor switches on this flag
    is_host: bool = False

    #: live-state adapters keep resident state between chunks and are
    #: driven through attach / step_live / resize_live / snapshot_barrier /
    #: detach; the canonical serialized form is materialized ONLY at
    #: checkpoint barriers and explicit state reads
    has_live_state: bool = False

    def validate_degree(self, chunk_size: int, n_w: int) -> None:
        if chunk_size % n_w:
            raise ValueError(
                f"chunk_size={chunk_size} must shard evenly over {n_w} workers"
            )
        if (chunk_size // n_w) % self.granularity:
            raise ValueError(
                f"per-worker slice {chunk_size // n_w} must be a multiple of "
                f"the pattern granularity {self.granularity} "
                f"(chunk_size={chunk_size}, n_w={n_w})"
            )

    def feasible_degrees(self, chunk_size: int, candidates) -> List[int]:
        """Subset of ``candidates`` this pattern can actually run at."""
        out = []
        for n in candidates:
            try:
                self.validate_degree(chunk_size, n)
            except ValueError:
                continue
            out.append(n)
        return out

    def init_state(self):
        raise NotImplementedError

    def make_step(self, mesh: WorkerMesh, axis: str) -> Callable:
        """Return ``(state, chunk) -> (state, out)`` over ``mesh``."""
        raise NotImplementedError

    def make_host_step(self, n_w: int) -> Callable:
        """Host-driven step ``(state, chunk) -> (state, out)``."""
        raise NotImplementedError

    def place(self, state, mesh: Optional[WorkerMesh], axis: str):
        """Place ``state`` for ``mesh`` (the physical handoff); host
        adapters receive ``mesh=None`` and keep state as a host pytree."""
        return state

    def resize(self, state, n_old: int, n_new: int) -> Tuple[Any, ResizeInfo]:
        """Run the pattern's §4.x protocol for a degree change."""
        raise NotImplementedError

    # -- live-state lifecycle (has_live_state adapters only) -------------------
    def attach(self, state, n_w: int) -> None:
        """Build live resident state from the canonical ``state``."""
        raise NotImplementedError

    def detach(self) -> None:
        """Drop live resident state."""
        raise NotImplementedError

    def snapshot_barrier(self):
        """Serialize live state to the canonical form."""
        raise NotImplementedError

    def prepare_chunk(self, chunk):
        """Optional state-independent ingest run ahead of the chunk by the
        executor's pipeline; MUST depend only on the chunk and immutable
        configuration.  Returns an opaque object handed to
        :meth:`step_live` (None = nothing to prepare)."""
        return None

    def step_live(self, chunk, prepared=None):
        """One chunk against the live resident state; returns the output."""
        raise NotImplementedError

    def resize_live(self, n_old: int, n_new: int) -> ResizeInfo:
        """§4.x transition applied directly to live state."""
        raise NotImplementedError


class PartitionedAdapter(PatternAdapter):
    """S2 fully-partitioned state: resize = repartitioning (block handoff,
    or slot-map handoff when the pattern uses slot-map ownership — every
    degree feasible, replicated state vector)."""

    def __init__(self, pattern: patterns.PartitionedState, v0):
        self.pattern = pattern
        self._v0 = v0

    def init_state(self):
        return self._v0

    def validate_degree(self, chunk_size: int, n_w: int) -> None:
        super().validate_degree(chunk_size, n_w)
        self.pattern.validate_degree(n_w)  # mode-appropriate ownership check

    def make_step(self, mesh: WorkerMesh, axis: str) -> Callable:
        def step(v, chunk):
            ys, v = self.pattern.run(mesh, axis, chunk, v)
            return v, ys

        return step

    def place(self, v, mesh: WorkerMesh, axis: str):
        # block mode's P(axis) and slotmap's P() are both the flat vector on
        # the card: ``run`` views it per worker (block) or replicates it
        return mesh.put(v)

    def resize(self, v, n_old: int, n_new: int) -> Tuple[Any, ResizeInfo]:
        moved = self.pattern.transition_volume(n_old, n_new)
        v = self.pattern.reshard(v, n_old, n_new)  # value is placement-invariant
        proto = (
            "S2-slotmap-handoff"
            if self.pattern.ownership == "slotmap"
            else "S2-block-handoff"
        )
        return v, ResizeInfo(
            protocol=proto,
            handoff_items=moved,
            detail=f"{moved}/{self.pattern.num_slots} slots change owner",
        )


class AccumulatorAdapter(PatternAdapter):
    """S3 accumulator: state is the committed global value; resize merges
    (shrink) or identity-initializes (grow) worker-local accumulators.

    Local accumulators are always flushed at chunk boundaries (the chunk's
    trailing flush), so at a resize point the *entire* state is the global
    value: a shrink's merge folds identity elements (recorded for the
    accounting), never loses contributions, and the carried ``s0`` threads
    the committed view into the next chunk's reads.
    """

    def __init__(self, pattern: patterns.AccumulatorState, flush_every: int):
        self.pattern = pattern
        self.flush_every = flush_every
        self.granularity = flush_every

    def init_state(self):
        return self.pattern.zero()

    def make_step(self, mesh: WorkerMesh, axis: str) -> Callable:
        def step(s, chunk):
            ys, s = self.pattern.run(
                mesh, axis, chunk, flush_every=self.flush_every, s0=s
            )
            return s, ys

        return step

    def place(self, s, mesh: WorkerMesh, axis: str):
        return mesh.put(s)

    def resize(self, s, n_old: int, n_new: int) -> Tuple[Any, ResizeInfo]:
        if n_new < n_old:
            # departing workers' accumulators are identities (flushed at the
            # chunk boundary); merging them is exact: s (+) 0 (+) ... (+) 0
            merged = s
            for _ in range(n_old - n_new):
                merged = self.pattern.merge_workers(
                    merged, self.pattern.new_worker_state()
                )
            return merged, ResizeInfo(
                protocol="S3-merge",
                detail=f"merged {n_old - n_new} flushed (identity) accumulators",
            )
        fresh = n_new - n_old
        # growth: new workers start from the identity (paper's init rule)
        return s, ResizeInfo(
            protocol="S3-identity-init",
            detail=f"{fresh} new workers initialized to zero()",
        )


class SuccessiveAdapter(PatternAdapter):
    """S4 successive approximation: state is the committed global best;
    resize hands every (new) worker the global value — the paper's
    join-with-global rule, avoiding the convergence slowdown of s_init."""

    def __init__(
        self,
        pattern: patterns.SuccessiveApproximationState,
        s_init,
        sync_every: int,
    ):
        self.pattern = pattern
        self._s_init = s_init
        self.sync_every = sync_every
        self.granularity = sync_every

    def init_state(self):
        return self._s_init

    def make_step(self, mesh: WorkerMesh, axis: str) -> Callable:
        def step(s, chunk):
            trace, s = self.pattern.run(
                mesh, axis, chunk, s, sync_every=self.sync_every
            )
            # the committed global value is the application-visible output
            return s, {"trace": trace, "committed": s}

        return step

    def place(self, s, mesh: WorkerMesh, axis: str):
        return mesh.put(s)

    def resize(self, s, n_old: int, n_new: int) -> Tuple[Any, ResizeInfo]:
        joined = self.pattern.new_worker_state(s)  # global-value join
        return joined, ResizeInfo(
            protocol="S4-global-join",
            detail=f"workers join with committed global value ({n_old}->{n_new})",
        )


class SeparateAdapter(PatternAdapter):
    """S5 separate task/state: the commit fold is replicated and canonical-
    order, so a degree change needs no state protocol at all."""

    def __init__(self, pattern: patterns.SeparateTaskState, s0):
        self.pattern = pattern
        self._s0 = s0

    def init_state(self):
        return self._s0

    def make_step(self, mesh: WorkerMesh, axis: str) -> Callable:
        def step(s, chunk):
            ys, trace, s = self.pattern.run(mesh, axis, chunk, s)
            return s, {"ys": ys, "trace": trace}

        return step

    def place(self, s, mesh: WorkerMesh, axis: str):
        return mesh.put(s)

    def resize(self, s, n_old: int, n_new: int) -> Tuple[Any, ResizeInfo]:
        return s, ResizeInfo(
            protocol="S5-noop", detail="replicated state: no transfer"
        )


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class StreamExecutor:
    """Drive a pattern adapter over successive chunks with online resizes.

    ``set_degree`` is legal *between* chunks only (chunk boundaries are the
    quiescent points of the paper's protocols: all in-flight tasks of the
    old degree have committed).  Steps are cached per degree, so a degree
    revisited after further resizes reuses its step.  The meshes come from
    ``mesh_factory(n, axis)``, by default ``n`` workers on the CUDA card.
    """

    def __init__(
        self,
        adapter: PatternAdapter,
        *,
        degree: int,
        chunk_size: int,
        axis: str = "workers",
        mesh_factory: Callable[[int, str], WorkerMesh] = default_mesh_factory,
        metrics: Optional[MetricsBus] = None,
        max_degree: Optional[int] = None,
        pipeline: bool = False,
        tracer=None,
    ):
        self.adapter = adapter
        self.axis = axis
        self.chunk_size = chunk_size
        self.mesh_factory = mesh_factory
        self.metrics = metrics if metrics is not None else MetricsBus()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            adapter.tracer = tracer
        self.max_degree = max_degree
        self._meshes: Dict[int, WorkerMesh] = {}
        self._steps: Dict[int, Callable] = {}
        self.degree = degree
        adapter.validate_degree(chunk_size, degree)
        #: overlap the state-independent prepare of chunk k+1 with chunk
        #: k's live update in :meth:`run` (live-state adapters only;
        #: checkpoint barriers and resizes drain the in-flight prepare)
        self.pipeline = pipeline
        self._inflight: Optional[concurrent.futures.Future] = None
        self._attached = False
        self.state = self.place_state(adapter.init_state())
        self.chunks_done = 0

    # -- state (canonical vs live) --------------------------------------------
    @property
    def state(self):
        """The adapter state in canonical serialized form.  While a
        live-state adapter is attached, reading this IS a snapshot barrier."""
        if self._attached:
            return self.adapter.snapshot_barrier()
        return self._state

    @state.setter
    def state(self, value):
        # an external state write (checkpoint restore, re-init) invalidates
        # live shards: drop them and re-attach lazily at the next chunk
        self._drain_pipeline()
        if self._attached:
            self.adapter.detach()
            self._attached = False
        self._state = value

    def _drain_pipeline(self) -> None:
        """Pipeline barrier: wait out an in-flight chunk prepare before a
        resize, checkpoint barrier, or state write proceeds."""
        if self._inflight is not None:
            concurrent.futures.wait([self._inflight])

    def snapshot_barrier(self):
        """Materialize the canonical checkpointable state (drains the chunk
        pipeline first: a checkpoint is a full barrier)."""
        with self.tracer.span("barrier"):
            self._drain_pipeline()
            return self.state

    # -- degree / step cache --------------------------------------------------
    def _mesh(self, n: int) -> WorkerMesh:
        if n not in self._meshes:
            if self.max_degree is not None and n > self.max_degree:
                raise ValueError(f"degree {n} exceeds max_degree={self.max_degree}")
            self._meshes[n] = self.mesh_factory(n, self.axis)
        return self._meshes[n]

    def _step(self, n: int) -> Callable:
        if n not in self._steps:
            if self.adapter.is_host:
                self._steps[n] = self.adapter.make_host_step(n)
            else:
                self._steps[n] = self.adapter.make_step(self._mesh(n), self.axis)
        return self._steps[n]

    def place_state(self, state):
        """Place ``state`` for the current degree (host adapters skip the
        mesh entirely — their state is a host pytree)."""
        mesh = None if self.adapter.is_host else self._mesh(self.degree)
        return self.adapter.place(state, mesh, self.axis)

    def feasible_degrees(self, candidates) -> List[int]:
        return self.adapter.feasible_degrees(self.chunk_size, candidates)

    @property
    def compiled_degrees(self) -> List[int]:
        """Degrees with a cached step (no compilation here: the name is the
        reference's)."""
        return sorted(self._steps)

    def set_degree(self, n_new: int, *, reason: str = "") -> Optional[ResizeRecord]:
        """Apply a §4.x transition to ``n_new``; no-op if already there.
        Live-state adapters resize in place (row-level migration between
        resident shards); others run the serialized-state protocol."""
        if n_new == self.degree:
            return None
        self.adapter.validate_degree(self.chunk_size, n_new)
        with self.tracer.span("resize", n_old=self.degree, n_new=n_new):
            self._drain_pipeline()  # resizes are pipeline barriers
            n_old = self.degree
            if self._attached:
                info = self.adapter.resize_live(n_old, n_new)
                self.degree = n_new
            else:
                self._state, info = self.adapter.resize(self._state, n_old, n_new)
                self.degree = n_new
                self._state = self.place_state(self._state)
        self.tracer.instant(
            "resize", n_old=n_old, n_new=n_new, protocol=info.protocol,
            rows=info.handoff_rows, bytes=info.handoff_bytes,
        )
        rec = ResizeRecord(
            t=self.metrics.clock.now(),
            n_old=n_old,
            n_new=n_new,
            protocol=info.protocol,
            handoff_items=info.handoff_items,
            handoff_rows=info.handoff_rows,
            handoff_bytes=info.handoff_bytes,
            reason=reason or info.detail,
        )
        self.metrics.record_resize(rec)
        return rec

    # -- execution ------------------------------------------------------------
    def process(self, chunk, *, queue_depth: int = 0, prepared=None):
        """Run one chunk at the current degree; returns the chunk output.

        A chunk may be a single array, a pytree of arrays (leading axis =
        stream order; an SPMD adapter's chunk is moved to the mesh's device
        here, once) or — for host adapters — a structured record array or a
        dict of columns.  The chunk's time covers its device work: the
        keyed plane returns host numpy, and an SPMD step is synchronized.
        ``prepared`` is this chunk's :meth:`PatternAdapter.prepare_chunk`
        result when :meth:`run`'s pipeline computed it ahead of time."""
        if self.adapter.is_host:
            m = _chunk_len(chunk)
        else:
            m = int(len(tree_leaves(chunk)[0]))
        if m != self.chunk_size:
            # tail chunk: fall back to the largest compatible degree
            self._fit_degree_for(m)
        mesh = None if self.adapter.is_host else self._mesh(self.degree)
        if mesh is not None:
            chunk = mesh.put(chunk)
        t0 = self.metrics.clock.now()
        with self.tracer.span(
            "chunk", m=m, degree=self.degree, queue_depth=queue_depth
        ):
            if self.adapter.has_live_state:
                if not self._attached:
                    # first chunk (or first after a state write / restore):
                    # hydrate live shards once
                    self.adapter.attach(self._state, self.degree)
                    self._attached = True
                    self._state = None
                out = self.adapter.step_live(chunk, prepared=prepared)
            else:
                self._state, out = self._step(self.degree)(self._state, chunk)
            if mesh is not None and mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
        t1 = self.metrics.clock.now()
        self.metrics.record_chunk(
            ChunkRecord(
                t_start=t0,
                t_end=t1,
                m=m,
                n_workers=self.degree,
                queue_depth=queue_depth,
                collector_updates=m // self.adapter.granularity,
            )
        )
        self.chunks_done += 1
        return out

    def _fit_degree_for(self, m: int) -> None:
        """Shrink to the largest degree that fits a short (tail) chunk;
        ``chunk_size`` itself is left untouched."""
        for n in range(min(self.degree, m), 0, -1):
            try:
                self.adapter.validate_degree(m, n)
            except ValueError:
                continue
            saved = self.chunk_size
            self.chunk_size = m  # set_degree validates against chunk_size
            try:
                self.set_degree(n, reason=f"short chunk of {m} items")
            finally:
                self.chunk_size = saved
            return
        raise ValueError(f"no degree can process a tail chunk of {m} items")

    def _traced_prepare(self, chunk):
        """Pipeline-pool entry point (its span lands on its own track)."""
        with self.tracer.span("prepare"):
            return self.adapter.prepare_chunk(chunk)

    def run(
        self,
        chunks: Iterable,
        *,
        schedule: Optional[Dict[int, int]] = None,
        autoscaler=None,
        queue=None,
    ) -> List[Any]:
        """Process an iterable of chunks.  ``schedule`` maps chunk index ->
        degree (explicit resize points); ``autoscaler`` is consulted between
        chunks when given.  With :attr:`pipeline` on (live-state adapters),
        chunk ``k+1``'s prepare runs on a one-deep background worker while
        chunk ``k`` updates the live plane; outputs are bit-identical with
        the pipeline off."""
        outs: List[Any] = []
        if not (self.pipeline and self.adapter.has_live_state):
            for i, chunk in enumerate(chunks):
                if schedule and i in schedule:
                    self.set_degree(schedule[i], reason=f"schedule@chunk{i}")
                if autoscaler is not None:
                    autoscaler.maybe_scale(self, queue=queue)
                outs.append(self.process(chunk))
            return outs
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        done = object()  # sentinel: a None CHUNK must not truncate the run
        try:
            it = iter(chunks)
            cur = next(it, done)
            prepared = None
            i = 0
            if cur is not done:
                if schedule and 0 in schedule:
                    self.set_degree(schedule[0], reason="schedule@chunk0")
                if autoscaler is not None:
                    autoscaler.maybe_scale(self, queue=queue)
            while cur is not done:
                nxt = next(it, done)
                fut = None
                if nxt is not done:
                    fut = pool.submit(self._traced_prepare, nxt)
                    self._inflight = fut
                outs.append(self.process(cur, prepared=prepared))
                prepared = None
                if nxt is not done:
                    # degree changes for chunk i+1 happen before its step
                    if schedule and (i + 1) in schedule:
                        self.set_degree(
                            schedule[i + 1], reason=f"schedule@chunk{i + 1}"
                        )
                    if autoscaler is not None:
                        autoscaler.maybe_scale(self, queue=queue)
                    prepared = fut.result()
                self._inflight = None
                cur = nxt
                i += 1
        finally:
            self._inflight = None
            pool.shutdown(wait=True)
        return outs


def _chunk_len(chunk) -> int:
    """Items in a chunk: a record array or list, or a dict of columns."""
    if isinstance(chunk, dict):
        return len(next(iter(chunk.values())))
    return len(chunk)


def run_stream(step: Callable, stream: Iterable, state, *run_args):
    """Generic chunked fold: ``step(state, chunk, *run_args) -> (state, out)``."""
    outs = []
    for chunk in stream:
        state, out = step(state, chunk, *run_args)
        outs.append(out)
    return state, outs
