"""Pattern-agnostic elastic executor — the host-adapter path.

Port of ``repro/runtime/executor.py``.  A :class:`PatternAdapter` wraps a
state pattern behind a uniform interface the runtime drives over successive
stream chunks; :class:`StreamExecutor` owns the degree, a per-degree step
cache, the live-state attach/detach lifecycle and the optional
double-buffered chunk pipeline.

Only host-driven adapters (``is_host``, e.g. the keyed window plane) are
ported so far; their device work happens inside the adapter.  The
reference's SPMD adapters over a device mesh are a later slice, and an
adapter without ``is_host`` is refused at construction.

Because every chunk is identical in shape and chunk boundaries are the only
resize points, a run with any schedule of degree changes processes exactly
the same chunks in exactly the same order as a fixed-degree run.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.metrics import ChunkRecord, MetricsBus, ResizeRecord


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
    #: their own device work) with state as a host pytree
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

    def make_host_step(self, n_w: int) -> Callable:
        """Host-driven step ``(state, chunk) -> (state, out)``."""
        raise NotImplementedError

    def place(self, state, mesh, axis: str):
        """Place ``state`` for the current degree; host adapters keep it as
        a host pytree (``mesh`` is None)."""
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


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class StreamExecutor:
    """Drive a host pattern adapter over successive chunks with online
    resizes.

    ``set_degree`` is legal *between* chunks only (chunk boundaries are the
    quiescent points of the paper's protocols).  Steps are cached per
    degree.
    """

    def __init__(
        self,
        adapter: PatternAdapter,
        *,
        degree: int,
        chunk_size: int,
        axis: str = "workers",
        metrics: Optional[MetricsBus] = None,
        max_degree: Optional[int] = None,
        pipeline: bool = False,
        tracer=None,
    ):
        if not adapter.is_host:
            raise NotImplementedError(
                "only host-driven adapters are ported; the SPMD mesh "
                "adapters are not"
            )
        self.adapter = adapter
        self.axis = axis
        self.chunk_size = chunk_size
        self.metrics = metrics if metrics is not None else MetricsBus()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            adapter.tracer = tracer
        self.max_degree = max_degree
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
    def _step(self, n: int) -> Callable:
        if n not in self._steps:
            self._steps[n] = self.adapter.make_host_step(n)
        return self._steps[n]

    def place_state(self, state):
        """Host adapters keep their state as a host pytree."""
        return self.adapter.place(state, None, self.axis)

    def feasible_degrees(self, candidates) -> List[int]:
        return self.adapter.feasible_degrees(self.chunk_size, candidates)

    @property
    def compiled_degrees(self) -> List[int]:
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
        """Run one chunk at the current degree; returns the chunk output
        (host numpy for the keyed plane, so the chunk's time covers its
        device work).  ``prepared`` is this chunk's
        :meth:`PatternAdapter.prepare_chunk` result when :meth:`run`'s
        pipeline computed it ahead of time."""
        m = _chunk_len(chunk)
        if m != self.chunk_size:
            # tail chunk: fall back to the largest compatible degree
            self._fit_degree_for(m)
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
