"""Failure supervisor: checkpoint-mediated shrink on failure, grow on
recovery.

Reuses the ft-layer contract (``repro_torch.checkpoint``: atomic step directories,
restore under new shardings IS the §4.2 repartitioning) at chunk
granularity: the adapter state plus the stream cursor are checkpointed every
``ckpt_every`` chunks, a worker failure rolls back to the newest complete
checkpoint and re-runs at a degraded degree (failure => shrink, the
farm lost capacity), and after ``recover_after`` healthy chunks the degree
is restored (recovery => grow).  The deterministic chunk source makes replay
bit-exact; outputs are keyed by chunk index so a replayed chunk overwrites
rather than duplicates — the output stream is never dropped or reordered.

Every recovery gets a timeline: when the executor's tracer feeds a
:class:`~repro_torch.obs.trace.FlightRecorder` (enabled tracers do by default),
the supervisor dumps the ring as a Chrome-trace "black box" artifact under
``<ckpt_dir>/blackbox/`` on worker failure and after checkpoint-restore —
the last moments before the failure and the restore that followed, even if
the main trace buffer saturated long before.

Port of ``repro/runtime/supervisor.py``.  Recovery time (``mttr_s``) is the
reference's: from catching the failure to the degraded degree's
``set_degree``.  The port's executor puts a restored state back on the card
lazily, when the next chunk attaches it, so that work is not in ``mttr_s``:
the first replayed chunk pays for it (its record on the executor's metrics
bus).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.runtime.executor import StreamExecutor


class WorkerFailure(RuntimeError):
    """A worker (or its host) died mid-chunk.

    ``cause`` classifies the failure domain (see ``docs/fault-model.md``):
    ``dead`` (process exit / EOF), ``hung`` (liveness-probe timeout),
    ``slow`` (consecutive deadline-adjacent replies escalated), ``corrupt``
    (persistent CRC/decode failures), ``spawn`` (replacement processes
    cannot start).  ``capacity`` (optional) is the largest degree the
    failing plane can still field — the supervisor clamps its post-failure
    degree to it, so exhausted spawn capability degrades the computation
    instead of killing it."""

    def __init__(self, msg: str = "", *, cause: str = "dead",
                 capacity: Optional[int] = None):
        super().__init__(msg)
        self.cause = cause
        self.capacity = capacity


@dataclasses.dataclass
class FailurePlan:
    """Deterministic chaos drill: fail before chunk ``fail_at`` once, then
    declare the capacity recovered after ``recover_after`` further chunks."""

    fail_at: int
    recover_after: int = 2


@dataclasses.dataclass
class SupervisorEvent:
    chunk_index: int
    kind: str          # "failure" | "restore" | "shrink" | "grow" | "ckpt"
    detail: str


class Supervisor:
    def __init__(
        self,
        executor: StreamExecutor,
        chunk_fn: Callable[[int], Any],
        num_chunks: int,
        *,
        ckpt_dir: str,
        ckpt_every: int = 1,
        failure_plan: Optional[FailurePlan] = None,
        degraded_degree: Optional[int] = None,
        flight_recorder: Any = "default",
        blackbox_dir: Optional[str] = None,
        registry: Any = None,
    ):
        """``chunk_fn(i)`` regenerates chunk ``i`` (the deterministic-stream
        contract); ``degraded_degree`` is the post-failure degree (default:
        the next-smaller compiled-or-valid power of the current degree).

        ``flight_recorder`` is the black box dumped on failure/restore —
        the default inherits whatever ring the executor's tracer feeds
        (``None`` on a NULL_TRACER run, so dumping costs nothing when
        tracing is off); pass ``None`` to disable explicitly.  ``registry``
        (optional) rides along in every dump as a metrics snapshot."""
        self.executor = executor
        self.chunk_fn = chunk_fn
        self.num_chunks = num_chunks
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = max(1, ckpt_every)
        self.failure_plan = failure_plan
        self.degraded_degree = degraded_degree
        if flight_recorder == "default":
            flight_recorder = getattr(executor.tracer, "recorder", None)
        self.flight_recorder = flight_recorder
        self.blackbox_dir = blackbox_dir or os.path.join(ckpt_dir, "blackbox")
        self.blackbox_paths: List[str] = []
        self.registry = registry
        self.events: List[SupervisorEvent] = []
        self.outputs: Dict[int, Any] = {}
        #: per-recovery time from failure catch to degraded-degree resume
        self.mttr_s: List[float] = []

    def _log(self, i: int, kind: str, detail: str) -> None:
        self.events.append(SupervisorEvent(i, kind, detail))

    def _dump_blackbox(self, i: int, kind: str) -> Optional[str]:
        """Dump the flight-recorder ring as a Chrome-trace artifact."""
        if self.flight_recorder is None:
            return None
        if self.registry is not None:
            self.flight_recorder.sample_metrics(
                self.registry, t=self.executor.tracer.clock.now())
        os.makedirs(self.blackbox_dir, exist_ok=True)
        path = os.path.join(self.blackbox_dir, f"{kind}_chunk{i}.json")
        self.flight_recorder.dump(path, registry=self.registry,
                                  process_name=f"blackbox:{kind}")
        self.blackbox_paths.append(path)
        self._log(i, "blackbox", path)
        return path

    def _checkpoint(self, i: int) -> None:
        # snapshot barrier: live-state adapters (resident engine shards)
        # serialize to the canonical merged form HERE and nowhere else —
        # checkpoint cadence, not chunk cadence, bounds serialization cost
        with self.executor.tracer.span("ckpt", chunk=i):
            ckpt_lib.save(
                self.ckpt_dir,
                i,
                self.executor.snapshot_barrier(),
                metadata={"cursor": i, "degree": self.executor.degree},
            )
        self._log(i, "ckpt", f"state at chunk {i} (snapshot barrier)")

    def _restore_latest(self) -> int:
        tracer = self.executor.tracer
        latest = ckpt_lib.latest_step(self.ckpt_dir)
        if latest is None:
            # no checkpoint yet: restart the stream from the initial state
            with tracer.span("restore", chunk=0):
                self.executor.state = self.executor.place_state(
                    self.executor.adapter.init_state()
                )
            self._log(0, "restore", "no checkpoint; restarting stream")
            return 0
        with tracer.span("restore", chunk=latest):
            # the restore template contributes pytree structure (and numpy
            # leaf-ness) only — values are discarded.  A live-state adapter
            # must NOT serialize here: with a genuinely dead worker process
            # (the distributed plane) the barrier would raise the failure
            # again mid-recovery.  ``init_state`` has the same canonical
            # structure and costs nothing.
            adapter = self.executor.adapter
            template = (
                adapter.init_state()
                if getattr(adapter, "has_live_state", False)
                else self.executor.snapshot_barrier()
            )
            state, meta = ckpt_lib.restore(self.ckpt_dir, latest, template)
            # assigning through the state setter drops any live shards; the
            # executor re-attaches them from this canonical snapshot (at the
            # post-failure degree) on the next processed chunk
            self.executor.state = self.executor.place_state(state)
        self._log(latest, "restore", f"restored checkpoint at chunk {latest}")
        return int(meta["cursor"])

    def _shrink_for_failure(self, healthy_degree: int,
                            capacity: Optional[int] = None) -> int:
        """Post-failure degree: the configured degraded degree (or the
        largest proper divisor of the healthy one), further clamped to the
        ``capacity`` the failing plane reported it can still field."""
        if self.degraded_degree is not None:
            target = self.degraded_degree
        else:
            downs = [
                n for n in range(1, healthy_degree) if healthy_degree % n == 0
            ]
            target = max(downs) if downs else 1
        if capacity is not None:
            target = min(target, max(1, capacity))
        return max(1, target)

    def run(self) -> Dict[int, Any]:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._checkpoint(0)  # chunk-0 baseline so rollback is always defined
        healthy = self.executor.degree
        failed = False
        degraded_since: Optional[int] = None
        i = 0
        while i < self.num_chunks:
            try:
                if (
                    self.failure_plan is not None
                    and not failed
                    and i == self.failure_plan.fail_at
                ):
                    failed = True
                    raise WorkerFailure(f"injected failure before chunk {i}")
                recover_after = (
                    self.failure_plan.recover_after
                    if self.failure_plan is not None
                    else 1
                )
                if (
                    degraded_since is not None
                    and i - degraded_since >= recover_after
                ):
                    # recovery: capacity is back — grow to the healthy degree
                    rec = self.executor.set_degree(
                        healthy, reason="recovery: capacity restored"
                    )
                    if rec:
                        self._log(i, "grow", f"{rec.n_old}->{rec.n_new}")
                    degraded_since = None
                # keyed by chunk index: a replayed chunk overwrites its own
                # slot, so failures never duplicate or reorder outputs
                self.outputs[i] = self.executor.process(self.chunk_fn(i))
                i += 1
                if i % self.ckpt_every == 0:
                    self._checkpoint(i)
            except WorkerFailure as e:
                t_fail = time.monotonic()
                cause = getattr(e, "cause", "dead")
                self._log(i, "failure", f"[{cause}] {e}")
                self.executor.tracer.instant("failure", chunk=i, cause=cause,
                                             detail=str(e))
                # black box FIRST: the dump must show the timeline into the
                # failure unmodified by the recovery that follows
                self._dump_blackbox(i, "failure")
                cursor = self._restore_latest()
                self._dump_blackbox(i, "restore")
                target = self._shrink_for_failure(
                    healthy, capacity=getattr(e, "capacity", None)
                )
                rec = self.executor.set_degree(
                    target, reason=f"failure ({cause}): lost capacity "
                                   f"at chunk {i}"
                )
                if rec:
                    self._log(i, "shrink", f"{rec.n_old}->{rec.n_new}")
                mttr = time.monotonic() - t_fail
                self.mttr_s.append(mttr)
                if self.registry is not None:
                    self.registry.histogram("supervisor.mttr_s").record(mttr)
                    self.registry.counter("supervisor.recoveries").inc()
                    self.registry.counter(
                        f"supervisor.failures.{cause}"
                    ).inc()
                degraded_since = cursor
                i = cursor
        return self.outputs
