"""DistributedKeyedPlane: the sharded keyed state plane across processes.

Port of ``repro/dist/plane.py``.  The coordinator runs in the calling
process and subclasses the port's in-process adapter; each worker process
runs the port's engines on the device the plane names (``device=None`` is
the CUDA card, as everywhere in the port), so on the card every worker
makes its own CUDA context and launches the keyed kernels itself.  Launch
counts are per process: the coordinator sums the counts the workers ship
with each STEP reply into :attr:`DistributedKeyedPlane.kernel_launches`.
A forked child cannot initialize CUDA once its parent has, and the
coordinator has (it resolves its device), so ``start_method="fork"`` is
refused for a CUDA device.

The coordinator side of :mod:`repro_torch.dist` (wire format:
``docs/wire-protocol.md``).  It implements the same live-state
:class:`~repro_torch.runtime.executor.PatternAdapter` lifecycle as the in-process
:class:`~repro_torch.keyed.runtime.KeyedWindowAdapter` — ``attach`` /
``step_live`` / ``resize_live`` / ``snapshot_barrier`` / ``detach`` — but
the engine shards live in :mod:`~repro_torch.dist.shardhost` worker processes:

* ``step_live`` routes the chunk by ``hash_to_slot`` ownership exactly like
  the in-process per-shard loop, scatters one STEP frame per shard (empty
  sub-chunks included — the watermark clock is shared), gathers the
  replies as they complete (``multiprocessing.connection.wait`` — one slow
  shard never serializes the others), and merges emissions / early firings
  / late records with the SAME deterministic stream-position merge — so
  outputs are bit-exact against both the in-process plane and the serial
  oracle;
* ``step_ahead`` overlaps scatter with the coordinator's tail work: the
  executor's pipeline scatters chunk ``k+1`` right after chunk ``k``'s
  output is merged, so the workers compute ``k+1`` while the coordinator
  merges, meters, and prepares — one chunk deep, drained at every resize /
  barrier / health read exactly like the executor's prepare pipeline;
* ``resize_live`` is cross-process §4.2 row migration: donors EXTRACT the
  reassigned slots' canonical rows, the coordinator buckets them by the
  rebalanced ownership table and INGESTs each recipient's canonically
  sorted batch — handoff slots / rows / **bytes on the wire** ride the
  ``ResizeInfo`` onto ``MetricsBus.migration_volume()``;
* ``snapshot_barrier`` gathers per-shard SNAPSHOT frames and merges them
  into THE canonical snapshot (the same merge the in-process plane uses),
  so ``repro_torch.checkpoint`` and the failure supervisor work unchanged;
* a worker-process death surfaces as
  :class:`~repro_torch.runtime.supervisor.WorkerFailure` after the coordinator
  collects the dead host's flight-recorder black box — the supervisor then
  restores from the canonical checkpoint; surviving workers stay warm in
  the pool, and the dead slot is refilled **immediately** (a promoted warm
  spare when ``spares > 0``, otherwise a respawn kicked off at death so
  its import cost runs concurrently with the restore).

Two transports carry the frames, chosen by ``transport=`` (default: the
``REPRO_DIST_TRANSPORT`` env var, else ``"shm"``):

* ``"pipe"`` — every frame inline over the ``multiprocessing`` pipe;
* ``"shm"`` — column payloads ride per-host shared-memory rings
  (:mod:`repro_torch.dist.shm`); the pipe carries only headers + descriptors.
  Negotiated per host at HELLO (a worker that failed to attach its rings
  advertises no ``shm`` cap and stays on the pipe), and degraded per frame
  when a ring is full — the pipe encoding always works.

Hosts are **shard-agnostic multiplexers**: ``shards_per_host`` engine
shards share one process (shard ``w`` lives on host ``w //
shards_per_host``), every request frame names its shard, and replies come
back in per-host FIFO order — so pool-index → shard-id routing semantics
are preserved while the process count (and per-process fixed cost) drops
at high ``n_w``.

Worker processes are **pooled**: ``prespawn`` hosts are started at the
first attach (imports pay once, concurrently), a shrink parks hosts warm
instead of killing them, and a grow re-attaches parked hosts — so a resize
costs row migration, not process startup, and the autoscaler can move the
process count freely.  Every shard gets its own tracer track
(:meth:`~repro_torch.obs.trace.Tracer.alloc_track`): STEP replies carry the
worker-timed spans and the coordinator replays them onto the shard's
track, giving one coherent cross-process timeline per run.
"""

from __future__ import annotations

import atexit
import collections
import dataclasses
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import shardhost, wire
from repro_torch.dist.faults import FaultPlan
from repro_torch.dist.shm import ShmError, ShmRing, ShmTransport
from repro_torch.keyed.runtime import (
    KeyedWindowAdapter,
    _concat_sorted,
    merge_shard_snapshots,
)
from repro_torch.keyed.store import SlotMap, fold_worker_items, hash_to_slot
from repro_torch.keyed.windows import WindowSpec
from repro_torch.runtime.executor import ResizeInfo
from repro_torch.runtime.supervisor import WorkerFailure

_FIRE_KEYS = ("key", "start", "end", "value", "count")
_LATE_KEYS = ("key", "value", "ts", "start", "pos")


def _owned(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Ensure every output column owns its memory.  The zero-copy shm path
    can thread a ring *view* through a single-shard merge shortcut; outputs
    must never alias the ring (the span is reused next epoch)."""
    return {k: (v if v.flags.owndata else v.copy()) for k, v in d.items()}


@dataclasses.dataclass
class Deadlines:
    """Per-frame-family reply deadlines plus the liveness-probe/retry knobs.

    Every coordinator receive polls with the family's timeout; on expiry a
    PING probe goes out and the worker gets ``probe`` more seconds to show
    life.  A PONG without the awaited reply means the request (or its
    reply) was lost in transit — the coordinator retransmits everything
    pending.  Silence past the probe window is a **hung** worker: killed
    and surfaced as ``WorkerFailure(cause="hung")``, so detection latency
    is bounded by ``family deadline + probe`` (+ scheduling noise).

    Corrupt frames (CRC mismatch / undecodable) are retried with
    exponential backoff (``retry_base * 2**k``) up to ``max_retries``
    before the worker is declared ``corrupt``.

    ``slow_after`` marks replies slower than that as *slow* (counter +
    trace instant, never fatal by itself); with ``slow_strikes`` set, that
    many **consecutive** slow replies escalate to
    ``WorkerFailure(cause="slow")`` — off by default.

    Defaults are production-loose (a deadline trip should mean a genuinely
    wedged worker, not a slow CI box); chaos tests construct tight ones.
    """

    hello: float = 180.0      # spawn + interpreter + torch import
    attach: float = 120.0     # a worker's first also makes its CUDA context
    step: float = 60.0
    snapshot: float = 120.0
    migrate: float = 120.0    # EXTRACT / INGEST / APPLY / departing HEALTH
    health: float = 30.0
    default: float = 60.0
    probe: float = 5.0        # grace window after a PING
    retry_base: float = 0.05  # backoff base for corrupt-frame retries
    max_retries: int = 4
    slow_after: Optional[float] = None
    slow_strikes: Optional[int] = None

    def for_family(self, family: str) -> float:
        return float(getattr(self, family, self.default))


class _HostHandle:
    """One pooled shard-host process (shard-agnostic; shards are routed to
    it by the coordinator's ``shard -> host`` map)."""

    __slots__ = ("ident", "proc", "chan", "pid", "blackbox_path", "rings",
                 "tids", "tid_tracer", "seq", "outstanding", "hello_done",
                 "pending", "inbox", "slow_strikes")

    def __init__(self, ident, proc, chan, blackbox_path, rings):
        self.ident = ident                  # spawn ordinal (label only)
        self.proc = proc
        self.chan: ShmTransport = chan
        self.pid: Optional[int] = None
        self.blackbox_path = blackbox_path
        self.rings: Optional[Tuple[ShmRing, ShmRing]] = rings  # (c2w, w2c)
        self.tids: Dict[int, int] = {}      # shard -> tracer track id
        self.tid_tracer: Any = None         # tracer the tids belong to
        self.seq = 0                        # request sequence (epoch hygiene)
        self.outstanding: Deque[int] = collections.deque()  # awaited seqs
        self.hello_done = False
        #: seq -> (ftype, meta, cols) of every un-acked request, kept for
        #: retransmission after a NACK / lost-frame probe (freed on reply)
        self.pending: Dict[int, Tuple] = {}
        #: valid replies that arrived ahead of the awaited seq (a
        #: retransmit raced its original) — consumed when their turn comes
        self.inbox: Dict[int, Tuple] = {}
        self.slow_strikes = 0               # consecutive slow replies


def _close_channel(h: _HostHandle) -> None:
    """Close a host's pipe and unlink the rings made for it — also when
    its HELLO was never read (a spare, or a host that died booting), so
    the rings were never moved onto its channel."""
    h.chan.close()
    for ring in h.rings or ():
        ring.close()


class DistributedKeyedPlane(KeyedWindowAdapter):
    """Keyed windowed state sharded across worker **processes**.

    Drop-in adapter for :class:`~repro_torch.runtime.executor.StreamExecutor`:
    the executor, autoscaler (now choosing the process count), checkpoint
    supervisor, and observability plane all run unchanged on top.  The
    serialized-state protocol (``resize`` on a detached adapter,
    ``init_state``, degree validation) is inherited from
    :class:`~repro_torch.keyed.runtime.KeyedWindowAdapter` — only the live
    lifecycle crosses the process boundary.

    ``transport`` selects ``"shm"`` (shared-memory column payloads,
    same-host only) or ``"pipe"`` (inline frames; also the automatic
    fallback).  ``shards_per_host`` multiplexes that many engine shards
    onto each worker process.  ``spares`` keeps that many warm spare hosts
    on standby: a worker death promotes a spare into the hole instantly,
    so failover re-attach never pays process startup.  ``prespawn``
    pre-starts enough hosts for that many shards at the first attach;
    ``start_method`` picks the multiprocessing context (default ``spawn``;
    ``fork`` starts faster, and is refused for a CUDA ``device``).
    ``device`` is the workers' engines' device (``None``: the card).
    """

    def __init__(self, spec: WindowSpec, *, num_slots: int,
                 impl: str = "segment", backend: str = "host",
                 capacity: int = 1024, ttl: int | None = None,
                 max_probes: int = 16, prespawn: Optional[int] = None,
                 start_method: str = "spawn",
                 blackbox_dir: Optional[str] = None,
                 transport: Optional[str] = None,
                 shards_per_host: int = 1,
                 spares: int = 0,
                 shm_capacity: int = 4 << 20,
                 deadlines: Optional[Deadlines] = None,
                 faults: Optional[FaultPlan] = None,
                 crc: bool = True,
                 worker_crc: bool = True,
                 registry: Any = None,
                 device=None):
        super().__init__(
            spec, num_slots=num_slots, impl=impl, backend=backend,
            capacity=capacity, ttl=ttl, max_probes=max_probes,
            live=True, fused=False, device=device,
        )
        check_start_method(start_method, self.device)
        self.prespawn = prespawn
        self.start_method = start_method
        self.blackbox_dir = blackbox_dir or os.path.join(
            tempfile.gettempdir(), f"repro-dist-{os.getpid()}"
        )
        self.transport = (
            transport or os.environ.get("REPRO_DIST_TRANSPORT", "shm")
        )
        if self.transport not in ("pipe", "shm"):
            raise ValueError(f"unknown transport {self.transport!r}")
        self.shards_per_host = max(1, int(shards_per_host))
        self.spares = max(0, int(spares))
        self.shm_capacity = int(shm_capacity)
        self._ctx = multiprocessing.get_context(start_method)
        self._pool: List[Optional[_HostHandle]] = []
        self._spares: List[_HostHandle] = []
        self._spawned = 0                     # spawn ordinal counter
        self._active = 0                      # shards currently attached
        self._ahead: Optional[Tuple[Any, int, Optional[int]]] = None
        self._tally: List[int] = []           # mirrored §4.2 work tallies
        self._wm: Optional[int] = None        # mirrored shared watermark clock
        self._max_ts: Optional[int] = None
        self._wm_ticks = 0
        self.collected_blackboxes: List[str] = []
        #: the keyed kernels' launches in the workers, summed over the STEP
        #: replies (each carries its step's counts on its shard_step span)
        self.kernel_launches: Dict[str, int] = {}
        #: cumulative wire traffic by frame family, plus the transport
        #: split: ``piped`` (bytes through the pipes, headers + inline and
        #: fallback payloads) vs ``shm`` (payload bytes through the rings)
        self.wire_bytes: Dict[str, int] = {
            "attach": 0, "step": 0, "migration": 0, "snapshot": 0,
            "piped": 0, "shm": 0,
        }
        self.deadlines = deadlines or Deadlines()
        self.faults = faults
        if faults is None:
            # CI chaos lane: REPRO_DIST_CHAOS=<seed> arms a seeded storm of
            # *recoverable* transit faults (corrupt / truncate / drop /
            # delay, both directions — no kills) on every plane that did
            # not bring its own plan, so the whole dist suite must stay
            # bit-exact through transparent retry
            chaos = os.environ.get("REPRO_DIST_CHAOS")
            if chaos:
                self.faults = FaultPlan.storm(
                    seed=int(chaos), n_shards=8, n_chunks=10,
                    include_kills=False,
                    include_shm=(self.transport == "shm"),
                )
                if deadlines is None:
                    # a dropped frame is only noticed at deadline expiry —
                    # production-loose deadlines would stall the suite for
                    # a minute per drop
                    self.deadlines = Deadlines(step=2.5, probe=1.0,
                                               retry_base=0.01)
        self.crc = bool(crc)
        #: worker-side CRC capability knob — False simulates a v1 peer
        #: (interop tests); the coordinator then never enables CRC for it
        self._worker_crc = bool(worker_crc)
        self.registry = registry
        #: detection / retry / recovery event counters — exported as
        #: ``dist.fault.*`` by :meth:`export_health`, asserted by chaos CI
        self.fault_events: Dict[str, int] = {
            "death_dead": 0, "death_hung": 0, "death_corrupt": 0,
            "death_slow": 0, "crc_errors": 0, "nacks": 0, "retransmits": 0,
            "probes": 0, "probes_answered": 0, "slow_replies": 0,
            "injected_send": 0, "armed_worker": 0, "degraded": 0,
            "fenced_replays": 0, "recoveries": 0,
        }
        #: degree ceiling while respawn is failing (``None`` = healthy);
        #: :meth:`feasible_degrees` clamps autoscaler candidates to it, so
        #: the plane degrades through the autoscaler instead of dying
        self.capacity_limit: Optional[int] = None
        self.mttr_s: List[float] = []         # per-recovery detect->reattach
        self._death_at: Optional[float] = None
        self._epoch = 0                       # resize-handoff fencing epoch
        self._closed = False
        atexit.register(self.close)

    def _engine_kwargs(self):
        # the device crosses to the workers as a string (cfg is pickled)
        return dict(super()._engine_kwargs(), device=str(self.device))

    # -- shard -> host routing -------------------------------------------------
    def _hosts_for(self, n_shards: int) -> int:
        return -(-n_shards // self.shards_per_host)

    def _host(self, shard: int) -> _HostHandle:
        return self._pool[shard // self.shards_per_host]

    # -- process pool ----------------------------------------------------------
    def _spawn(self) -> _HostHandle:
        parent, child = self._ctx.Pipe()
        ident = self._spawned
        self._spawned += 1
        rings = None
        if self.transport == "shm":
            try:
                rings = (ShmRing.create(self.shm_capacity),
                         ShmRing.create(self.shm_capacity))
            except Exception:
                rings = None  # no /dev/shm: every frame takes the pipe
        cfg = {
            "host": ident,
            "spec": dataclasses.asdict(self.spec),
            "engine_kwargs": self._engine_kwargs(),
            "crc": self._worker_crc,
            "blackbox_path": os.path.join(
                self.blackbox_dir, f"host{ident}.json"
            ),
        }
        if rings is not None:
            cfg["shm_c2w"] = rings[0].name
            cfg["shm_w2c"] = rings[1].name
        proc = self._ctx.Process(
            target=shardhost.serve, args=(child, cfg), daemon=True,
            name=f"shardhost-{ident}",
        )
        proc.start()
        child.close()  # parent keeps one end only, so EOF means death
        return _HostHandle(ident, proc, ShmTransport(parent),
                           cfg["blackbox_path"], rings)

    def _wait_hello(self, handles: Sequence[_HostHandle]) -> None:
        """Complete the handshake: learn each host's pid and negotiated
        capabilities, then swap its channel onto the rings if the worker
        attached them (HELLO ``caps`` carries the worker's side)."""
        for h in handles:
            if h.hello_done:
                continue
            ftype, meta, _ = self._reply(h, family="hello")
            if ftype != wire.HELLO:
                raise WorkerFailure(
                    f"shard host {h.ident}: bad handshake frame {ftype}"
                )
            h.pid = int(meta["pid"])
            h.hello_done = True
            caps = meta.get("caps") or []
            if h.rings is not None and "shm" in caps:
                conn = h.chan.conn
                # coordinator writes c2w, reads w2c; STEP_OUT is the hot
                # gather frame — mapped zero-copy, the merge re-owns it
                h.chan = ShmTransport(
                    conn, send_ring=h.rings[0], recv_ring=h.rings[1],
                    zero_copy=(wire.STEP_OUT,),
                )
            elif h.rings is not None:
                for ring in h.rings:
                    ring.close()
                h.rings = None
            # CRC negotiation: enable per-link only when the worker
            # advertised the algorithm (an old peer without the cap keeps
            # byte-identical v1 frames both ways)
            if self.crc and "crc32" in caps:
                h.chan.crc = True
            # arm injected faults exactly once per worker-process lifetime,
            # before any ATTACH can reach it (FIFO pipe ordering); spent
            # kill-faults were consumed at death attribution, so recovery
            # cannot loop on them
            if self.faults is not None:
                wf = self.faults.worker_faults()
                if wf:
                    self._send_oob(h, wire.FAULT, {"faults": wf})
                    self.fault_events["armed_worker"] += len(wf)

    def _ensure_pool(self, k: int) -> None:
        """Fill pool slots ``0..k-1`` with live hosts.  Holes are filled by
        promoting warm spares first (instant), then by spawning.  All
        missing processes start before any handshake wait, so their
        interpreter/torch imports run concurrently and a k-host pool pays
        ~one import latency.  The spare pool is topped up here too (spawn
        only — their handshakes are awaited at promotion)."""
        while len(self._pool) < k:
            self._pool.append(None)
        if any(h is None for h in self._pool):
            # hosts are shard-agnostic: compact live hosts into the leading
            # slots so a degraded pool still fields a contiguous prefix
            live = [h for h in self._pool if h is not None]
            self._pool = live + [None] * (len(self._pool) - len(live))
        for i in range(k):
            if self._pool[i] is None and self._spares:
                # FIFO: the oldest spare has had the longest to finish its
                # interpreter boot — promoting LIFO would grab the spare
                # most recently spawned (possibly still importing) while a
                # warm one idles
                self._pool[i] = self._spares.pop(0)
        for i in range(k):
            if self._pool[i] is None:
                try:
                    self._pool[i] = self._spawn()
                except Exception as e:
                    # spares exhausted AND respawn failing: degrade instead
                    # of dying — record the capacity we can still field and
                    # let the Supervisor/autoscaler shrink onto it
                    self._note_degraded(e)
                    raise WorkerFailure(
                        f"cannot spawn shard host for pool slot {i}: {e!r}",
                        cause="spawn", capacity=self.capacity_limit,
                    ) from e
        while len(self._spares) < self.spares:
            try:
                self._spares.append(self._spawn())
            except Exception:
                break  # degraded: run without a full spare set
        self._wait_hello(self._pool[:k])
        # the full pool answered: spawn capability is demonstrably back
        self.capacity_limit = None

    def _track(self, h: _HostHandle, shard: int) -> int:
        """The shard's tracer track (allocated lazily; re-allocated when
        the executor re-points the adapter tracer or the host changed)."""
        if h.tid_tracer is not self.tracer:
            h.tids = {}
            h.tid_tracer = self.tracer
        tid = h.tids.get(shard)
        if tid is None:
            tid = self.tracer.alloc_track(f"shard{shard}/pid{h.pid}")
            h.tids[shard] = tid
        return tid

    def _replay_spans(self, h: _HostHandle, shard: int, spans) -> None:
        if not spans:
            return
        tid = self._track(h, shard)
        for name, t0, t1, args in spans:
            for k, n in ((args or {}).get("launches") or {}).items():
                self.kernel_launches[k] = self.kernel_launches.get(k, 0) + n
            self.tracer.record_span(name, t0, t1, tid=tid, **(args or {}))

    # -- fallible transport ----------------------------------------------------
    def _send(self, h: _HostHandle, ftype, meta=None, cols=None) -> int:
        """Ship one request, stamped with the host's next sequence number
        (the worker echoes it in the reply — see :meth:`_reply`).  The
        frame is parked in ``h.pending`` BEFORE it leaves, so a NACK or a
        lost-frame probe can always retransmit it; the entry is freed when
        its reply lands.  Send-site injected faults (drop / corrupt /
        truncate / delay) are applied here.  Returns total bytes (piped +
        shm) for the frame-family accounting."""
        h.seq += 1
        m = dict(meta) if meta else {}
        m["seq"] = h.seq
        h.pending[h.seq] = (ftype, m, cols)
        h.outstanding.append(h.seq)
        fault = None
        if self.faults is not None:
            fault = self.faults.draw(
                "send", wire.FRAME_NAMES.get(ftype, str(ftype)),
                m.get("shard"),
            )
        try:
            if fault is not None:
                self.fault_events["injected_send"] += 1
                self.tracer.instant("fault_injected", site="send",
                                    kind=fault.kind, host=h.ident)
                if fault.kind == "drop":
                    return 0  # never transmitted: probe/NACK recovers it
                if fault.kind == "delay":
                    time.sleep(fault.seconds)
                elif fault.kind in ("corrupt", "truncate"):
                    raw = bytearray(wire.encode(
                        ftype, m, cols,
                        flags=wire.FLAG_CRC if h.chan.crc else 0,
                    ))
                    if fault.kind == "corrupt" and h.chan.crc:
                        raw[fault.seed % len(raw)] ^= 0xFF
                    elif fault.kind == "corrupt":
                        raw[0] ^= 0xFF  # no CRC: mangle the magic, so the
                        # flip is always *detected*, never silently decoded
                    else:
                        keep = wire.HEADER_BYTES + (
                            fault.seed % max(1, len(raw) - wire.HEADER_BYTES)
                        )
                        raw = raw[:keep]
                    h.chan.conn.send_bytes(bytes(raw))
                    self.wire_bytes["piped"] += len(raw)
                    return len(raw)
            piped, shm_b = h.chan.send(ftype, m, cols)
        except (BrokenPipeError, OSError) as e:
            self._kill_and_fail(h, repr(e), cause="dead")
        self.wire_bytes["piped"] += piped
        self.wire_bytes["shm"] += shm_b
        return piped + shm_b

    def _send_oob(self, h: _HostHandle, ftype, meta=None) -> None:
        """Ship an out-of-band control frame (PING / FAULT) — no sequence
        number, no pending entry, never retransmitted."""
        try:
            h.chan.send(ftype, dict(meta) if meta else {})
        except (BrokenPipeError, OSError) as e:
            self._kill_and_fail(h, repr(e), cause="dead")

    def _retransmit(self, h: _HostHandle, after: Optional[int] = None) -> None:
        """Resend every pending (un-acked) request with seq > ``after`` in
        sequence order — the answer to a NACK and to a PONG that proves the
        worker alive while the awaited reply is missing.  The worker serves
        already-executed seqs from its reply cache (exactly-once)."""
        seqs = sorted(s for s in h.pending if after is None or s > after)
        for s in seqs:
            ftype, m, cols = h.pending[s]
            try:
                piped, shm_b = h.chan.send(ftype, m, cols)
            except (BrokenPipeError, OSError) as e:
                self._kill_and_fail(h, repr(e), cause="dead")
            self.wire_bytes["piped"] += piped
            self.wire_bytes["shm"] += shm_b
        if seqs:
            self.fault_events["retransmits"] += len(seqs)
            self.tracer.instant("retransmit", host=h.ident, n=len(seqs),
                                first=seqs[0])

    def _probe(self, h: _HostHandle) -> None:
        """Liveness probe: a PING the worker answers out-of-band even while
        requests are pending (the serve loop handles it before the seq
        discipline) — distinguishes *lost frame* from *hung worker*."""
        self.fault_events["probes"] += 1
        self.tracer.instant("probe", host=h.ident)
        self._send_oob(h, wire.PING, {"host": h.ident})

    def _kill_and_fail(self, h: _HostHandle, err: str, *, cause: str = "dead",
                       detail: str = ""):
        """Terminate a misbehaving host and surface the failure.  ``hung``
        / ``slow`` / ``corrupt`` hosts are still alive — kill first so
        :meth:`_on_death` reaps a corpse, not a wedged protocol peer."""
        if h.proc.is_alive():
            try:
                h.proc.kill()
            except Exception:
                pass
        self._on_death(h, err, cause=cause, detail=detail)

    def _note_degraded(self, err: Exception) -> None:
        """Respawn capability just failed: record the degree we can still
        field so :meth:`feasible_degrees` (and through it the autoscaler /
        supervisor) shrinks the plane onto the surviving capacity instead
        of dying on the next spawn attempt."""
        live = sum(1 for x in self._pool if x is not None) + len(self._spares)
        self.capacity_limit = live * self.shards_per_host
        self.fault_events["degraded"] += 1
        self.tracer.instant("degraded", capacity=self.capacity_limit,
                            error=repr(err)[:200])

    def _note_reply_time(self, h: _HostHandle, elapsed: float) -> None:
        """Slow-worker soft signal: replies slower than ``slow_after`` are
        counted and traced; ``slow_strikes`` *consecutive* ones escalate to
        a kill with ``cause="slow"`` (off unless both knobs are set)."""
        d = self.deadlines
        if d.slow_after is None:
            return
        if elapsed > d.slow_after:
            self.fault_events["slow_replies"] += 1
            h.slow_strikes += 1
            self.tracer.instant("slow_reply", host=h.ident,
                                elapsed_s=round(elapsed, 4))
            if d.slow_strikes is not None and h.slow_strikes >= d.slow_strikes:
                self._kill_and_fail(
                    h, f"{h.slow_strikes} consecutive replies slower than "
                       f"{d.slow_after}s", cause="slow",
                )
        else:
            h.slow_strikes = 0

    def _on_death(self, h: _HostHandle, err: str, *, cause: str = "dead",
                  detail: str = ""):
        """A shard host died: collect its black box, reap the process,
        refill its pool slot immediately (warm spare if available, else a
        fresh spawn whose import runs concurrently with the restore), and
        surface the §4 worker-failure the supervisor knows how to drive —
        restore survivors + re-attach from the canonical checkpoint."""
        ident, pid = h.ident, h.pid
        key = f"death_{cause}"
        self.fault_events[key] = self.fault_events.get(key, 0) + 1
        if self._death_at is None:
            self._death_at = time.monotonic()  # MTTR clock: detect->reattach
        # attribute the death to its armed kill-fault so a Supervisor
        # recovery does not re-arm the same kill into an infinite loop
        if self.faults is not None:
            slot = self._pool.index(h) if h in self._pool else None
            shards = (
                range(slot * self.shards_per_host,
                      (slot + 1) * self.shards_per_host)
                if slot is not None else ()
            )
            self.faults.consume_kill(cause, shards)
        # give the dying process a moment to finish its black-box dump
        deadline = time.monotonic() + 2.0
        while h.proc.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        blackbox = None
        if h.blackbox_path and os.path.exists(h.blackbox_path):
            blackbox = h.blackbox_path
            self.collected_blackboxes.append(blackbox)
        _close_channel(h)  # closes the pipe and unlinks this host's rings
        if h.proc.is_alive():
            h.proc.kill()
        h.proc.join(timeout=5)
        if h in self._spares:
            self._spares.remove(h)
        if h in self._pool:
            slot = self._pool.index(h)
            # refill the hole now: promotion is instant, a spawn's import
            # overlaps the checkpoint restore that must follow anyway
            # (FIFO — the oldest spare is the warmest, see _ensure_pool)
            if self._spares:
                self._pool[slot] = self._spares.pop(0)
            elif not self._closed:
                try:
                    self._pool[slot] = self._spawn()
                except Exception as e:
                    self._pool[slot] = None
                    self._note_degraded(e)
            else:
                self._pool[slot] = None
        self._active = 0   # live state is gone: force re-attach after restore
        self._ahead = None  # the overlapped epoch died with the fleet
        self.tracer.instant(
            "worker_death", host=ident, pid=pid, error=err, cause=cause,
            blackbox=blackbox or "",
        )
        msg = f"shard host {ident} (pid {pid}) {cause}: {err}"
        if blackbox:
            msg += f" [black box: {blackbox}]"
        raise WorkerFailure(
            msg + ("\n" + detail if detail else ""),
            cause=cause, capacity=self.capacity_limit,
        )

    def _reply(self, h: _HostHandle, family: str = "step",
               spent_deadline: bool = False):
        """Receive the oldest outstanding reply under the ``family``
        deadline, driving the full detection/recovery automaton:

        * deadline expiry -> PING probe; PONG without the awaited reply
          means a frame was lost in transit -> retransmit everything
          pending; silence past the probe window -> **hung**, kill;
        * NACK -> retransmit the pending tail the worker named;
        * corrupt/undecodable reply -> exponential-backoff retransmit, up
          to ``max_retries``, then **corrupt**, kill;
        * a valid reply ahead of the awaited seq (a retransmit raced its
          original) is parked in ``h.inbox``; stale duplicates (seq already
          served, or stranded by an interrupted epoch) are dropped.
        """
        t_start = time.monotonic()
        expect = h.outstanding[0] if h.outstanding else None
        deadline = self.deadlines.for_family(family)
        # ``spent_deadline``: the caller (a collective gather wait) already
        # burned the family deadline — skip straight to the probe so the
        # detection bound stays ``deadline + probe``, not double-counted
        budget_end = t_start if spent_deadline else t_start + deadline
        probed = False
        retries = 0
        while True:
            if expect is not None and expect in h.inbox:
                ftype, meta, cols = h.inbox.pop(expect)
                h.outstanding.popleft()
                h.pending.pop(expect, None)
                self._note_reply_time(h, time.monotonic() - t_start)
                return ftype, meta, cols
            remaining = max(0.0, budget_end - time.monotonic())
            if not h.chan.conn.poll(remaining):
                if not probed:
                    probed = True
                    self._probe(h)
                    budget_end = time.monotonic() + self.deadlines.probe
                    continue
                self._kill_and_fail(
                    h, f"no {family} reply within {deadline}s "
                       f"(+{self.deadlines.probe}s probe grace)",
                    cause="hung",
                )
            try:
                ftype, meta, cols = h.chan.recv()
            except (EOFError, OSError) as e:
                self._kill_and_fail(h, repr(e), cause="dead")
            except (ShmError, wire.WireError) as e:
                # mangled reply: the request is still held in pending —
                # back off, retransmit, and let the worker's reply cache
                # serve the clean copy (never re-executes the handler)
                self.fault_events["crc_errors"] += 1
                self.tracer.instant("reply_corrupt", host=h.ident,
                                    error=f"{type(e).__name__}: {e}"[:200])
                retries += 1
                if retries > self.deadlines.max_retries:
                    self._kill_and_fail(
                        h, f"{retries} corrupt replies in a row: {e!r}",
                        cause="corrupt",
                    )
                time.sleep(self.deadlines.retry_base * (2 ** (retries - 1)))
                self._retransmit(h)
                budget_end = time.monotonic() + deadline
                probed = False
                continue
            if ftype == wire.ERR:
                # the host reported the error and then died: same failure
                # path, with the worker's own traceback attached
                self._kill_and_fail(
                    h, meta.get("error", "worker error"),
                    cause="dead", detail=meta.get("traceback", ""),
                )
            if ftype == wire.PONG:
                if probed:
                    # alive, but the awaited reply never came: the request
                    # (or its reply) was lost — retransmit and rearm the
                    # full deadline
                    self.fault_events["probes_answered"] += 1
                    self._retransmit(h)
                    budget_end = time.monotonic() + deadline
                    probed = False
                continue  # stale PONG from an earlier probe: ignore
            if ftype == wire.NACK:
                self.fault_events["nacks"] += 1
                self.tracer.instant("nack", host=h.ident,
                                    have=meta.get("have"))
                self._retransmit(h, after=int(meta.get("have", 0)))
                budget_end = time.monotonic() + deadline
                probed = False
                continue
            seq = meta.get("seq")
            if expect is None:
                # unsolicited worker-initiated frame (HELLO)
                return ftype, meta, cols
            if seq == expect:
                h.outstanding.popleft()
                h.pending.pop(expect, None)
                self._note_reply_time(h, time.monotonic() - t_start)
                return ftype, meta, cols
            if seq is not None and int(seq) in h.pending:
                # a later outstanding request's reply arrived first (its
                # retransmit raced the original): park it, RE-OWNED — a
                # zero-copy shm span dies at the next recv on this channel
                h.inbox[int(seq)] = (ftype, meta, _owned(cols or {}))
                continue
            # stale duplicate (already served, or stranded by an
            # interrupted epoch): drop
            continue

    def _gather(self, handles: Sequence[_HostHandle], expect: int,
                family: str = "step"):
        """Receive one reply per entry of ``handles`` (repeats allowed —
        one per outstanding request on that host), in **completion order**
        across hosts via ``connection.wait`` and FIFO order within each
        host.  Returns replies aligned with ``handles``.

        ``connection.wait`` runs under the family deadline; when it expires
        with hosts still owing replies, each one is driven through the
        sequential :meth:`_reply` automaton (probe -> retransmit -> kill),
        so a hung worker is detected within the same bound whether the wait
        is collective or per-host.  A failure mid-gather still drains the
        surviving hosts' replies before raising, so no pipe is left holding
        a frame the next epoch would misread."""
        slots: List[Any] = [None] * len(handles)
        want: Dict[_HostHandle, Deque[int]] = {}
        for i, h in enumerate(handles):
            want.setdefault(h, collections.deque()).append(i)
        failure: Optional[WorkerFailure] = None

        def take(h: _HostHandle, spent_deadline: bool = False) -> None:
            nonlocal failure
            try:
                ftype, meta, cols = self._reply(
                    h, family=family, spent_deadline=spent_deadline
                )
            except WorkerFailure as e:
                if failure is None:
                    failure = e
                want.pop(h, None)
                return
            if ftype != expect:
                if failure is None:
                    failure = WorkerFailure(
                        f"shard host {h.ident}: expected frame "
                        f"{expect}, got {ftype}", cause="corrupt",
                    )
                want.pop(h, None)
                return
            q = want.get(h)
            if q:
                slots[q.popleft()] = (meta, cols)
                if not q:
                    want.pop(h, None)

        deadline = self.deadlines.for_family(family)
        while want:
            # serve replies already parked in an inbox first — no new bytes
            # will ever announce them to ``wait``
            progressed = False
            for h in list(want):
                while h in want and h.outstanding and \
                        h.outstanding[0] in h.inbox:
                    take(h)
                    progressed = True
            if not want:
                break
            if progressed:
                continue
            by_conn = {h.chan.conn: h for h in want}
            ready = multiprocessing.connection.wait(
                list(by_conn), timeout=deadline
            )
            if not ready:
                # collective deadline expired: drive every host still owing
                # replies through the sequential probe/kill automaton (the
                # deadline is already spent — probe immediately)
                for h in list(want):
                    first = True
                    while h in want and want.get(h):
                        take(h, spent_deadline=first)
                        first = False
                continue
            for conn in ready:
                h = by_conn[conn]
                if h in want:
                    take(h)
        if failure is not None:
            raise failure
        return slots

    # -- live-state lifecycle --------------------------------------------------
    def attach(self, state, n_w: int) -> None:
        """Hydrate ``n_w`` engine shards from the canonical snapshot: each
        shard receives ONLY the rows of its owned slots (the coordinator
        applies the owned-slot filter before serializing), plus the shared
        clock and its share of the §4.2 tallies — the same degree-alignment
        fold the in-process attach performs."""
        slot_table = np.asarray(state["slot_table"], np.int32)
        n_cur = int(state["n_workers"])
        sm = SlotMap(len(slot_table), n_cur, table=slot_table)
        items = np.asarray(state["worker_items"], np.int64)
        if n_cur != n_w:
            new_sm, _ = sm.rebalance(n_w)
            items = fold_worker_items(items, sm.table, new_sm.table, n_w)
            sm = new_sm
        self._ahead = None
        self._ensure_pool(
            max(self._hosts_for(n_w), self._hosts_for(self.prespawn or 0))
        )
        for h in self._pool:
            if h is not None:
                # stale epochs died with the old state: nothing outstanding
                # survives a re-attach, so nothing may be retransmitted
                h.outstanding.clear()
                h.pending.clear()
                h.inbox.clear()
        keys = np.asarray(state["w_key"], np.int64)
        row_owner = (
            np.asarray(sm.table, np.int64)[
                hash_to_slot(keys, self.num_slots).astype(np.int64)
            ]
            if len(keys) else np.zeros(0, np.int64)
        )
        scalars = {
            k: int(state[k])
            for k in ("wm", "wm_valid", "wm_ticks", "max_ts", "max_ts_valid")
        }
        with self.tracer.span("dist_attach", n_w=n_w):
            for w in range(n_w):
                mask = row_owner == w
                tally = np.zeros(n_w, np.int64)
                tally[w] = int(items[w]) if w < len(items) else 0
                meta = dict(
                    scalars,
                    shard=w,
                    n_workers=n_w,
                    late_count=int(state["late_count"]) if w == 0 else 0,
                    t_inserted=int(state["t_inserted"]) if w == 0 else 0,
                    t_hits=int(state["t_hits"]) if w == 0 else 0,
                    t_spilled=int(state["t_spilled"]) if w == 0 else 0,
                    t_evicted=int(state["t_evicted"]) if w == 0 else 0,
                )
                cols = {"slot_table": sm.table, "worker_items": tally}
                for k in (
                    "w_key", "w_start", "w_end", "w_value", "w_count",
                    "w_resident", "w_touch",
                ):
                    cols[k] = np.asarray(state[k], np.int64)[mask]
                self.wire_bytes["attach"] += self._send(
                    self._host(w), wire.ATTACH, meta, cols
                )
            self._gather(
                [self._host(w) for w in range(n_w)], wire.OK, family="attach"
            )
        self._slot_map = sm
        self._active = n_w
        if self._death_at is not None:
            # a recovery just completed: detect -> successful re-attach
            mttr = time.monotonic() - self._death_at
            self._death_at = None
            self.mttr_s.append(mttr)
            self.fault_events["recoveries"] += 1
            self.tracer.instant("recovered", mttr_s=round(mttr, 4), n_w=n_w)
            if self.registry is not None:
                self.registry.histogram("dist.fault.mttr_s").record(mttr)
        self._tally = [
            int(items[w]) if w < len(items) else 0 for w in range(n_w)
        ]
        self._wm = scalars["wm"] if scalars["wm_valid"] else None
        self._max_ts = scalars["max_ts"] if scalars["max_ts_valid"] else None
        self._wm_ticks = scalars["wm_ticks"]

    def detach(self) -> None:
        """Drop live shards but keep the hosts warm: the next attach
        re-hydrates the same processes (import cost is paid once per pool,
        not once per restore)."""
        self.drain_ahead()
        n_w, self._active = self._active, 0
        self._slot_map = None
        sent = []
        for w in range(n_w):
            h = self._host(w)
            try:
                self._send(h, wire.DETACH, {"shard": w})
                sent.append(h)
            except WorkerFailure:
                continue
        for h in sent:
            try:
                self._reply(h, family="default")
            except WorkerFailure:
                continue

    def close(self) -> None:
        """Shut the pool (and spares) down (idempotent; also runs atexit)."""
        if self._closed:
            return
        self._closed = True
        hosts = [h for h in self._pool if h is not None] + self._spares
        for h in hosts:
            try:
                wire.send(h.chan.conn, wire.SHUTDOWN)
            except (BrokenPipeError, OSError):
                pass
        for h in hosts:
            h.proc.join(timeout=5)
            if h.proc.is_alive():
                h.proc.kill()
                h.proc.join(timeout=5)
            _close_channel(h)
        self._pool = []
        self._spares = []
        self._active = 0

    def __enter__(self) -> "DistributedKeyedPlane":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- per-chunk execution ---------------------------------------------------
    def prepare_chunk(self, chunk) -> Optional[Dict[str, Any]]:
        """State-independent column extraction (ownership is resolved at
        step time against the current slot table, so the pipeline may run
        this ahead across a resize)."""
        ts = np.asarray(chunk["ts"], np.int64)
        return {
            "keys": np.asarray(chunk["key"], np.int64),
            "values": np.asarray(chunk["value"], np.int64),
            "ts": ts,
            "wm_ts": int(ts.max()) if len(ts) else None,
        }

    def _scatter_step(self, prep) -> Tuple[int, Optional[int]]:
        """Scatter one routed STEP frame per shard; returns the epoch's
        ``(n_w, wm_ts)`` for the matching :meth:`_finish_step`."""
        keys, values, ts = prep["keys"], prep["values"], prep["ts"]
        wm_ts = prep["wm_ts"]
        n_w = self._active
        with self.tracer.span("route"):
            owners = (
                np.asarray(self._slot_map.table, np.int64)[
                    hash_to_slot(keys, self.num_slots).astype(np.int64)
                ]
                if len(keys) else np.zeros(0, np.int64)
            )
        with self.tracer.span("scatter", n_shards=n_w):
            for w in range(n_w):
                sel = np.flatnonzero(owners == w)
                self.wire_bytes["step"] += self._send(
                    self._host(w), wire.STEP, {"wm_ts": wm_ts, "shard": w},
                    {"key": keys[sel], "value": values[sel],
                     "ts": ts[sel], "pos": sel},
                )
        return n_w, wm_ts

    def _finish_step(self, n_w: int, wm_ts: Optional[int]):
        """Gather one scattered epoch's STEP_OUT replies and merge them
        into the serial oracle's deterministic order."""
        with self.tracer.span("gather", n_shards=n_w):
            replies = self._gather(
                [self._host(w) for w in range(n_w)], wire.STEP_OUT
            )
        em_parts, early_parts, late_parts = [], [], []
        for w, (meta, cols) in enumerate(replies):
            self._replay_spans(self._host(w), w, meta.get("spans"))
            self._tally[w] = int(meta["tally"])
            em_parts.append({k: cols[f"em_{k}"] for k in _FIRE_KEYS})
            early_parts.append({k: cols[f"ey_{k}"] for k in _FIRE_KEYS})
            late_parts.append({k: cols[f"lt_{k}"] for k in _LATE_KEYS})
        with self.tracer.span("merge"):
            emissions = _owned(_concat_sorted(em_parts, _FIRE_KEYS))
            early = _owned(_concat_sorted(early_parts, _FIRE_KEYS))
            late_cols = {
                k: np.concatenate([p[k] for p in late_parts])
                for k in _LATE_KEYS
            }
            order = np.argsort(late_cols.pop("pos"), kind="stable")
            late = {k: v[order] for k, v in late_cols.items()}
        if wm_ts is not None:
            # mirror the shared watermark clock (grow-resizes seed new
            # hosts from this, with no extra roundtrip)
            self._max_ts = (
                wm_ts if self._max_ts is None else max(self._max_ts, wm_ts)
            )
            new_wm = self._max_ts - self.spec.lateness
            self._wm = new_wm if self._wm is None else max(self._wm, new_wm)
            self._wm_ticks += 1
        return {"emissions": emissions, "late": late, "early": early}

    def step_live(self, chunk, prepared=None) -> Dict[str, Dict[str, np.ndarray]]:
        """Scatter routed sub-chunks, gather per-shard outputs, and merge
        them into the serial oracle's deterministic order — the per-shard
        loop of the in-process plane with transport between route and
        engine.  If ``chunk`` was already scattered by :meth:`step_ahead`,
        only the gather half runs here."""
        if self._ahead is not None:
            ahead_chunk, n_w, wm_ts = self._ahead
            self._ahead = None
            out = self._finish_step(n_w, wm_ts)
            if ahead_chunk is chunk:
                return out
            # a different chunk than the one scattered ahead (defensive:
            # the executor never does this) — the stale epoch's state
            # update stands, its output is dropped, and the requested
            # chunk runs a full epoch
        prep = prepared if prepared is not None else self.prepare_chunk(chunk)
        n_w, wm_ts = self._scatter_step(prep)
        return self._finish_step(n_w, wm_ts)

    def step_ahead(self, chunk, prepared=None) -> bool:
        """Overlap hook: scatter ``chunk`` now, gather at the next
        :meth:`step_live` — the workers compute while the coordinator does
        its post-merge tail work (metrics, prepare, scheduling).  One
        epoch deep; no-op (returns False) if not attached or an epoch is
        already in flight."""
        if not self._active or self._ahead is not None:
            return False
        prep = prepared if prepared is not None else self.prepare_chunk(chunk)
        n_w, wm_ts = self._scatter_step(prep)
        self._ahead = (chunk, n_w, wm_ts)
        return True

    def drain_ahead(self) -> None:
        """Complete (and discard the output of) a scattered-ahead epoch.
        Every state-observing entry point drains first — resize, barrier,
        health export, detach — so the overlap is invisible to them.  The
        state update stands; only the emission dict is dropped (the
        executor retrieves it via :meth:`step_live` in the normal flow —
        a drain only fires when the stream is being abandoned or barriered
        between the scatter and its step)."""
        if self._ahead is None:
            return
        _, n_w, wm_ts = self._ahead
        self._ahead = None
        if not self._active:
            return  # the fleet died with the epoch in flight
        self._finish_step(n_w, wm_ts)

    def snapshot_barrier(self) -> Dict[str, np.ndarray]:
        """Gather per-shard SNAPSHOT frames and merge them into THE
        canonical snapshot — the identical merge the in-process plane
        performs, so the two planes serialize identically."""
        self.drain_ahead()
        n_w = self._active
        with self.tracer.span("dist_barrier", n_shards=n_w):
            for w in range(n_w):
                self._send(self._host(w), wire.SNAPSHOT_REQ, {"shard": w})
            replies = self._gather(
                [self._host(w) for w in range(n_w)], wire.SNAPSHOT,
                family="snapshot",
            )
            snaps = []
            for w, (meta, cols) in enumerate(replies):
                self._replay_spans(self._host(w), w, meta.pop("spans", None))
                self.wire_bytes["snapshot"] += sum(
                    c.nbytes for c in cols.values()
                )
                snaps.append(wire.frame_to_snapshot(meta, cols))
        return merge_shard_snapshots(
            snaps, self._slot_map.table, self._slot_map.n_workers
        )

    # -- §4.2 cross-process row migration --------------------------------------
    def resize_live(self, n_old: int, n_new: int) -> ResizeInfo:
        """Rebalance ownership and ship ONLY the reassigned slots' rows
        between processes: donors EXTRACT, the coordinator buckets by the
        new ownership table, recipients INGEST one canonically sorted batch
        each.  Handoff cost is proportional to moved rows — process startup
        is amortized by the warm pool, never paid here unless the pool is
        genuinely too small."""
        self.drain_ahead()
        # one fencing epoch per resize: INGEST/APPLY frames carry it, and a
        # replayed handoff (retransmit beyond the reply cache, or a partial
        # resize re-driven after recovery) becomes a fenced no-op on any
        # shard that already applied this epoch — exactly-once effects
        self._epoch += 1
        sm_old = self._slot_map
        sm_new, moved = sm_old.rebalance(n_new)
        old_owner = np.asarray(sm_old.table, np.int64)
        new_owner = np.asarray(sm_new.table, np.int64)
        wire_bytes = 0
        # grow: warm (or fresh) shards join with the shared clock, no rows
        if n_new > n_old:
            self._ensure_pool(self._hosts_for(n_new))
            z = np.zeros(0, np.int64)
            meta = {
                "n_workers": n_new,
                "wm": self._wm if self._wm is not None else 0,
                "wm_valid": int(self._wm is not None),
                "max_ts": self._max_ts if self._max_ts is not None else 0,
                "max_ts_valid": int(self._max_ts is not None),
                "wm_ticks": self._wm_ticks,
                "late_count": 0, "t_inserted": 0, "t_hits": 0,
                "t_spilled": 0, "t_evicted": 0,
            }
            for w in range(n_old, n_new):
                cols = {
                    "slot_table": sm_new.table,
                    "worker_items": np.zeros(n_new, np.int64),
                }
                cols.update({
                    k: z for k in (
                        "w_key", "w_start", "w_end", "w_value", "w_count",
                        "w_resident", "w_touch",
                    )
                })
                self.wire_bytes["attach"] += self._send(
                    self._host(w), wire.ATTACH, dict(meta, shard=w), cols
                )
            self._gather(
                [self._host(w) for w in range(n_old, n_new)], wire.OK,
                family="migrate",
            )
        # donor side: one EXTRACT per donor of moved slots, gathered rows
        # bucketed by the NEW ownership of each row's key
        donors = [
            int(d) for d in np.unique(old_owner[moved]).tolist()
        ] if len(moved) else []
        for d in donors:
            self._send(
                self._host(d), wire.EXTRACT,
                {"shard": d}, {"slots": moved[old_owner[moved] == d]},
            )
        rows_moved = 0
        per_recipient: Dict[int, List[Tuple[np.ndarray, ...]]] = {}
        for d, (meta, cols) in zip(
            donors,
            self._gather([self._host(d) for d in donors], wire.ROWS,
                         family="migrate"),
        ):
            rows = wire.cols_to_rows(cols)
            if not len(rows[0]):
                continue
            rows_moved += len(rows[0])
            row_recips = new_owner[
                hash_to_slot(rows[0], self.num_slots).astype(np.int64)
            ]
            for r in np.unique(row_recips).tolist():
                m = row_recips == r
                per_recipient.setdefault(int(r), []).append(
                    tuple(col[m] for col in rows)
                )
        # recipient side: one canonical sorted batch per recipient — the
        # INGEST frames are the §4.2 handoff payload, counted on the wire
        recipients = sorted(per_recipient)
        for r in recipients:
            parts = per_recipient[r]
            cat = [np.concatenate([p[i] for p in parts]) for i in range(7)]
            order = np.lexsort((cat[2], cat[1], cat[0]))
            wire_bytes += self._send(
                self._host(r), wire.INGEST,
                {"shard": r, "epoch": self._epoch},
                wire.rows_to_cols(tuple(c[order] for c in cat)),
            )
        self._gather([self._host(r) for r in recipients], wire.OK,
                     family="migrate")
        # departing shards: fold their stream-global counters into shard 0,
        # then drop their engines (hosts stay warm for a later grow)
        folded = fold_worker_items(
            np.asarray(self._tally[:n_old], np.int64),
            old_owner, new_owner, n_new,
        )
        adds = {"late_add": 0, "inserted_add": 0, "hits_add": 0,
                "spilled_add": 0, "evicted_add": 0}
        if n_new < n_old:
            departing = list(range(n_new, n_old))
            for w in departing:
                self._send(self._host(w), wire.HEALTH_REQ, {"shard": w})
            for meta, _ in self._gather(
                [self._host(w) for w in departing], wire.HEALTH,
                family="migrate",
            ):
                c = meta["counters"]
                adds["late_add"] += c["late_count"]
                adds["inserted_add"] += c["inserted"]
                adds["hits_add"] += c["hits"]
                adds["spilled_add"] += c["spilled"]
                adds["evicted_add"] += c["evicted"]
            for w in departing:
                self._send(self._host(w), wire.DETACH, {"shard": w})
            self._gather([self._host(w) for w in departing], wire.OK,
                         family="migrate")
        # new ownership epoch on every surviving shard (shard 0 absorbs the
        # departing counters exactly like the in-process fold)
        for w in range(n_new):
            meta = {"shard": w, "n_new": n_new, "tally": int(folded[w]),
                    "epoch": self._epoch}
            if w == 0:
                meta.update(adds)
            self._send(
                self._host(w), wire.APPLY, meta,
                {"slot_table": sm_new.table},
            )
        self._gather([self._host(w) for w in range(n_new)], wire.OK,
                     family="migrate")
        self._slot_map = sm_new
        self._active = n_new
        self._tally = [int(v) for v in folded]
        self.wire_bytes["migration"] += wire_bytes
        return ResizeInfo(
            protocol="S2-slotmap-handoff",
            handoff_items=int(len(moved)),
            handoff_rows=int(rows_moved),
            handoff_bytes=int(wire_bytes),
            detail=f"{len(moved)}/{self.num_slots} slots "
                   f"({rows_moved} rows, {wire_bytes} wire bytes) migrate "
                   f"across processes (minimal rebalance {n_old}->{n_new})",
        )

    # -- observability ---------------------------------------------------------
    def export_health(self, registry) -> None:
        """Publish the distributed plane's health gauges (same names as the
        in-process plane, values fetched over HEALTH frames)."""
        self.drain_ahead()
        # fault/detection/recovery events export unconditionally — a plane
        # whose fleet just died still reports how it died
        for k, v in self.fault_events.items():
            registry.counter(f"dist.fault.{k}").value = v
        if self.mttr_s:
            registry.gauge("dist.fault.mttr_last_s").set(self.mttr_s[-1])
        if self.capacity_limit is not None:
            registry.gauge("dist.fault.capacity_limit").set(
                self.capacity_limit
            )
        n_w = self._active
        if not n_w:
            return
        registry.gauge("keyed.plane.n_shards").set(n_w)
        for w in range(n_w):
            self._send(self._host(w), wire.HEALTH_REQ, {"shard": w})
        replies = self._gather(
            [self._host(w) for w in range(n_w)], wire.HEALTH,
            family="health",
        )
        totals = {"inserted": 0, "hits": 0, "spilled": 0, "evicted": 0}
        late_total = 0
        total_resident = 0
        total_spill = 0
        g = registry.gauge
        for w, (meta, _) in enumerate(replies):
            h = meta["health"]
            c = meta["counters"]
            resident = h["occupancy"] if h is not None else 0
            total_resident += resident
            total_spill += c["spill_rows"]
            late_total += c["late_count"]
            for k in totals:
                totals[k] += c[k]
            g(f"keyed.shard{w}.resident_rows").set(resident)
            g(f"keyed.shard{w}.spill_rows").set(c["spill_rows"])
            if h is not None:
                g(f"keyed.shard{w}.occupancy").set(h["occupancy"])
                g(f"keyed.shard{w}.load_factor").set(h["load_factor"])
                g(f"keyed.shard{w}.probe_mean").set(h["probe_mean"])
                g(f"keyed.shard{w}.probe_max").set(h["probe_max"])
        g("keyed.plane.resident_rows").set(total_resident)
        g("keyed.plane.spill_rows").set(total_spill)
        for k, name in (
            ("inserted", "keyed.table.inserted"),
            ("hits", "keyed.table.hits"),
            ("spilled", "keyed.table.spilled"),
            ("evicted", "keyed.table.evicted"),
        ):
            registry.counter(name).value = totals[k]
        registry.counter("keyed.late").value = late_total

    # -- degraded capacity -----------------------------------------------------
    def feasible_degrees(self, chunk_size: int, candidates) -> List[int]:
        """Pattern-feasible degrees, additionally clamped to the capacity
        the plane can still field while respawn is failing — the autoscaler
        (and the supervisor's shrink) then move the degree onto surviving
        hosts instead of re-tripping the spawn failure."""
        out = super().feasible_degrees(chunk_size, candidates)
        if self.capacity_limit is not None:
            clamped = [n for n in out if n <= self.capacity_limit]
            # never empty: the smallest valid degree is the least-bad ask
            out = clamped or ([min(out)] if out else out)
        return out

    # -- failure drill ---------------------------------------------------------
    def kill_worker(self, shard: int) -> None:
        """Failure drill: make shard ``shard``'s host die exactly like a
        real fault (black-box dump, then hard exit).  The NEXT frame sent
        to it — or the next gather — surfaces the ``WorkerFailure``."""
        h = self._host(shard)
        try:
            wire.send(h.chan.conn, wire.CRASH)
        except (BrokenPipeError, OSError):
            pass


def check_start_method(start_method: str, device) -> None:
    """Refuse ``fork`` for workers on a CUDA device: the coordinator has
    initialized CUDA (it resolved its device), and a forked child of a
    process that has cannot initialize it."""
    if start_method == "fork" and torch.device(device).type == "cuda":
        raise ValueError(
            f"start_method='fork' cannot run workers on {device}: a forked "
            "child cannot initialize CUDA once the parent has; use 'spawn'"
        )
