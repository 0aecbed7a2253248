"""ShardHost: one worker process owning one or more live keyed engine shards.

Port of ``repro/dist/shardhost.py``.  The engines are the port's
:class:`~repro_torch.keyed.windows.KeyedWindowEngine`, on the device that
``cfg["engine_kwargs"]["device"]`` names as a string: the engine resolves
it with :func:`repro_torch.device.resolve_device` when the worker builds
its first one, so a worker asked for the card on a host without one
raises, dumps its black box and dies, and the coordinator surfaces
``WorkerFailure``; it never runs on the CPU instead.  On the card every STEP runs the keyed
kernels in this process, so its launch counts
(:func:`repro_torch.kernels.ops.launch_counts`) are this process's: each
STEP ships the launches it made as the ``launches`` argument of its
``shard_step`` span, and the coordinator sums them.

The serve loop is a strict request/reply automaton over
:mod:`repro_torch.dist.wire` frames: the coordinator
(:class:`repro_torch.dist.plane.DistributedKeyedPlane`) scatters ATTACH / STEP /
EXTRACT / INGEST / APPLY / SNAPSHOT_REQ frames and the host answers each
with exactly one reply frame, in request order.  The engines inside are the
same :class:`~repro_torch.keyed.windows.KeyedWindowEngine` the in-process plane
runs — the process boundary changes transport, never semantics.

A host is **shard-agnostic**: every request's meta names the shard it
addresses, and the host keeps a ``shard id -> engine`` map, so the
coordinator can multiplex several shards onto one process
(``shards_per_host``) and promote a warm spare host into any dead host's
place — process identity and shard identity are fully decoupled.

Frames arrive over a ``multiprocessing`` pipe; when the coordinator
provisioned shared-memory rings for this host (``repro_torch.dist.shm``) and the
child attached them successfully (advertised via the HELLO ``caps`` list),
column payloads ride the rings instead — STEP payloads are mapped
zero-copy (the engine does not retain its input columns: on the CPU
``torch.as_tensor`` aliases the ring, and ``tests/test_torch_shm.py``
overwrites the span after a step and finds the engine's state unchanged;
on the card the columns are copied to the device), every other frame type
is copied on map.

Every STEP reply carries the spans the host timed around its engine work,
stamped with ``time.perf_counter`` (``CLOCK_MONOTONIC`` — one coherent
timeline across processes on the same Linux host); the coordinator replays
them onto a dedicated tracer track per shard.  The host also feeds its own
process-local :class:`~repro_torch.obs.trace.FlightRecorder`, and dumps it as a
Chrome-trace black box before dying on any error (including the CRASH
failure-drill frame) — the coordinator collects the dump file when it sees
the pipe close.

Workers are spawn-safe: :func:`serve` is a plain module-level entry point
taking only picklable arguments, and engine construction happens inside the
child.  ``start_method="spawn"`` is the default: a forked child cannot
initialize CUDA once the parent has, so the plane refuses ``"fork"`` for a
CUDA device.
"""

from __future__ import annotations

import collections
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.dist import wire
from repro_torch.dist.faults import Fault, FaultMatcher
from repro_torch.dist.shm import ShmError, ShmRing, ShmTransport
from repro_torch.kernels import ops
from repro_torch.keyed.store import SlotMap
from repro_torch.keyed.windows import KeyedWindowEngine, WindowSpec
from repro_torch.obs.trace import FlightRecorder, Tracer

#: how many served replies are kept for retransmission (must exceed the
#: coordinator's maximum outstanding window per host — shards_per_host plus
#: the one-deep overlap — by a wide margin)
REPLY_CACHE = 64

#: how many (op, shard, epoch) fence keys are remembered for idempotent
#: INGEST/APPLY replay detection
FENCE_CACHE = 512

#: a ``hang`` fault sleeps this long — far past any configured deadline;
#: the coordinator's liveness probe kills the process well before it wakes
HANG_SECONDS = 3600.0


class _Host:
    """Per-process state: the engine shards plus identity/instrumentation."""

    def __init__(self, chan: ShmTransport, cfg: Dict[str, Any]):
        self.chan = chan
        self.host = int(cfg.get("host", 0))
        self.blackbox_path: Optional[str] = cfg.get("blackbox_path")
        self.spec = WindowSpec(**cfg["spec"])
        self.engine_kwargs = dict(cfg["engine_kwargs"])
        self.engines: Dict[int, KeyedWindowEngine] = {}
        # process-local black box: newest spans survive into the crash dump
        self.recorder = FlightRecorder(capacity=1024)
        self.tracer = Tracer(max_events=0, recorder=self.recorder)
        self._spans: List[List] = []  # per-request span log shipped upstream
        # -- robustness state --------------------------------------------------
        self.matcher: Optional[FaultMatcher] = None  # armed injected faults
        self.reply_cache: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict()
        )
        self.expected_seq = 1     # next request seq this host will serve
        self._fence_keys: set = set()
        self._fence_fifo: "collections.deque" = collections.deque()

    # -- fault injection -------------------------------------------------------
    def arm(self, faults: List[Dict]) -> None:
        """(Re)arm injected faults — idempotent set-replace, occurrence
        counters reset (the coordinator strips already-fired kill faults
        before re-arming, so recovery cannot loop on the same kill)."""
        self.matcher = FaultMatcher([Fault.from_dict(d) for d in faults])
        self.tracer.instant("faults_armed", host=self.host, n=len(faults))

    def draw_fault(self, site: str, ftype: int, meta) -> Optional[Fault]:
        if self.matcher is None:
            return None
        shard = meta.get("shard")
        f = self.matcher.draw(site, wire.FRAME_NAMES.get(ftype, str(ftype)),
                              None if shard is None else int(shard))
        if f is not None:
            self.tracer.instant("fault_fired", host=self.host, site=f.site,
                                kind=f.kind, op=f.op, shard=shard)
        return f

    # -- idempotent replay fence ----------------------------------------------
    def fenced(self, ftype: int, meta) -> bool:
        """True if this INGEST/APPLY epoch was already applied on this
        shard — a replayed resize handoff must be exactly-once, so the
        duplicate becomes a fenced no-op acknowledged with ``fenced=True``."""
        epoch = meta.get("epoch")
        if epoch is None:
            return False
        key = (ftype, int(meta["shard"]), int(epoch))
        if key in self._fence_keys:
            return True
        self._fence_keys.add(key)
        self._fence_fifo.append(key)
        while len(self._fence_fifo) > FENCE_CACHE:
            self._fence_keys.discard(self._fence_fifo.popleft())
        return False

    # -- span capture ---------------------------------------------------------
    def _span(self, name: str, t0: float, t1: float, **args) -> None:
        self._spans.append([name, t0, t1, args or None])
        self.tracer.record_span(name, t0, t1, tid=0, **args)

    def take_spans(self) -> List[List]:
        out, self._spans = self._spans, []
        return out

    def _eng(self, meta) -> KeyedWindowEngine:
        shard = int(meta["shard"])
        eng = self.engines.get(shard)
        if eng is None:
            raise wire.WireError(f"host {self.host}: no engine for shard {shard}")
        return eng

    # -- frame handlers --------------------------------------------------------
    def on_attach(self, meta, cols):
        shard = int(meta["shard"])
        tree = dict(cols)
        tree["slot_table"] = np.asarray(tree["slot_table"], np.int32)
        for k in wire.SNAPSHOT_SCALARS:
            tree[k] = np.int64(meta[k])
        # the engine resolves its device (resolve_device): a named card
        # that is not there raises here, and the serve loop dumps the black
        # box and dies
        self.engines[shard] = KeyedWindowEngine.restore(
            self.spec, tree, **self.engine_kwargs
        )
        return wire.OK, {"rows": int(len(tree["w_key"]))}, None

    def on_step(self, meta, cols):
        shard = int(meta["shard"])
        eng = self._eng(meta)
        t0 = time.perf_counter()
        wm_ts = meta.get("wm_ts")
        before = ops.launch_counts()
        out = eng.process_chunk(
            {k: cols[k] for k in ("key", "value", "ts")},
            wm_ts=wm_ts, positions=cols["pos"],
        )
        t1 = time.perf_counter()
        launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                    if n != before[k]}
        self._span("shard_step", t0, t1, shard=shard,
                   m=int(len(cols["key"])), launches=launches)
        reply_cols: Dict[str, np.ndarray] = {}
        for prefix, part in (("em", out["emissions"]), ("ey", out["early"])):
            for k in ("key", "start", "end", "value", "count"):
                reply_cols[f"{prefix}_{k}"] = part[k]
        for k in ("key", "value", "ts", "start", "pos"):
            reply_cols[f"lt_{k}"] = out["late"][k]
        reply_meta = {
            "spans": self.take_spans(),
            # the shard's own §4.2 work tally after this chunk — lets the
            # coordinator mirror the global tally without extra roundtrips
            "tally": int(eng.worker_items[shard]),
        }
        return wire.STEP_OUT, reply_meta, reply_cols

    def on_snapshot_req(self, meta, cols):
        shard = int(meta["shard"])
        t0 = time.perf_counter()
        snap_meta, snap_cols = wire.snapshot_to_frame(self._eng(meta).snapshot())
        self._span("shard_snapshot", t0, time.perf_counter(), shard=shard)
        snap_meta["spans"] = self.take_spans()
        return wire.SNAPSHOT, snap_meta, snap_cols

    def on_extract(self, meta, cols):
        rows = self._eng(meta).extract_rows(
            np.asarray(cols["slots"], np.int64)
        )
        return wire.ROWS, {"rows": int(len(rows[0]))}, wire.rows_to_cols(rows)

    def on_ingest(self, meta, cols):
        if self.fenced(wire.INGEST, meta):
            return wire.OK, {"rows": 0, "fenced": True}, None
        self._eng(meta).ingest_rows(*wire.cols_to_rows(cols))
        return wire.OK, {"rows": int(len(cols["key"]))}, None

    def on_apply(self, meta, cols):
        """New ownership epoch: adopt the rebalanced slot table, take the
        coordinator-folded work tally, and (shard 0 only) absorb departing
        shards' stream-global counters."""
        if self.fenced(wire.APPLY, meta):
            return wire.OK, {"fenced": True}, None
        shard = int(meta["shard"])
        eng = self._eng(meta)
        n_new = int(meta["n_new"])
        table = np.asarray(cols["slot_table"], np.int32)
        eng.store.slot_map = SlotMap(
            eng.store.num_slots, n_new, table=table
        )
        items = np.zeros(n_new, np.int64)
        items[shard] = int(meta["tally"])
        eng.worker_items = items
        eng.late_count += int(meta.get("late_add", 0))
        if eng.table is not None:
            st = eng.table.stats
            st.inserted += int(meta.get("inserted_add", 0))
            st.hits += int(meta.get("hits_add", 0))
            st.spilled += int(meta.get("spilled_add", 0))
            st.evicted += int(meta.get("evicted_add", 0))
        return wire.OK, None, None

    def on_health(self, meta, cols):
        eng = self._eng(meta)
        h = eng.table.health() if eng.table is not None else None
        counters = {
            "late_count": int(eng.late_count),
            "spill_rows": int(eng.store.num_rows()),
            "inserted": int(eng.table.stats.inserted) if eng.table else 0,
            "hits": int(eng.table.stats.hits) if eng.table else 0,
            "spilled": int(eng.table.stats.spilled) if eng.table else 0,
            "evicted": int(eng.table.stats.evicted) if eng.table else 0,
        }
        return wire.HEALTH, {"health": h, "counters": counters}, None

    def on_detach(self, meta, cols):
        """Drop one shard's engine (or all of them) but keep the process
        warm: re-attach after a checkpoint restore reuses the
        already-imported worker."""
        if meta.get("shard") is not None:
            self.engines.pop(int(meta["shard"]), None)
        else:
            self.engines.clear()
        return wire.OK, None, None

    # -- crash path ------------------------------------------------------------
    def dump_blackbox(self, err: str) -> None:
        if not self.blackbox_path:
            return
        try:
            self.tracer.instant("worker_error", host=self.host, error=err)
            os.makedirs(os.path.dirname(self.blackbox_path), exist_ok=True)
            self.recorder.dump(
                self.blackbox_path,
                process_name=f"shardhost:{self.host}",
            )
        except Exception:
            pass  # the black box must never mask the real failure


_HANDLERS = {
    wire.ATTACH: _Host.on_attach,
    wire.STEP: _Host.on_step,
    wire.SNAPSHOT_REQ: _Host.on_snapshot_req,
    wire.EXTRACT: _Host.on_extract,
    wire.INGEST: _Host.on_ingest,
    wire.APPLY: _Host.on_apply,
    wire.HEALTH_REQ: _Host.on_health,
    wire.DETACH: _Host.on_detach,
}


def _make_channel(conn, cfg: Dict[str, Any]) -> ShmTransport:
    """Attach the coordinator-provisioned rings (if any); on ANY failure
    fall back to a plain pipe channel — HELLO's ``caps`` list tells the
    coordinator which side of the negotiation this host landed on."""
    c2w, w2c = cfg.get("shm_c2w"), cfg.get("shm_w2c")
    if not (c2w and w2c):
        return ShmTransport(conn)
    try:
        recv_ring = ShmRing.attach(c2w)
        send_ring = ShmRing.attach(w2c)
    except Exception:
        return ShmTransport(conn)
    # STEP input columns are safe to map zero-copy: the engine's
    # process_chunk reads them through masks/fancy indexing and never
    # retains the originals; the span is released at the next recv, after
    # the reply left this process
    return ShmTransport(conn, send_ring=send_ring, recv_ring=recv_ring,
                        zero_copy=(wire.STEP,))


def _send_mangled(chan: ShmTransport, rtype: int, rmeta, rcols,
                  seed: int) -> None:
    """Ship a reply with one byte flipped — the ``reply``-site ``corrupt``
    fault.  Encoded inline (bypassing the ring) so the flip rides the pipe;
    the CRC trailer computed *before* the flip makes the receiver reject it
    and retransmit, at which point the clean cached reply is re-sent."""
    flags = wire.FLAG_CRC if chan.crc else 0
    raw = bytearray(wire.encode(rtype, rmeta, rcols, flags=flags))
    raw[seed % len(raw)] ^= 0xFF
    chan.conn.send_bytes(bytes(raw))


def serve(conn, cfg: Dict[str, Any]) -> None:
    """Worker-process entry point: handshake, then serve frames until
    SHUTDOWN.  On CRASH (the supervisor failure drill) or any internal
    error the host dumps its flight recorder and exits nonzero — the
    coordinator sees the pipe close and raises ``WorkerFailure``.  On EOF
    (the coordinator died first) it dumps the black box, detaches + unlinks
    the shm rings, and exits **cleanly** — a dead coordinator must never
    leave orphaned workers or leaked segments behind.

    Robustness discipline (see ``docs/fault-model.md``):

    * every seq-stamped request is served exactly once, in order; served
      replies are cached so a retransmitted request is answered from the
      cache without re-executing the handler (exactly-once effects);
    * a corrupt/truncated request triggers ``NACK{have}`` + resync: frames
      are dropped until the retransmit stream reaches ``have + 1``;
    * out-of-band frames (PING -> PONG, FAULT -> arm) bypass the seq
      discipline entirely.
    """
    chan = _make_channel(conn, cfg)
    chan.crc_capable = bool(cfg.get("crc", True))
    host = _Host(chan, cfg)
    caps = (["shm"] if chan.send_ring is not None else []) \
        + (["crc32"] if chan.crc_capable else [])
    chan.send(wire.HELLO, {
        "host": host.host, "pid": os.getpid(),
        "blackbox_path": host.blackbox_path, "caps": caps,
    })
    resync = False
    while True:
        try:
            ftype, meta, cols = chan.recv()
        except (EOFError, OSError):
            # coordinator is gone: leave a black box for the post-mortem,
            # reap the shm segments (nobody else will), exit clean
            host.dump_blackbox("coordinator EOF")
            chan.close(unlink=True)
            return
        except (wire.WireError, ShmError) as e:
            # mangled request: tell the coordinator where the good prefix
            # ends and drop everything until the retransmit reaches it
            host.tracer.instant("request_corrupt", host=host.host,
                                error=f"{type(e).__name__}: {e}")
            try:
                chan.send(wire.NACK, {"have": host.expected_seq - 1})
            except (BrokenPipeError, OSError):
                return
            resync = True
            continue
        if ftype == wire.SHUTDOWN:
            try:
                chan.send(wire.OK, {"seq": meta.get("seq")})
            except (BrokenPipeError, OSError):
                pass
            return
        if ftype == wire.CRASH:
            # deterministic failure drill: die exactly like a real fault —
            # dump the black box, close nothing gracefully, exit nonzero
            host.dump_blackbox("injected crash (CRASH frame)")
            os._exit(17)
        if ftype == wire.PING:
            try:
                chan.send(wire.PONG, {"host": host.host})
            except (BrokenPipeError, OSError):
                return
            continue
        if ftype == wire.FAULT:
            host.arm(meta.get("faults") or [])
            continue
        seq = meta.get("seq")
        if seq is not None:
            seq = int(seq)
            if resync and seq != host.expected_seq:
                continue  # still inside the corrupt gap
            resync = False
            if seq < host.expected_seq:
                # retransmitted request: answer from the cache, never
                # re-execute (exactly-once effects under replay)
                cached = host.reply_cache.get(seq)
                try:
                    if cached is not None:
                        host.tracer.instant("reply_from_cache", seq=seq)
                        chan.send(*cached)
                    else:
                        chan.send(wire.ERR, {
                            "error": f"retransmit of evicted seq {seq} "
                                     f"(serving {host.expected_seq})",
                        })
                except (BrokenPipeError, OSError):
                    return
                continue
            if seq > host.expected_seq:
                # gap: a request before this one was lost in transit
                try:
                    chan.send(wire.NACK, {"have": host.expected_seq - 1})
                except (BrokenPipeError, OSError):
                    return
                resync = True
                continue
            host.expected_seq = seq + 1
        fault = host.draw_fault("worker", ftype, meta)
        if fault is not None:
            if fault.kind == "hang":
                time.sleep(HANG_SECONDS)  # probe kill arrives long before
            elif fault.kind == "slow":
                time.sleep(fault.seconds)
            elif fault.kind == "crash":
                host.dump_blackbox(
                    f"injected crash at {wire.FRAME_NAMES.get(ftype, ftype)}"
                )
                os._exit(17)
        handler = _HANDLERS.get(ftype)
        try:
            if handler is None:
                raise wire.WireError(
                    f"unexpected frame type 0x{ftype:02x}"
                )
            rtype, rmeta, rcols = handler(host, meta, cols)
            # echo the request's sequence number: the coordinator uses it
            # to discard replies stranded by a failure-interrupted epoch
            rmeta = dict(rmeta) if rmeta else {}
            rmeta["seq"] = meta.get("seq")
            rmeta["shard"] = meta.get("shard")
            if seq is not None:
                host.reply_cache[seq] = (rtype, rmeta, rcols)
                while len(host.reply_cache) > REPLY_CACHE:
                    host.reply_cache.popitem(last=False)
            rfault = host.draw_fault("reply", ftype, meta)
            if rfault is not None and rfault.kind == "drop":
                continue  # computed + cached, never sent: retransmit serves it
            if rfault is not None and rfault.kind == "corrupt":
                _send_mangled(chan, rtype, rmeta, rcols, rfault.seed)
                continue
            if rfault is not None and rfault.kind == "delay":
                time.sleep(rfault.seconds)
            if rcols and chan.send_ring is not None:
                sfault = host.draw_fault("shm", ftype, meta)
                if sfault is not None:
                    chan.corrupt_next_span = True
            chan.send(rtype, rmeta, rcols)
        except (BrokenPipeError, OSError):
            return
        except Exception as e:  # engine/protocol error: report, then die
            err = f"{type(e).__name__}: {e}"
            host.dump_blackbox(err)
            try:
                chan.send(wire.ERR, {
                    "error": err,
                    "traceback": traceback.format_exc(limit=20),
                })
            except (BrokenPipeError, OSError):
                pass
            os._exit(1)
