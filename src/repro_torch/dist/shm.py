"""Shared-memory column transport for the distributed keyed plane.

A copy of ``repro/dist/shm.py`` with the ring layout unchanged, so a ring
created by either package is attached by the other
(``tests/test_torch_shm.py``).

The RKWP pipe transport (:mod:`repro_torch.dist.wire`) pays a serialize → pipe →
deserialize copy chain per frame.  For same-host workers that tax is
avoidable: column payloads are plain flat arrays, so they can cross the
process boundary **by reference** through a ``multiprocessing.shared_memory``
ring — the pipe carries only the tiny frame (header + JSON meta + a span
descriptor), the bytes ride the ring, and the receiver maps them with
``np.frombuffer`` without any copy at all.  This is the FastFlow idiom the
source paper's runtime is built on (lock-free shared-memory queues between
workers), realized over the existing RKWP frame vocabulary.

Layout of one ring segment (all integers little-endian u64)::

    segment  := header (64 B) || data (capacity bytes)
    header   := magic "RKWSHM01" | capacity | write_pos | read_pos | reserved×4
    span     := generation stamp u64 | payload bytes

``write_pos`` / ``read_pos`` are **absolute monotonic byte counters**
(never wrapped); the physical offset of a span is ``pos % capacity``.  The
ring is strictly single-writer/single-reader per direction (one segment
coordinator→worker, one worker→coordinator), and the *pipe frame is the
doorbell*: the descriptor for a span is only ever read after the frame
carrying it arrives, so the pipe's own happens-before ordering covers the
ring bytes and no atomics are needed.  A span that would straddle the end
of the data region is pushed to offset 0 (the skipped tail is dead space
until the span is released).

The **generation stamp** is the span's absolute start position — unique for
the lifetime of the segment.  It is written at the head of the span and
echoed in the descriptor; :meth:`ShmRing.view` re-checks it, so a
descriptor held across a ring reuse (a protocol bug, or a reader outliving
its release discipline) trips loudly instead of yielding torn bytes.

Flow control is capacity-only: if a span does not fit in
``capacity - (write_pos - read_pos)`` the push fails and the caller falls
back to the inline pipe encoding for that frame (:class:`ShmTransport`
does this automatically) — the transport degrades, never blocks.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dist import wire

SHM_MAGIC = b"RKWSHM01"
HEADER_BYTES = 64
STAMP_BYTES = 8
DEFAULT_CAPACITY = 4 << 20  # per direction; exhaustion falls back to pipe

_U64 = struct.Struct("<Q")


class ShmError(RuntimeError):
    """Torn/stale span, bad segment magic, or descriptor misuse."""


def _shared_memory():
    """Import hook (monkeypatchable in tests to simulate absence)."""
    from multiprocessing import shared_memory

    return shared_memory


#: segments created by THIS process — an attach to one of these (tests pair
#: both endpoints in-process) must not touch the resource tracker, or it
#: would cancel the creator's own registration
_CREATED_HERE: set = set()


class ShmRing:
    """One single-writer/single-reader span ring over a SharedMemory segment.

    Exactly one endpoint may call :meth:`push`; exactly one may call
    :meth:`view` / :meth:`release`.  Spans are released in FIFO order
    (the request/reply discipline of the shard-host protocol guarantees
    frames are consumed in the order they were pushed).
    """

    def __init__(self, shm, *, own: bool):
        self._shm = shm
        self._own = own  # creator unlinks; attacher only closes
        self._buf = shm.buf
        if bytes(self._buf[:8]) != SHM_MAGIC:
            raise ShmError(f"bad ring magic in segment {shm.name!r}")
        (self.capacity,) = _U64.unpack_from(self._buf, 8)
        self._closed = False

    # -- construction ---------------------------------------------------------
    @classmethod
    def create(cls, capacity: int = DEFAULT_CAPACITY) -> "ShmRing":
        shm = _shared_memory().SharedMemory(
            create=True, size=HEADER_BYTES + capacity
        )
        shm.buf[:HEADER_BYTES] = b"\x00" * HEADER_BYTES
        shm.buf[:8] = SHM_MAGIC
        _U64.pack_into(shm.buf, 8, capacity)
        _CREATED_HERE.add(shm.name)
        return cls(shm, own=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        shm = _shared_memory().SharedMemory(name=name)
        if shm.name in _CREATED_HERE:
            return cls(shm, own=False)
        try:
            # CPython < 3.13 registers every attach with the resource
            # tracker, which unlinks the segment when THIS process exits —
            # while the creator still uses it.  The creator owns unlinking;
            # deregister the attach-side bookkeeping.
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        return cls(shm, own=False)

    @property
    def name(self) -> str:
        return self._shm.name

    # -- header positions -----------------------------------------------------
    # u64 loads/stores on an aligned buffer are single machine accesses on
    # every platform we run; the pipe doorbell provides the cross-process
    # ordering, so these are bookkeeping reads, not synchronization.
    @property
    def write_pos(self) -> int:
        return _U64.unpack_from(self._buf, 16)[0]

    @write_pos.setter
    def write_pos(self, v: int) -> None:
        _U64.pack_into(self._buf, 16, v)

    @property
    def read_pos(self) -> int:
        return _U64.unpack_from(self._buf, 24)[0]

    @read_pos.setter
    def read_pos(self, v: int) -> None:
        _U64.pack_into(self._buf, 24, v)

    # -- writer side ----------------------------------------------------------
    def push(self, buffers: Sequence) -> Optional[int]:
        """Copy ``buffers`` into one contiguous stamped span; returns the
        span's generation (its absolute start position), or ``None`` if the
        ring lacks space — the caller's cue to fall back to the pipe."""
        total = STAMP_BYTES + sum(len(b) for b in buffers)
        pos = self.write_pos
        off = pos % self.capacity
        if off + total > self.capacity:  # wrap: skip the dead tail
            if self.read_pos == pos:
                # ring fully drained: the padding can never be read, and
                # with no span outstanding the reader cannot race this
                # store — consume the dead tail immediately so an empty
                # ring always fits any span <= capacity
                self.read_pos = pos + (self.capacity - off)
            pos += self.capacity - off
            off = 0
        if pos + total - self.read_pos > self.capacity:
            return None
        base = HEADER_BYTES + off
        _U64.pack_into(self._buf, base, pos)
        o = base + STAMP_BYTES
        for b in buffers:
            mv = memoryview(b).cast("B") if not isinstance(b, memoryview) else b.cast("B")
            n = len(mv)
            self._buf[o:o + n] = mv
            o += n
        self.write_pos = pos + total
        return pos

    # -- reader side ----------------------------------------------------------
    def view(self, gen: int, length: int) -> memoryview:
        """Zero-copy view of a span's payload.  Verifies the generation
        stamp: a reused or torn span raises :class:`ShmError` instead of
        returning foreign bytes."""
        off = gen % self.capacity
        base = HEADER_BYTES + off
        (stamp,) = _U64.unpack_from(self._buf, base)
        if stamp != gen:
            raise ShmError(
                f"stale shm span: stamp {stamp} != generation {gen} "
                "(ring reused before release?)"
            )
        return self._buf[base + STAMP_BYTES: base + STAMP_BYTES + length]

    def release(self, gen: int, length: int) -> None:
        """Return a span (and everything before it) to the writer.  FIFO:
        releasing span *k* frees every span pushed before *k* too.  A
        release after close is a no-op (teardown paths release defensively)."""
        if self._closed:
            return
        end = gen + STAMP_BYTES + length
        if end > self.read_pos:
            self.read_pos = end

    # -- fault injection -------------------------------------------------------
    def corrupt(self, gen: int, offset: int = 0) -> None:
        """Flip one payload byte of a pushed span — the fault-injection hook
        that simulates a torn/corrupted ring slot.  The span's descriptor CRC
        (computed before the flip) then fails verification on the receiver."""
        base = HEADER_BYTES + (gen % self.capacity) + STAMP_BYTES
        self._buf[base + offset] ^= 0xFF

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._buf = None
        try:
            self._shm.close()
        except BufferError:
            # Zero-copy views still reference the map — e.g. a traceback
            # frame cycle holding a gather's arrays through a worker-failure
            # unwind.  Abandon the mapping instead of fighting it: drop the
            # SharedMemory bookkeeping (so its __del__ cannot re-raise) and
            # close the fd; the map itself is reclaimed when the last view
            # dies (mmap dealloc) or at process exit.
            self._shm._buf = None
            self._shm._mmap = None
            fd = getattr(self._shm, "_fd", -1)
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
                self._shm._fd = -1
        except OSError:
            pass
        if self._own:
            try:
                self._shm.unlink()
            except (FileNotFoundError, OSError):
                pass

    def unlink(self) -> None:
        """Force-unlink the segment regardless of ownership — the orphan
        cleanup path: a worker whose coordinator died (EOF on the doorbell
        pipe) is the last process that will ever touch the segment, so it
        must reap it or the name leaks until reboot."""
        try:
            self._shm.unlink()
        except (FileNotFoundError, OSError):
            pass


class ShmTransport:
    """RKWP frames over a Connection, column payloads via :class:`ShmRing`.

    Drop-in for the ``wire.send`` / ``wire.recv`` pair with per-frame
    accounting split into *piped* and *shm* bytes.  Sending prefers the
    ring: the columns are packed into one span and the pipe frame carries a
    ``_shm`` descriptor in meta (``ncols=0``, header flag
    :data:`~repro_torch.dist.wire.FLAG_SHM`); if the ring is absent or full the
    frame ships inline — byte-compatible with a plain pipe peer.  Receiving
    auto-detects per frame, so a transport with rings attached understands
    both encodings at all times.

    ``zero_copy`` names the frame types whose decoded columns may be
    returned as **views into the ring** (hot-path frames whose consumer
    provably does not retain the arrays); everything else is copied on map.
    A zero-copy span stays held until the *next* :meth:`recv` on this
    transport (or an explicit :meth:`release_held`), which is the earliest
    point the protocol's request/reply discipline can touch it again.
    """

    def __init__(self, conn, send_ring: Optional[ShmRing] = None,
                 recv_ring: Optional[ShmRing] = None,
                 zero_copy: Iterable[int] = ()):
        self.conn = conn
        self.send_ring = send_ring
        self.recv_ring = recv_ring
        self.zero_copy = frozenset(zero_copy)
        self.piped_bytes = 0     # bytes through the pipe (frames + fallbacks)
        self.shm_bytes = 0       # payload bytes through the ring
        self.shm_frames = 0
        self.piped_frames = 0
        self._held: List[Tuple[int, int]] = []  # (gen, length) awaiting release
        #: emit CRC trailers (pipe frames) + span CRCs (ring descriptors).
        #: The coordinator sets this after HELLO advertises the "crc32" cap;
        #: a worker mirrors it on the first received frame carrying FLAG_CRC.
        self.crc = False
        #: whether this endpoint is *allowed* to mirror CRC (False simulates
        #: a v1 peer for the HELLO-negotiation interop tests)
        self.crc_capable = True
        #: fault-injection hook: flip one byte of the next pushed span after
        #: its descriptor CRC is computed (simulates a corrupted ring slot)
        self.corrupt_next_span = False

    # -- send ------------------------------------------------------------------
    def send(self, ftype: int, meta=None, cols=None) -> Tuple[int, int]:
        """Ship one frame; returns ``(piped_bytes, shm_bytes)`` for it."""
        cols = cols or {}
        base_flags = wire.FLAG_CRC if self.crc else 0
        if self.send_ring is not None and cols:
            specs, bufs, total = [], [], 0
            try:
                for name, arr in cols.items():
                    code, raw = wire.column_buffer(name, arr)
                    specs.append([name, code, len(raw)])
                    bufs.append(raw)
                    total += len(raw)
                gen = self.send_ring.push(bufs)
            except wire.WireError:
                gen = None  # unsupported column: the inline path will raise
            if gen is not None:
                m = dict(meta) if meta else {}
                desc = {"gen": gen, "cols": specs}
                if self.crc:
                    # span CRC rides the descriptor: the pipe frame's own
                    # trailer covers the descriptor, the descriptor covers
                    # the ring bytes — end-to-end integrity either path
                    desc["crc"] = wire.crc_of(bufs)
                m["_shm"] = desc
                if self.corrupt_next_span and total:
                    # strike the next span that actually carries payload —
                    # flipping a byte of a zero-length span is a no-op the
                    # receiver could never detect
                    self.corrupt_next_span = False
                    self.send_ring.corrupt(gen)
                piped = wire.send(self.conn, ftype, m, None,
                                  flags=wire.FLAG_SHM | base_flags)
                self.piped_bytes += piped
                self.shm_bytes += total
                self.shm_frames += 1
                return piped, total
        piped = wire.send(self.conn, ftype, meta, cols, flags=base_flags)
        self.piped_bytes += piped
        self.piped_frames += 1
        return piped, 0

    # -- recv ------------------------------------------------------------------
    def release_held(self) -> None:
        """Release every zero-copy span handed out by earlier ``recv`` calls.
        Views obtained from them are dead after this."""
        if self._held and self.recv_ring is not None:
            gen, length = self._held[-1]  # FIFO: last span covers the rest
            self.recv_ring.release(gen, length)
        self._held.clear()

    def recv(self) -> Tuple[int, Dict, Dict[str, np.ndarray]]:
        self.release_held()
        ftype, meta, cols, flags = wire.decode_ex(self.conn.recv_bytes())
        if flags & wire.FLAG_CRC and self.crc_capable and not self.crc:
            # the peer ships CRC-covered frames: mirror it on our replies
            # (this is how the worker side of the negotiation latches on)
            self.crc = True
        desc = meta.pop("_shm", None)
        if desc is None:
            return ftype, meta, cols
        if self.recv_ring is None:
            raise ShmError(
                f"frame {wire.FRAME_NAMES.get(ftype, ftype)} carries a shm "
                "descriptor but no ring is attached"
            )
        gen = int(desc["gen"])
        length = sum(int(nb) for _, _, nb in desc["cols"])
        payload = self.recv_ring.view(gen, length)
        want_crc = desc.get("crc")
        if want_crc is not None:
            got = wire.crc_of((payload,))
            if got != int(want_crc):
                self.recv_ring.release(gen, length)
                raise wire.CorruptFrame(
                    f"shm span CRC mismatch on "
                    f"{wire.FRAME_NAMES.get(ftype, ftype)}: computed "
                    f"{got:#010x} != descriptor {int(want_crc):#010x}"
                )
        out: Dict[str, np.ndarray] = {}
        off = 0
        copy = ftype not in self.zero_copy
        for name, code, nbytes in desc["cols"]:
            dt = wire._DTYPES.get(int(code))
            if dt is None:
                raise wire.WireError(
                    f"column {name!r}: unknown dtype code {code}"
                )
            arr = np.frombuffer(payload, dtype=dt,
                                count=int(nbytes) // dt.itemsize, offset=off)
            arr = arr.astype(dt.newbyteorder("="), copy=copy)
            out[name] = arr
            off += int(nbytes)
        if copy:
            self.recv_ring.release(gen, length)
        else:
            self._held.append((gen, length))
        return ftype, meta, out

    # -- lifecycle -------------------------------------------------------------
    def close(self, unlink: bool = False) -> None:
        """Close rings + pipe.  ``unlink=True`` force-unlinks the ring
        segments even from the attach side — the orphaned-worker path where
        the owning coordinator is already dead."""
        self.release_held()
        for ring in (self.send_ring, self.recv_ring):
            if ring is not None:
                ring.close()
                if unlink:
                    ring.unlink()
        self.send_ring = self.recv_ring = None
        try:
            self.conn.close()
        except OSError:
            pass


def pipe_transport(conn) -> ShmTransport:
    """A ring-less transport: every frame inline over the pipe (the
    fallback and the ``transport="pipe"`` configuration, one code path)."""
    return ShmTransport(conn)
