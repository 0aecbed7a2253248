"""Length-prefixed binary wire protocol for the distributed keyed plane.

A copy of ``repro/dist/wire.py`` (pure numpy, ``zlib``, ``struct`` and
``json``): the port never imports the JAX package, and its frames are
byte-identical to the reference's (``tests/test_torch_wire.py``).

One codec serves every frame the plane ships — chunk scatter, emission
gather, row-level migration, checkpoint snapshots — because they are all the
same physical shape: a tiny scalar header plus named flat numpy columns.
The ``extract_rows`` canonical sorted-row payload (7 int64 columns) IS the
migration unit, so migration frames and checkpoint frames reuse the exact
byte layout, and "bytes on the wire" is a measurable, gateable quantity.

The format is specified independently of this code in
``docs/wire-protocol.md`` (header layout, column encoding, versioning
rules); keep the two in sync.  Layout summary::

    frame  := header || meta || column*
    header := magic "RKWP" (4s) | version u8 | ftype u8 | flags u16 LE
              | meta_len u32 LE | ncols u16 LE | reserved u16 LE
    meta   := meta_len bytes of UTF-8 JSON (scalars / small lists only)
    column := name_len u8 | name (UTF-8) | dtype_code u8 | nbytes u32 LE
              | raw little-endian array bytes

Transport framing: :func:`send` / :func:`recv` ride a
``multiprocessing.Connection`` (which length-delimits messages itself);
:func:`write_frame` / :func:`read_frame` add an explicit u32 length prefix
for raw byte streams (sockets, files) — both carry the identical frame
bytes, so the codec round-trip is transport-agnostic and property-testable
against ``io.BytesIO``.

Versioning: ``VERSION`` bumps on ANY layout change; a decoder receiving a
frame with an unknown magic or version raises :class:`WireError` instead of
guessing — the coordinator treats that as a worker failure, never as data.
Version 2 appends an optional CRC32 trailer (``FLAG_CRC``) over the whole
frame; emitters label each frame with the *minimum* version that can decode
it (plain frames stay v1), so a CRC-off peer negotiated via HELLO caps
interoperates byte-for-byte with a v1 decoder.

Integrity: when ``FLAG_CRC`` is set the last 4 bytes of the frame are the
little-endian CRC32 (``zlib.crc32``; the container ships no crc32c module,
and the algorithm name is negotiated via HELLO caps as ``"crc32"`` so both
ends always agree) of everything before them.  A mismatch raises
:class:`CorruptFrame` — a retriable subclass of :class:`WireError` — so the
coordinator can retransmit instead of declaring the worker dead.

Hostile input: :func:`decode` and :func:`read_frame` sanity-cap every
declared length (frame, meta, column count) *before* allocating, and wrap
every malformed-input failure (struct underflow, bad UTF-8, bad JSON,
unknown dtype, ragged column bytes) in a precise :class:`WireError` — a
hostile or bit-flipped frame can never raise a raw ``struct.error`` or
force a giant allocation.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"RKWP"          # Repro Keyed Wire Protocol
VERSION = 2

#: hard ceilings on declared sizes — checked BEFORE any allocation so a
#: corrupt length prefix cannot OOM the receiver.  Generous vs real traffic
#: (the largest legitimate frames are multi-MB snapshots).
MAX_FRAME_BYTES = 1 << 28   # 256 MiB per frame
MAX_META_BYTES = 1 << 20    # 1 MiB of JSON meta
MAX_COLS = 4096

CRC_BYTES = 4

_HEADER = struct.Struct("<4sBBHIHH")  # magic, ver, ftype, flags, meta, ncols, rsvd
HEADER_BYTES = _HEADER.size

#: header flag: the frame's column payload rides a shared-memory ring
#: (``repro_torch.dist.shm``) instead of inline column records — the frame itself
#: carries ``ncols=0`` plus a ``_shm`` descriptor in meta.  Decoders that
#: don't know the flag still decode the frame correctly (it IS a valid
#: column-free frame); the descriptor is only meaningful to a receiver
#: attached to the sender's ring.
FLAG_SHM = 0x0001

#: header flag: the frame ends with a 4-byte CRC32 trailer over everything
#: before it (header included, so the flag itself is covered).  Emission is
#: negotiated per-link via HELLO caps (``"crc32"``); verification is
#: unconditional whenever the flag is present.
FLAG_CRC = 0x0002

# -- frame types -------------------------------------------------------------
HELLO = 0x01         # worker -> coord: alive, pid, blackbox path
ATTACH = 0x02        # coord -> worker: hydrate one engine shard
STEP = 0x03          # coord -> worker: routed sub-chunk + shared clock
STEP_OUT = 0x04      # worker -> coord: emissions / early / late (+ spans)
SNAPSHOT_REQ = 0x05  # coord -> worker: serialize to canonical form
SNAPSHOT = 0x06      # worker -> coord: the canonical engine snapshot
EXTRACT = 0x07       # coord -> worker: pull moved slots' rows (donor half)
ROWS = 0x08          # worker -> coord: extract_rows payload (7 columns)
INGEST = 0x09        # coord -> worker: adopt migrated rows (recipient half)
APPLY = 0x0A         # coord -> worker: new slot table + folded tally
HEALTH_REQ = 0x0B    # coord -> worker: table health / tier gauges
HEALTH = 0x0C        # worker -> coord: health snapshot (meta only)
DETACH = 0x0D        # coord -> worker: drop the engine, stay warm
SHUTDOWN = 0x0E      # coord -> worker: exit cleanly
CRASH = 0x0F         # coord -> worker: die mid-flight (failure drills)
OK = 0x10            # worker -> coord: ack (may carry counters in meta)
ERR = 0x11           # worker -> coord: exception text in meta
FAULT = 0x12         # coord -> worker: arm injected faults (repro_torch.dist.faults)
PING = 0x13          # coord -> worker: liveness probe (out-of-band, no seq)
PONG = 0x14          # worker -> coord: probe answer
NACK = 0x15          # worker -> coord: corrupt/gapped request; meta carries
                     #   "have" = last seq served, coordinator retransmits

FRAME_NAMES = {
    v: k for k, v in list(globals().items())
    if isinstance(v, int) and k.isupper()
    and k not in ("VERSION", "HEADER_BYTES", "CRC_BYTES")
    and not k.startswith(("FLAG_", "MAX_"))
}

#: wire dtype codes — int64 is the plane's lingua franca (rows, chunks,
#: counters); int32 covers the slot table; the rest future-proof the codec
_DTYPES = {
    0: np.dtype("<i8"),
    1: np.dtype("<i4"),
    2: np.dtype("<f8"),
    3: np.dtype("|b1"),
    4: np.dtype("|u1"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}
_CANON = {  # anything else canonicalizes to one of the wire dtypes
    np.dtype(np.int64): np.dtype("<i8"),
    np.dtype(np.int32): np.dtype("<i4"),
    np.dtype(np.float64): np.dtype("<f8"),
    np.dtype(np.bool_): np.dtype("|b1"),
    np.dtype(np.uint8): np.dtype("|u1"),
}


class WireError(RuntimeError):
    """Malformed, truncated, or version-incompatible frame."""


class CorruptFrame(WireError):
    """Frame failed its CRC check — the *transport* mangled it in flight.

    Distinguished from plain :class:`WireError` because it is retriable:
    the sender still holds the request, so the coordinator retransmits with
    exponential backoff instead of declaring the worker dead."""


def crc_of(parts) -> int:
    """CRC32 (``zlib.crc32``) over a sequence of byte buffers."""
    c = 0
    for p in parts:
        c = zlib.crc32(p, c)
    return c & 0xFFFFFFFF


def column_buffer(name: str, arr: np.ndarray) -> Tuple[int, memoryview]:
    """Canonicalize one column to its wire form without copying: returns
    ``(dtype_code, flat little-endian byte view)``.  The view keeps the
    canonicalized array alive; it is the exact byte sequence :func:`encode`
    would embed for this column."""
    a = np.ascontiguousarray(arr)
    dt = _CANON.get(a.dtype, a.dtype)
    if dt not in _DTYPE_CODES:
        raise WireError(f"column {name!r}: unsupported dtype {a.dtype}")
    if a.ndim != 1:
        raise WireError(f"column {name!r}: must be 1-D, got shape {a.shape}")
    a = a.astype(dt, copy=False)
    return _DTYPE_CODES[dt], memoryview(a).cast("B")


def encode_parts(
    ftype: int,
    meta: Optional[Dict] = None,
    cols: Optional[Dict[str, np.ndarray]] = None,
    flags: int = 0,
) -> List[memoryview]:
    """Serialize one frame as a vectored sequence of buffers.

    ``b"".join(encode_parts(...))`` is byte-identical to
    :func:`encode` — but the column payloads stay *views* over the source
    arrays (no per-frame concatenation copy), so a vectored writer
    (``os.writev``, repeated ``stream.write``) ships them without ever
    materializing the frame.
    """
    meta_b = json.dumps(meta, separators=(",", ":")).encode() if meta else b""
    cols = cols or {}
    # label the frame with the minimum version able to decode it: plain
    # frames are exactly v1 frames, so a CRC-off link stays interoperable
    # with v1-only peers
    ver = 2 if flags & FLAG_CRC else 1
    parts = [
        memoryview(
            _HEADER.pack(MAGIC, ver, ftype, flags, len(meta_b),
                         len(cols), 0)
        ),
        memoryview(meta_b),
    ]
    for name, arr in cols.items():
        code, raw = column_buffer(name, arr)
        nb = name.encode()
        if len(nb) > 255:
            raise WireError(f"column name too long: {name!r}")
        parts.append(memoryview(struct.pack("<B", len(nb)) + nb
                                + struct.pack("<BI", code, len(raw))))
        parts.append(raw)
    if flags & FLAG_CRC:
        parts.append(memoryview(struct.pack("<I", crc_of(parts))))
    return parts


def encode(
    ftype: int,
    meta: Optional[Dict] = None,
    cols: Optional[Dict[str, np.ndarray]] = None,
    flags: int = 0,
) -> bytes:
    """Serialize one frame to bytes.

    ``meta`` is a small JSON-scalar dict; ``cols`` maps column names to 1-D
    numpy arrays of a wire dtype (int64/int32/float64/bool/uint8).  Column
    order is preserved (dict order), so encode→decode is byte-stable.
    """
    return b"".join(encode_parts(ftype, meta, cols, flags))


def decode(buf: bytes) -> Tuple[int, Dict, Dict[str, np.ndarray]]:
    """Parse one frame; returns ``(ftype, meta, cols)``.

    Decoded columns are fresh arrays in native byte order (little-endian
    platforms share the buffer layout; the copy decouples them from ``buf``).
    """
    ftype, meta, cols, _flags = decode_ex(buf)
    return ftype, meta, cols


def decode_ex(buf: bytes) -> Tuple[int, Dict, Dict[str, np.ndarray], int]:
    """:func:`decode` plus the raw header flags, for transports that need
    them (a worker mirrors ``FLAG_CRC`` back once it sees the coordinator
    emit it, so CRC negotiation needs no extra round trip)."""
    if len(buf) > MAX_FRAME_BYTES:
        raise WireError(f"frame too large: {len(buf)} > {MAX_FRAME_BYTES}")
    if len(buf) < HEADER_BYTES:
        raise WireError(f"truncated header: {len(buf)} < {HEADER_BYTES}")
    magic, ver, ftype, flags, meta_len, ncols, _rsvd = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if ver not in (1, 2):
        raise WireError(f"wire version {ver} not in (1, 2)")
    end = len(buf)
    if flags & FLAG_CRC:
        if end < HEADER_BYTES + CRC_BYTES:
            raise WireError("truncated CRC trailer")
        end -= CRC_BYTES
        (want,) = struct.unpack_from("<I", buf, end)
        got = zlib.crc32(buf[:end]) & 0xFFFFFFFF
        if got != want:
            raise CorruptFrame(
                f"CRC mismatch: computed {got:#010x} != trailer {want:#010x}"
            )
    if meta_len > MAX_META_BYTES:
        raise WireError(f"declared meta_len {meta_len} > {MAX_META_BYTES}")
    if ncols > MAX_COLS:
        raise WireError(f"declared ncols {ncols} > {MAX_COLS}")
    off = HEADER_BYTES
    if end < off + meta_len:
        raise WireError("truncated meta")
    if meta_len:
        try:
            meta = json.loads(buf[off:off + meta_len])
        except (ValueError, UnicodeDecodeError) as e:
            raise WireError(f"malformed meta JSON: {e}") from None
        if not isinstance(meta, dict):
            raise WireError(f"meta is {type(meta).__name__}, not an object")
    else:
        meta = {}
    off += meta_len
    cols: Dict[str, np.ndarray] = {}
    for i in range(ncols):
        if end < off + 1:
            raise WireError(f"column {i}: truncated name length")
        (nlen,) = struct.unpack_from("<B", buf, off)
        off += 1
        if end < off + nlen + 5:
            raise WireError(f"column {i}: truncated descriptor")
        try:
            name = buf[off:off + nlen].decode()
        except UnicodeDecodeError as e:
            raise WireError(f"column {i}: malformed name: {e}") from None
        off += nlen
        code, nbytes = struct.unpack_from("<BI", buf, off)
        off += 5
        dt = _DTYPES.get(code)
        if dt is None:
            raise WireError(f"column {name!r}: unknown dtype code {code}")
        if end < off + nbytes:
            raise WireError(f"column {name!r}: truncated payload")
        if nbytes % dt.itemsize:
            raise WireError(
                f"column {name!r}: {nbytes} bytes not a multiple of "
                f"itemsize {dt.itemsize}"
            )
        arr = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize,
                            offset=off).copy()
        cols[name] = arr.astype(arr.dtype.newbyteorder("="), copy=False)
        off += nbytes
    if off != end:
        raise WireError(f"{end - off} trailing bytes after last column")
    return ftype, meta, cols, flags


# -- transport: multiprocessing.Connection ----------------------------------

def _writev_all(fd: int, parts: List[memoryview]) -> None:
    """``os.writev`` the buffer sequence fully, resuming across partial
    writes (a full pipe buffer may accept any byte count mid-buffer)."""
    bufs = [p for p in parts if len(p)]
    while bufs:
        n = os.writev(fd, bufs)
        while bufs and n >= len(bufs[0]):
            n -= len(bufs[0])
            bufs.pop(0)
        if n:
            bufs[0] = bufs[0][n:]


def send(conn, ftype: int, meta=None, cols=None, flags: int = 0) -> int:
    """Encode and ship one frame over a Connection; returns bytes sent
    (the frame size — what the migration-volume accounting sums).

    The frame is written as a vectored sequence (header prefix + parts)
    straight from the column arrays' memory — no intermediate ``b"".join``
    copy.  The byte stream is identical to ``conn.send_bytes(encode(...))``
    (``Connection`` frames messages as ``!i length || payload``), which
    :func:`recv` / ``recv_bytes`` on the peer reads back unchanged.
    """
    parts = encode_parts(ftype, meta, cols, flags)
    n = sum(len(p) for p in parts)
    try:
        fd = conn.fileno()
    except (OSError, AttributeError):
        fd = None
    if fd is None or n > 0x7FFFFFFF:
        conn.send_bytes(b"".join(parts))
        return n
    _writev_all(fd, [memoryview(struct.pack("!i", n))] + parts)
    return n


def recv(conn) -> Tuple[int, Dict, Dict[str, np.ndarray]]:
    """Receive and decode one frame (blocking).  EOF propagates as the
    Connection's ``EOFError`` — the coordinator's worker-death signal."""
    return decode(conn.recv_bytes())


# -- transport: raw byte streams (sockets / files / BytesIO) -----------------

def write_frame(stream, ftype: int, meta=None, cols=None, flags: int = 0) -> int:
    """Write ``u32 length || frame`` to a byte stream; returns bytes written
    including the prefix.  The frame is written part-by-part straight from
    the column arrays (no intermediate frame concatenation)."""
    parts = encode_parts(ftype, meta, cols, flags)
    n = sum(len(p) for p in parts)
    stream.write(struct.pack("<I", n))
    for p in parts:
        stream.write(p)
    return 4 + n


def read_frame(
    stream, max_bytes: int = MAX_FRAME_BYTES
) -> Tuple[int, Dict, Dict[str, np.ndarray]]:
    """Read one length-prefixed frame from a byte stream.

    The declared length is capped at ``max_bytes`` BEFORE the payload read,
    so a corrupt or hostile prefix (e.g. ``0xFFFFFFFF``) raises a precise
    :class:`WireError` instead of attempting a 4 GiB allocation."""
    prefix = stream.read(4)
    if len(prefix) < 4:
        raise WireError("truncated length prefix")
    (n,) = struct.unpack("<I", prefix)
    if n > max_bytes:
        raise WireError(f"declared frame length {n} > cap {max_bytes}")
    if n < HEADER_BYTES:
        raise WireError(f"declared frame length {n} < header {HEADER_BYTES}")
    buf = stream.read(n)
    if len(buf) < n:
        raise WireError(f"truncated frame: {len(buf)} < {n}")
    return decode(buf)


# -- canonical payload helpers ----------------------------------------------

#: column names of the ``extract_rows`` canonical sorted-row payload — the
#: one physical migration/checkpoint row layout (7 int64 columns, 56 B/row)
ROW_COLUMNS = ("key", "start", "end", "value", "count", "resident", "touch")

#: engine-snapshot scalars that ride in frame meta (ints); every other
#: snapshot entry is a genuine array column
SNAPSHOT_SCALARS = (
    "n_workers", "wm", "wm_valid", "wm_ticks", "max_ts", "max_ts_valid",
    "late_count", "t_inserted", "t_hits", "t_spilled", "t_evicted",
)


def rows_to_cols(rows: Tuple[np.ndarray, ...]) -> Dict[str, np.ndarray]:
    """Name an ``extract_rows`` tuple for the wire (ROWS / INGEST frames)."""
    return {name: np.asarray(col, np.int64)
            for name, col in zip(ROW_COLUMNS, rows)}


def cols_to_rows(cols: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
    """Invert :func:`rows_to_cols` (decode side)."""
    return tuple(np.asarray(cols[name], np.int64) for name in ROW_COLUMNS)


def snapshot_to_frame(snap: Dict) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Split a canonical engine snapshot into (meta, cols) for a SNAPSHOT
    frame: numpy int64 scalars to JSON meta, arrays to raw columns."""
    meta = {k: int(snap[k]) for k in SNAPSHOT_SCALARS}
    cols = {
        k: np.asarray(v)
        for k, v in snap.items() if k not in SNAPSHOT_SCALARS
    }
    return meta, cols


def frame_to_snapshot(meta: Dict, cols: Dict[str, np.ndarray]) -> Dict:
    """Rebuild the canonical snapshot dict from a SNAPSHOT frame."""
    snap = {k: np.asarray(v) for k, v in cols.items()}
    snap["slot_table"] = np.asarray(snap["slot_table"], np.int32)
    for k in SNAPSHOT_SCALARS:
        snap[k] = np.int64(meta[k])
    return snap
