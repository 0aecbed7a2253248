"""The port's shared-memory transport against the JAX package's, on the CPU.

``repro_torch.dist.shm`` is a copy of the reference's ring transport with
the segment layout unchanged.  Held here, with both endpoints in one
process over a real ``multiprocessing`` pipe: a ring created by one package
is attached, pushed to, viewed and released by the other; transports of
the two packages talk to each other (ring and pipe fallback, CRC, corrupt
spans, zero-copy views).  And the shard host's zero-copy claim for the
port: a STEP's columns arrive as views of the ring, the CPU engine's
tensors alias them, and overwriting the span after the step leaves the
engine's state and outputs unchanged.
"""

import multiprocessing

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.dist import shm as jshm
from repro.dist import wire as jwire
from repro_torch.dist import shm as tshm
from repro_torch.dist import wire as twire
from repro_torch.keyed import KeyedWindowEngine, WindowSpec
from repro_torch.keyed import synthetic_keyed_items

PKGS = {"jax": jshm, "torch": tshm}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]
IDS = ["jax-to-torch", "torch-to-jax"]


def _attach(pkg, ring):
    """Attach ``ring`` with package ``pkg`` in this process.  Both ends
    live in one process here, so the attach is recorded as this process's
    own segment, as each package does for its own in-process pairs (the
    creator alone unlinks it)."""
    PKGS[pkg]._CREATED_HERE.add(ring.name)
    return PKGS[pkg].ShmRing.attach(ring.name)


def _pair(a_pkg, b_pkg, capacity=1 << 16, zero_copy=()):
    """Transport ``a`` of one package and ``b`` of the other, each ring
    created by its writer's package and attached by its reader's."""
    ca, cb = multiprocessing.Pipe()
    r_ab = PKGS[a_pkg].ShmRing.create(capacity)
    r_ba = PKGS[b_pkg].ShmRing.create(capacity)
    ta = PKGS[a_pkg].ShmTransport(ca, send_ring=r_ab,
                                  recv_ring=_attach(a_pkg, r_ba),
                                  zero_copy=zero_copy)
    tb = PKGS[b_pkg].ShmTransport(cb, send_ring=r_ba,
                                  recv_ring=_attach(b_pkg, r_ab),
                                  zero_copy=zero_copy)
    return ta, tb, (r_ab, r_ba)


def _close(*ends):
    ta, tb, rings = ends
    ta.close()
    tb.close()
    for r in rings:  # the creators' handles unlink
        r.close()


class TestRingLayout:
    def test_constants_identical(self):
        for name in ("SHM_MAGIC", "HEADER_BYTES", "STAMP_BYTES",
                     "DEFAULT_CAPACITY"):
            assert getattr(tshm, name) == getattr(jshm, name), name

    @pytest.mark.parametrize("maker,user", DIRECTIONS, ids=IDS)
    def test_ring_made_by_one_used_by_the_other(self, maker, user):
        """Create with one package; attach, view and release with the other
        (and push from the other's attach), through a wrap and a reused
        generation."""
        ring = PKGS[maker].ShmRing.create(256)
        other = _attach(user, ring)
        try:
            assert other.capacity == ring.capacity == 256
            g0 = ring.push([b"x" * 150, b"y" * 50])
            assert bytes(other.view(g0, 200)) == b"x" * 150 + b"y" * 50
            other.release(g0, 200)
            assert ring.read_pos == g0 + 208
            g1 = ring.push([b"z" * 200])  # wraps onto g0's storage
            assert g1 is not None and g1 != g0
            with pytest.raises(PKGS[user].ShmError):
                other.view(g0, 200)  # stale generation
            assert bytes(other.view(g1, 200)) == b"z" * 200
            other.release(g1, 200)
            # the attach can be the writer too: the header is shared
            g2 = other.push([b"w" * 16])
            assert ring.write_pos == other.write_pos == g2 + 24
            assert bytes(ring.view(g2, 16)) == b"w" * 16
        finally:
            other.close()
            ring.close()


class TestTransportsInteroperate:
    @pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
    @pytest.mark.parametrize("a_pkg,b_pkg", DIRECTIONS, ids=IDS)
    def test_frames_both_ways(self, a_pkg, b_pkg, crc):
        """Ring frames, an oversized frame on the pipe fallback and a
        column-less frame cross in both directions; zero-copy frame types
        map the ring; the byte accounting agrees."""
        ends = _pair(a_pkg, b_pkg, capacity=4096, zero_copy=(jwire.STEP,))
        ta, tb, _ = ends
        ta.crc = tb.crc = crc
        try:
            rng = np.random.default_rng(3)
            for i, (src, dst) in enumerate([(ta, tb), (tb, ta)] * 3):
                cols = {"key": rng.integers(-2**40, 2**40, 40 + i),
                        "slot_table": np.arange(9, dtype=np.int32)}
                piped, shm = src.send(jwire.STEP, {"i": i}, cols)
                assert shm == sum(c.nbytes for c in cols.values())
                ftype, meta, got = dst.recv()
                assert ftype == jwire.STEP and meta == {"i": i}
                assert not got["key"].flags.owndata  # a view of the ring
                for k in cols:
                    np.testing.assert_array_equal(got[k], cols[k])
                big = np.arange(4096, dtype=np.int64)  # 32 KiB > the ring
                piped, shm = src.send(jwire.ROWS, {"big": 1}, {"v": big})
                assert shm == 0 and piped > big.nbytes
                ftype, meta, got = dst.recv()
                assert ftype == jwire.ROWS and got["v"].flags.owndata
                np.testing.assert_array_equal(got["v"], big)
                src.send(jwire.OK, {"n": i})
                assert dst.recv() == (jwire.OK, {"n": i}, {})
            assert ta.shm_frames == tb.shm_frames == 3
            assert ta.piped_frames == tb.piped_frames == 6
        finally:
            _close(*ends)

    @pytest.mark.parametrize("a_pkg,b_pkg", DIRECTIONS, ids=IDS)
    def test_corrupt_span_caught_by_the_other(self, a_pkg, b_pkg):
        ends = _pair(a_pkg, b_pkg)
        ta, tb, _ = ends
        ta.crc = True
        try:
            ta.corrupt_next_span = True
            ta.send(jwire.STEP_OUT, {}, {"v": np.arange(8, dtype=np.int64)})
            with pytest.raises(PKGS[b_pkg].wire.CorruptFrame):
                tb.recv()
            assert tb.crc  # the receiver latched onto the sender's CRC
            ta.send(jwire.STEP_OUT, {"ok": 1},
                    {"v": np.arange(8, dtype=np.int64)})
            _, meta, cols = tb.recv()
            assert meta == {"ok": 1}
            np.testing.assert_array_equal(cols["v"], np.arange(8))
        finally:
            _close(*ends)

    @settings(max_examples=20, deadline=None)
    @given(st.sampled_from(DIRECTIONS),
           st.lists(st.sampled_from(["<i8", "<i4", "<f8", "|b1", "|u1"]),
                    max_size=4),
           st.lists(st.integers(-(2 ** 31), 2 ** 31 - 1), max_size=30))
    def test_random_columns_round_trip(self, direction, dtypes, values):
        ends = _pair(*direction)
        ta, tb, _ = ends
        try:
            cols = {f"c{i}": np.asarray(values).astype(d) if values
                    else np.zeros(0, d) for i, d in enumerate(dtypes)}
            ta.send(jwire.SNAPSHOT, {"n": len(values)}, cols)
            ftype, meta, got = tb.recv()
            assert (ftype, meta) == (jwire.SNAPSHOT, {"n": len(values)})
            assert list(got) == list(cols)
            for k in cols:
                np.testing.assert_array_equal(got[k], cols[k])
        finally:
            _close(*ends)


class TestEngineDoesNotRetainRingColumns:
    @pytest.mark.parametrize("backend", ["host", "device_table"])
    @pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
    def test_overwritten_span_leaves_engine_unchanged(self, kind, backend):
        """The shard host maps STEP columns zero-copy.  Each chunk goes
        through a ring to a CPU engine exactly as the shard host feeds it;
        the engine's tensors alias the ring (so the check below is not
        vacuous); then the whole data region is overwritten.  The engine's
        outputs and snapshot equal a twin engine fed private copies, chunk
        after chunk."""
        spec = {
            "tumbling": WindowSpec("tumbling", size=8, lateness=3,
                                   late_policy="side", early_every=2),
            "sliding": WindowSpec("sliding", size=9, slide=4, lateness=3,
                                  late_policy="side", early_every=2),
            "session": WindowSpec("session", gap=5, lateness=3,
                                  late_policy="side", early_every=2),
        }[kind]
        kw = dict(num_slots=12, backend=backend, capacity=16, max_probes=2,
                  ttl=4, device="cpu")
        eng, twin = KeyedWindowEngine(spec, **kw), KeyedWindowEngine(spec, **kw)
        items = synthetic_keyed_items(16 * 6, num_keys=9, disorder=4, seed=2)
        a, b = multiprocessing.Pipe()
        ring = tshm.ShmRing.create(1 << 14)
        coord = tshm.ShmTransport(a, send_ring=ring)
        host = tshm.ShmTransport(b, recv_ring=_attach("torch", ring),
                                 zero_copy=(twire.STEP,))
        data = slice(tshm.HEADER_BYTES, tshm.HEADER_BYTES + ring.capacity)
        try:
            for i in range(0, len(items), 16):
                chunk = items[i: i + 16]
                pos = np.arange(i, i + len(chunk), dtype=np.int64)
                wm_ts = int(chunk["ts"].max())
                coord.send(twire.STEP, {"wm_ts": wm_ts},
                           {"key": chunk["key"], "value": chunk["value"],
                            "ts": chunk["ts"], "pos": pos})
                _, meta, cols = host.recv()
                assert not cols["key"].flags.owndata
                # on the CPU, torch.as_tensor (the engine's) aliases it
                assert torch.as_tensor(cols["key"]).data_ptr() == \
                    cols["key"].ctypes.data
                out = eng.process_chunk(
                    {k: cols[k] for k in ("key", "value", "ts")},
                    wm_ts=meta["wm_ts"], positions=cols["pos"])
                want = twin.process_chunk(
                    {k: chunk[k].copy() for k in ("key", "value", "ts")},
                    wm_ts=wm_ts, positions=pos.copy())
                ring._buf[data] = b"\xa5" * ring.capacity
                for ch in ("emissions", "early", "late"):
                    for k in want[ch]:
                        np.testing.assert_array_equal(out[ch][k],
                                                      want[ch][k])
                snap, twin_snap = eng.snapshot(), twin.snapshot()
                for k in twin_snap:
                    np.testing.assert_array_equal(snap[k], twin_snap[k],
                                                  err_msg=k)
        finally:
            host.close()
            coord.close()
            ring.close()
