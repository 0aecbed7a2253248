"""The port's RKWP codec and fault plans against the JAX package's, on the CPU.

``repro_torch.dist.wire`` and ``repro_torch.dist.faults`` are copies of the
reference's pure-numpy modules.  Held here: for every frame type, with and
without the CRC trailer, both packages encode the same ``(ftype, meta,
cols, flags)`` to the same bytes (whole, vectored and length-prefixed);
each decodes the other's frames, the canonical snapshot and row payloads
included; a corrupt or truncated frame raises the same exception class in
both; and ``FaultPlan.storm(seed, ...)`` draws the same faults.
"""

import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.dist import faults as jfaults
from repro.dist import wire as jwire
from repro.keyed import KeyedWindowEngine as JEngine
from repro.keyed import WindowSpec as JSpec
from repro.keyed import synthetic_keyed_items
from repro_torch.dist import faults as tfaults
from repro_torch.dist import wire as twire
from repro_torch.keyed import KeyedWindowEngine as TEngine
from repro_torch.keyed import WindowSpec as TSpec

NUM_SLOTS = 12
FRAME_TYPES = sorted(jwire.FRAME_NAMES)


def _sample_cols():
    return {
        "key": np.arange(-3, 6, dtype=np.int64),
        "slot_table": np.arange(7, dtype=np.int32),
        "f": np.linspace(0.0, 1.0, 4),
        "b": np.array([True, False, True]),
        "u": np.arange(5, dtype=np.uint8),
        "empty": np.zeros(0, np.int64),
    }


def _engine(pkg, backend, n_items, seed=0):
    """An engine of either package with standing state (``capacity=4``
    under ``device_table`` forces spill-tier rows)."""
    kw = dict(capacity=4, max_probes=2) if backend == "device_table" else {}
    if pkg == "jax":
        eng = JEngine(JSpec("tumbling", size=7, lateness=3,
                            late_policy="side"),
                      num_slots=NUM_SLOTS, n_workers=3, backend=backend, **kw)
    else:
        eng = TEngine(TSpec("tumbling", size=7, lateness=3,
                            late_policy="side"),
                      num_slots=NUM_SLOTS, n_workers=3, backend=backend,
                      device="cpu", **kw)
    if n_items:
        items = synthetic_keyed_items(n_items, num_keys=max(2, n_items // 2),
                                      disorder=3, seed=seed)
        eng.process_chunk({k: items[k] for k in ("key", "value", "ts")})
    return eng


def _assert_cols_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _error_name(fn):
    try:
        fn()
    except Exception as e:  # the class NAME is what must agree
        return type(e).__name__
    return None


class TestConstants:
    def test_layout_constants_identical(self):
        for name in ("MAGIC", "VERSION", "HEADER_BYTES", "CRC_BYTES",
                     "FLAG_SHM", "FLAG_CRC", "MAX_FRAME_BYTES",
                     "MAX_META_BYTES", "MAX_COLS", "ROW_COLUMNS",
                     "SNAPSHOT_SCALARS", "FRAME_NAMES"):
            assert getattr(twire, name) == getattr(jwire, name), name
        assert twire.MAGIC == b"RKWP" and twire.VERSION == 2
        assert {k: str(v) for k, v in twire._DTYPES.items()} == \
            {k: str(v) for k, v in jwire._DTYPES.items()}


class TestFramesByteIdentical:
    @pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
    @pytest.mark.parametrize(
        "ftype", FRAME_TYPES, ids=[jwire.FRAME_NAMES[t] for t in FRAME_TYPES])
    def test_every_frame_type(self, ftype, crc):
        """The same frame from both packages: whole, vectored and
        length-prefixed bytes equal; each package decodes the other's."""
        flags = jwire.FLAG_CRC if crc else 0
        meta = {"seq": 7, "shard": 2, "wm_ts": -12345, "spans": [["x", 1.5,
                                                                   2.25, None]]}
        cols = _sample_cols()
        j = jwire.encode(ftype, meta, cols, flags=flags)
        t = twire.encode(ftype, meta, cols, flags=flags)
        assert t == j
        assert b"".join(twire.encode_parts(ftype, meta, cols, flags)) == j
        bj, bt = io.BytesIO(), io.BytesIO()
        jwire.write_frame(bj, ftype, meta, cols, flags=flags)
        twire.write_frame(bt, ftype, meta, cols, flags=flags)
        assert bt.getvalue() == bj.getvalue()
        for dec, buf in ((twire.decode_ex, j), (jwire.decode_ex, t)):
            got_t, got_m, got_c, got_f = dec(buf)
            assert (got_t, got_m, got_f) == (ftype, meta, flags)
            _assert_cols_equal(got_c, cols)
        bt.seek(0)
        assert jwire.read_frame(bt)[0] == ftype

    @pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
    def test_meta_only_and_empty_frames(self, crc):
        flags = jwire.FLAG_CRC if crc else 0
        for meta, cols in ((None, None), ({"a": 1}, None), (None, {})):
            assert twire.encode(jwire.OK, meta, cols, flags) == \
                jwire.encode(jwire.OK, meta, cols, flags)

    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.integers(-(2 ** 63), 2 ** 63 - 1), max_size=40),
           st.integers(0, 3), st.booleans())
    def test_arbitrary_int64_columns(self, vals, ncols, crc):
        flags = jwire.FLAG_CRC if crc else 0
        cols = {f"c{i}": np.asarray(vals[i:], np.int64) for i in range(ncols)}
        assert twire.encode(jwire.STEP, {"n": len(vals)}, cols, flags) == \
            jwire.encode(jwire.STEP, {"n": len(vals)}, cols, flags)


class TestCanonicalPayloads:
    @pytest.mark.parametrize("n_items", [0, 1, 40])
    @pytest.mark.parametrize("backend", ["host", "device_table"])
    def test_snapshot_frames_cross_decode(self, backend, n_items):
        """Both packages' engines give the same canonical snapshot, its
        SNAPSHOT frame is the same bytes from either codec, and each
        codec's ``frame_to_snapshot`` rebuilds it from the other's."""
        j_snap = _engine("jax", backend, n_items, seed=3).snapshot()
        t_snap = _engine("torch", backend, n_items, seed=3).snapshot()
        jm, jc = jwire.snapshot_to_frame(j_snap)
        tm, tc = twire.snapshot_to_frame(t_snap)
        assert tm == jm
        frame_j = jwire.encode(jwire.SNAPSHOT, jm, jc, jwire.FLAG_CRC)
        frame_t = twire.encode(twire.SNAPSHOT, tm, tc, twire.FLAG_CRC)
        assert frame_t == frame_j
        for dec, fts, buf in ((twire, twire.frame_to_snapshot, frame_j),
                              (jwire, jwire.frame_to_snapshot, frame_t)):
            _, meta, cols = dec.decode(buf)
            snap = fts(meta, cols)
            assert set(snap) == set(j_snap)
            for k in j_snap:
                assert np.asarray(snap[k]).dtype == \
                    np.asarray(j_snap[k]).dtype, k
                np.testing.assert_array_equal(snap[k], j_snap[k], err_msg=k)

    @pytest.mark.parametrize("backend", ["host", "device_table"])
    def test_row_payloads_cross_decode(self, backend):
        j_rows = _engine("jax", backend, 40, seed=5).extract_rows(
            np.arange(NUM_SLOTS, dtype=np.int64))
        t_rows = _engine("torch", backend, 40, seed=5).extract_rows(
            np.arange(NUM_SLOTS, dtype=np.int64))
        for a, b in zip(j_rows, t_rows):
            np.testing.assert_array_equal(a, b)
        frame_t = twire.encode(twire.ROWS, {"rows": len(t_rows[0])},
                               twire.rows_to_cols(t_rows))
        assert frame_t == jwire.encode(jwire.ROWS, {"rows": len(j_rows[0])},
                                       jwire.rows_to_cols(j_rows))
        back = jwire.cols_to_rows(jwire.decode(frame_t)[2])
        for a, b in zip(back, j_rows):
            np.testing.assert_array_equal(a, b)


class TestMalformedFramesSameErrors:
    def _frame(self, crc):
        return jwire.encode(
            jwire.STEP, {"seq": 3, "wm_ts": 12345},
            {"key": np.arange(9, dtype=np.int64), "f": np.linspace(0, 1, 5)},
            flags=jwire.FLAG_CRC if crc else 0)

    @pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
    def test_every_truncation_and_flip(self, crc):
        """Every truncation point and one flipped bit at every byte: both
        decoders succeed alike or raise the same exception class."""
        frame = self._frame(crc)
        bad = [frame[:n] for n in range(len(frame))]
        for i in range(len(frame)):
            b = bytearray(frame)
            b[i] ^= 1 << (i % 8)
            bad.append(bytes(b))
        bad.append(frame + b"\x00")  # trailing byte
        for buf in bad:
            j = _error_name(lambda: jwire.decode(buf))
            t = _error_name(lambda: twire.decode(buf))
            assert t == j, buf

    def test_stream_and_encode_refusals(self):
        cases = [
            lambda w: w.read_frame(io.BytesIO(b"\xff\xff\xff\xff" + b"x" * 8)),
            lambda w: w.read_frame(io.BytesIO(b"\x02\x00\x00\x00ab")),
            lambda w: w.read_frame(io.BytesIO(b"\x01\x00")),
            lambda w: w.encode(w.STEP, None, {"c": np.zeros(3, np.int16)}),
            lambda w: w.encode(w.STEP, None, {"c": np.zeros((2, 2))}),
            lambda w: w.decode(b"RKWP" + b"\x00" * w.MAX_FRAME_BYTES),
        ]
        for case in cases:
            j = _error_name(lambda: case(jwire))
            assert j == "WireError"
            assert _error_name(lambda: case(twire)) == j


class TestFaultPlans:
    @pytest.mark.parametrize("seed", [0, 1, 4, 13, 2024])
    def test_storm_draws_the_reference_faults(self, seed):
        for kw in (dict(n_shards=3, n_chunks=10),
                   dict(n_shards=8, n_chunks=36, include_kills=False,
                        include_shm=False),
                   dict(n_shards=5, n_chunks=6, migrate_ops=True,
                        delay_s=0.02)):
            j = jfaults.FaultPlan.storm(seed, **kw)
            t = tfaults.FaultPlan.storm(seed, **kw)
            assert [f.to_dict() for f in t.faults] == \
                [f.to_dict() for f in j.faults]
            assert t.worker_faults() == j.worker_faults()

    def test_matcher_fires_alike(self):
        """Both plans fire the same faults on the same draw sequence, and
        attribute kills alike."""
        j = jfaults.FaultPlan.storm(4, n_shards=3, n_chunks=10)
        t = tfaults.FaultPlan.storm(4, n_shards=3, n_chunks=10)
        for i in range(40):
            for site, op in (("send", "STEP"), ("reply", "STEP"),
                             ("worker", "STEP"), ("shm", "STEP")):
                fj = j.draw(site, op, i % 3)
                ft = t.draw(site, op, i % 3)
                assert (ft and ft.to_dict()) == (fj and fj.to_dict())
        j.consume_kill("hung", [0, 1, 2])
        t.consume_kill("hung", [0, 1, 2])
        assert t.fired == j.fired and t.kinds_fired() == j.kinds_fired()

    def test_invalid_plans_refused_alike(self):
        for bad in (dict(site="nowhere", op="STEP", kind="drop"),
                    dict(site="send", op="STEP", kind="hang"),
                    dict(site="send", op="STEP", kind="drop", nth=0)):
            j = _error_name(lambda: jfaults.FaultPlan([jfaults.Fault(**bad)]))
            assert j == "ValueError"
            assert _error_name(
                lambda: tfaults.FaultPlan([tfaults.Fault(**bad)])) == j
