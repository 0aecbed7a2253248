"""The CUDA reduce-by-key's arithmetic, emulated on the CPU, against the
JAX package's segment sums.

``csrc/segment_reduce.cu``'s ``segment_sum_sorted_kernel`` cannot run
here, so ``_reduce_by_key_emulation`` repeats its decomposition in numpy
at a small tile: every tile publishes a record (its trailing run's partial
sum, and whether it holds a run head); the tile that holds a run's last row
writes that segment, taking the run's earlier part from the rows just
before the tile when the run's head lies among them, and otherwise from
the records of the tiles back to the nearest one with a head, read a few
per step; it also
writes zeros for the empty ids up to the next row's id, and the tile with
row 0 for the ids below the first.  The emulation checks that every output
row is written exactly once, as the kernel needs of an output it never
zeroes.  It is held bit-exact in int32 (values near 2^31, so the sums wrap)
against the reference's Pallas ``segment_sum`` in interpret mode, its
``segment_sum_sorted`` and the port's plain version; float32 within 3e-5,
the tolerance the reference holds its own kernels to, because the sums run
in another order.  The reference's ``segment_sum_sorted`` is defined for
ids in ``[0, S]`` and folds negative ids into segment 0, so the cases with
negative ids are held against its Pallas kernel, which drops them, as the
CUDA kernel and the port's plain version do.  The kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment_reduce as jsr
from repro_torch.kernels import ops as tops

F32 = dict(atol=3e-5, rtol=3e-5)
TILE = 8      # rows per tile (the kernel's: 512)
SHORT = 3     # rows before a tile summed directly (the kernel's: 32)
WINDOW = 3    # records read per look-back step (the kernel's: 128)


def _add(a, b, dtype):
    """a + b in the kernel's accumulator: int32 wrapping, or float32."""
    if dtype == np.int32:
        return ((a.astype(np.int64) + b.astype(np.int64) + 2 ** 31)
                % 2 ** 32 - 2 ** 31).astype(np.int32)
    return (a + b).astype(np.float32)


def _reduce_by_key_emulation(ids, values, num_segments, paths=None):
    """The CUDA kernel's decomposition of the sorted segment sum; adds to
    ``paths`` how each look-back found a run's earlier part."""
    paths = set() if paths is None else paths
    n, d = values.shape
    dtype = values.dtype.type
    out = np.zeros((num_segments, d), dtype)
    writes = np.zeros(num_segments, np.int64)
    if n == 0:
        return out
    n_tiles = -(-n // TILE)
    head = np.ones(n, bool)
    head[1:] = ids[1:] != ids[:-1]
    end = np.ones(n, bool)
    end[:-1] = ids[1:] != ids[:-1]
    in_range = (ids >= 0) & (ids < num_segments)

    def write(rows, value):
        out[rows] = value
        writes[rows] += 1

    # each tile's record: its trailing run's partial, and whether it holds
    # a head (the last tile publishes none)
    records = []
    for t in range(n_tiles - 1):
        rows = range(t * TILE, (t + 1) * TILE)
        start = max([r for r in rows if head[r]], default=t * TILE)
        part = np.zeros(d, dtype)
        for r in range(start, (t + 1) * TILE):
            part = _add(part, values[r], dtype)
        records.append((bool(head[t * TILE:(t + 1) * TILE].any()), part))

    for t in range(n_tiles):
        lo_row, hi_row = t * TILE, min((t + 1) * TILE, n)
        carry = None
        if lo_row > 0 and not head[lo_row] and in_range[lo_row]:
            # a short run: its head among the SHORT rows before the tile,
            # summed directly
            back = [lo_row - 1 - i for i in range(SHORT)]
            same = [r >= 0 and ids[r] == ids[lo_row] for r in back]
            stop = same.index(False) if False in same else SHORT
            carry = np.zeros(d, dtype)
            for r in back[:stop]:
                carry = _add(carry, values[r], dtype)
            j = t - 1 if stop == SHORT else -1
            # a long run: windows of WINDOW records, nearest first, up to
            # and including the nearest record with a head
            carry = np.zeros(d, dtype) if j >= 0 else carry
            while j >= 0:
                window = range(j, max(j - WINDOW, -1), -1)
                nearest = next((i for i in window if records[i][0]), None)
                for i in window:
                    if nearest is not None and i < nearest:
                        break
                    carry = _add(carry, records[i][1], dtype)
                if nearest is not None:
                    break
                j -= WINDOW
            paths.add("records" if stop == SHORT else "rows")
        run = np.zeros(d, dtype)
        for r in range(lo_row, hi_row):
            run = values[r].copy() if head[r] else _add(run, values[r], dtype)
            if not end[r]:
                continue
            # the run's head lies in an earlier tile: add the look-back's sum
            began_earlier = not head[lo_row:r + 1].any()
            total = _add(carry, run, dtype) if began_earlier and \
                carry is not None else run
            if in_range[r]:
                write(ids[r], total)
            gap_hi = num_segments if r == n - 1 else min(ids[r + 1],
                                                         num_segments)
            write(slice(max(ids[r] + 1, 0), max(gap_hi, 0)), 0)
        if t == 0:
            write(slice(0, max(min(ids[0], num_segments), 0)), 0)
    assert (writes == 1).all(), "an output row written twice or never"
    return out


def _ids(case, rng):
    """(sorted ids, S) of each case; the runs cross tiles of 8 rows."""
    if case == "run crosses one tile edge":
        return np.repeat(np.arange(6), [6, 4, 6, 8, 1, 4]), 6
    if case == "run covers every tile":
        return np.full(40, 2), 5
    if case == "gaps at head, middle and tail":
        return np.repeat([3, 4, 9, 10, 17], [5, 8, 1, 12, 6]), 25
    if case == "negative ids at the head":
        return np.repeat([-7, -1, 0, 2, 5], [9, 4, 3, 10, 5]), 7
    if case == "ids >= S at the tail":
        return np.repeat([0, 1, 3, 6, 8, 40], [4, 9, 7, 3, 11, 6]), 6
    if case == "empty":
        return np.zeros(0, np.int64), 4
    if case == "S below the largest id":
        return np.sort(rng.integers(0, 30, 70)), 12
    if case == "every id out of range":
        return np.repeat([-3, -2, 9, 11], [6, 7, 8, 5]), 9
    if case == "long run, many look-back steps":
        return np.repeat([1, 4, 5], [3, 61, 11]), 8
    if case == "random":
        return np.sort(rng.integers(-2, 50, 300)), 45
    raise AssertionError(case)


CASES = ("run crosses one tile edge", "run covers every tile",
         "gaps at head, middle and tail", "negative ids at the head",
         "ids >= S at the tail", "empty", "S below the largest id",
         "every id out of range", "long run, many look-back steps",
         "random")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", CASES)
def test_reduce_by_key_emulation(case, dtype):
    rng = np.random.default_rng(len(case))
    ids, S = _ids(case, rng)
    ids = ids.astype(np.int32)
    if dtype == np.int32:
        values = rng.integers(2 ** 31 - 300, 2 ** 31, (len(ids), 2))
    else:
        values = rng.standard_normal((len(ids), 2))
    values = values.astype(dtype)
    paths = set()
    got = _reduce_by_key_emulation(ids, values, S, paths)
    if case == "run crosses one tile edge":
        assert paths == {"rows"}
    if case in ("run covers every tile", "long run, many look-back steps"):
        assert "records" in paths
    if case == "every id out of range":
        assert not got.any()
    assert got.dtype == dtype and got.shape == (S, 2)
    pallas = np.asarray(jsr.segment_sum(jnp.asarray(values), jnp.asarray(ids),
                                        S, block_rows=16, interpret=True))
    plain = tops.segment_sum_sorted(torch.as_tensor(values),
                                    torch.as_tensor(ids), S).numpy()
    wants = [pallas, plain]
    if not (ids < 0).any():
        wants.append(np.asarray(jsr.segment_sum_sorted(
            jnp.asarray(values), jnp.asarray(ids), S)))
    for want in wants:
        if dtype == np.int32:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **F32)
