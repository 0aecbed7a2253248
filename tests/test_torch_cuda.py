"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, not at import).  This file imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers must be bit-exact; float32 sums are held to 3e-5 because the
atomics add in another order than the plain version.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import hash_table as tht
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.keyed import KeyedWindowAdapter, WindowSpec, synthetic_keyed_items
from repro_torch.runtime import StreamExecutor

F32 = dict(atol=3e-5, rtol=3e-5)
I64 = np.iinfo(np.int64)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, a):
    return torch.as_tensor(np.asarray(a), device=dev)


def _lookup_case(rng, n, capacity):
    pool = np.array([I64.min, I64.max, -1, 0, 1, -(2 ** 40), 2 ** 33 + 5],
                    np.int64)
    return (rng.choice(np.append(pool, 12345), n), rng.integers(-2, 3, n) * 7,
            rng.choice(pool, capacity), rng.integers(-2, 2, capacity) * 7,
            rng.random(capacity) < 0.6)


def test_segment_sum(dev):
    rng = np.random.default_rng(0)
    ids = _on(dev, rng.integers(0, 60, 5000).astype(np.int32))
    vals = _on(dev, rng.integers(2 ** 31 - 99, 2 ** 31, (5000, 2))
               .astype(np.int32))
    assert torch.equal(tsr.segment_sum(vals, ids, 50),
                       tref.segment_sum_ref(vals, ids, 50))
    f = _on(dev, rng.standard_normal((5000, 2)).astype(np.float32))
    torch.testing.assert_close(tsr.segment_sum(f, ids, 50),
                               tref.segment_sum_ref(f, ids, 50), **F32)


def test_scatter_add(dev):
    rng = np.random.default_rng(1)
    table = _on(dev, rng.integers(2 ** 62, I64.max, (40, 2)))
    ids = _on(dev, rng.integers(0, 45, 3000).astype(np.int32))
    rows = _on(dev, rng.integers(2 ** 60, 2 ** 62, (3000, 2)))
    assert torch.equal(tsr.scatter_add_(table.clone(), ids, rows),
                       tref.scatter_add_ref(table, ids, rows))
    small = table.to(torch.int32)
    rows32 = rows.to(torch.int32)
    assert torch.equal(tsr.scatter_add_(small.clone(), ids, rows32),
                       tref.scatter_add_ref(small, ids, rows32))


@pytest.mark.parametrize("seed", [0, 1])
def test_lookups(dev, seed):
    rng = np.random.default_rng(seed)
    ck, cs, tk, ts, occ = (_on(dev, a) for a in _lookup_case(rng, 3000, 5000))
    got = tht.table_lookup(ck, cs, tk, ts, occ)
    assert torch.equal(got, tref.table_lookup_ref(ck, cs, tk, ts, occ))
    assert bool((got == 5000).any()) and bool((got < 5000).any())
    row_own = (torch.arange(5000, device=dev) // 1250).to(torch.int32)
    c_own = _on(dev, rng.integers(0, 5, 3000).astype(np.int32))
    assert torch.equal(
        tht.batched_table_lookup(c_own, ck, cs, row_own, tk, ts, occ),
        tref.batched_table_lookup_ref(c_own, ck, cs, row_own, tk, ts, occ))


def test_hashes_on_the_card_equal_numpy(dev):
    """The int64-wrapping product and the unsigned remainder give the
    numpy uint64 rows on the card too, negative and extreme keys included."""
    from repro_torch.keyed import cell_hash, hash_to_slot

    rng = np.random.default_rng(2)
    keys = np.append(rng.integers(I64.min, I64.max, 4000, dtype=np.int64),
                     [I64.min, I64.max, -1, 0, -5])
    starts = rng.integers(-(2 ** 40), 2 ** 40, len(keys))
    for m in (1, 20, 1000, 262144, 2 ** 40 + 3):
        np.testing.assert_array_equal(
            hash_to_slot(_on(dev, keys), m).cpu().numpy(),
            hash_to_slot(keys, m).astype(np.int64))
        np.testing.assert_array_equal(
            cell_hash(_on(dev, keys), _on(dev, starts), m).cpu().numpy(),
            cell_hash(keys, starts, m))


def test_wrappers_refuse_bad_inputs(dev):
    ids = torch.zeros(4, dtype=torch.int64, device=dev)  # must be int32
    with pytest.raises(ValueError, match="int32"):
        tsr.segment_sum(torch.ones((4, 2), dtype=torch.int32, device=dev),
                        ids, 3)
    strided = torch.ones((4, 4), dtype=torch.int32, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tsr.segment_sum(strided, ids.to(torch.int32), 3)


@pytest.mark.parametrize("fused", [True, False])
def test_plane_on_the_card_equals_plain_and_cpu(dev, fused):
    """The keyed plane with forced spill, TTL, early firing and a resize:
    the kernel run equals the plain run on the card and the CPU run, and
    launched its kernels."""
    spec = WindowSpec("sliding", size=48, slide=16, lateness=3,
                      late_policy="side", early_every=2)
    items = synthetic_keyed_items(16 * 12, num_keys=40, disorder=10, seed=0)
    chunks = [items[i: i + 16] for i in range(0, len(items), 16)]

    def run(device, mode="auto"):
        ops.use_kernels(mode)
        try:
            ad = KeyedWindowAdapter(spec, num_slots=20, backend="device_table",
                                    capacity=16, max_probes=4, ttl=4,
                                    fused=fused, device=device)
            ex = StreamExecutor(ad, degree=2, chunk_size=16)
            return ex.run(chunks, schedule={6: 7}), ex.state
        finally:
            ops.use_kernels("auto")

    ops.reset_launch_counts()
    kern = run(dev)
    counts = ops.launch_counts()
    lookup = "batched_table_lookup" if fused else "table_lookup"
    assert counts[lookup] > 0 and counts["scatter_add"] > 0
    assert counts["segment_sum"] > 0
    for other in (run(dev, "ref"), run("cpu")):
        for a, b in zip(kern[0], other[0]):
            for ch in a:
                for k in a[ch]:
                    np.testing.assert_array_equal(a[ch][k], b[ch][k])
        for k in kern[1]:
            np.testing.assert_array_equal(kern[1][k], other[1][k])
