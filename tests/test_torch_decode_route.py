"""The decode wrapper's two routes on the CPU: which kernel a launch takes,
each route's split and run arithmetic, that the wrapper reads no length on
the host, and the tensor-core route's arithmetic emulated in float32.

``route`` sends bfloat16 at 4 or more q heads per kv head to the
tensor-core kernel (``decode_mma``) and everything else to the CUDA-core
one (``decode_split``); the C entry decides alike, and the card tests
(``tests/test_torch_cuda.py``) check under the profiler which kernel ran.
The emulation repeats ``decode_mma``'s order of operations on bf16-valued
inputs (16-row steps of each row group, P split into bf16 hi + lo, the
groups' and the runs' merges) and is held against the reference's Pallas
kernel in interpret mode (the whole cache) and the port's plain version
(a block of positions: float32 ``o`` at 3e-5), beside P rounded to bf16
once, which misses 3e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jdecode
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ref as tref

F32 = dict(atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 12, 16, 32])
def test_route_is_the_tensor_cores_exactly_for_bf16_at_four(dtype, hd,
                                                            group):
    """The tensor-core route for bf16 at 4 or more q heads a kv head, at
    every head_dim; its chunks of 16 q heads, the CUDA-core route's of 8."""
    kind = tda.route(dtype, hd, group)
    assert kind == ("mma" if dtype == torch.bfloat16 and group >= 4
                    else "split")
    assert tda.chunks(group * 2, 2, kind) == -(-group // tda.MAX_GROUP[kind])
    assert tda.MAX_GROUP == {"split": 8, "mma": 16}


@pytest.mark.parametrize("kind,b,hq,hkv,s_len,hd,itemsize", [
    ("split", 8, 32, 16, 8192, 128, 2), ("split", 8, 32, 16, 8192, 128, 4),
    ("split", 1, 1, 1, 100000, 64, 2), ("split", 2, 8, 4, 512, 64, 4),
    ("mma", 1, 64, 8, 262144, 128, 2), ("mma", 8, 8, 1, 8192, 256, 2),
    ("mma", 8, 16, 1, 8192, 128, 2), ("mma", 8, 32, 8, 8192, 128, 2),
    ("mma", 6, 128, 4, 3000, 64, 2), ("mma", 1, 4, 1, 40, 256, 2),
    ("mma", 64, 64, 8, 100, 128, 2),
])
def test_split_and_run_arithmetic(kind, b, hq, hkv, s_len, hd, itemsize):
    """Each route's contract: between 1 and 64 splits and no more than the
    cache has tiles; a whole cache in runs of whole tiles, at least the
    fewest a run takes, that cover it in no more runs than splits.  On the
    tensor cores the splits are a cluster: a power of two up to 8, the
    fewest that give the grid a block an SM unless the cap stops them.
    Every short slot too (its runs from its own admitted rows)."""
    tile = tda.tile_rows(hd, itemsize, kind)
    assert tile == (tda.TILE_BYTES // (hd * itemsize) if kind == "split"
                    else tda.MMA_TILE_ROWS[hd])
    blocks = hkv * tda.chunks(hq, hkv, kind)
    n = tda.num_splits(b, blocks, s_len, hd, itemsize, kind)
    assert 1 <= n <= min(tda.MAX_SPLITS, -(-s_len // tile))
    if kind == "mma":
        cap = min(tda.MMA_MAX_SPLITS, -(-s_len // tile))
        assert n & (n - 1) == 0 and n <= cap
        if b * blocks * n < tda.MMA_WAVE_BLOCKS:
            assert 2 * n > cap
        if n > 1:
            assert b * blocks * (n // 2) < tda.MMA_WAVE_BLOCKS
    for rows in sorted({1, tile - 1, tile, 3 * tile + 1, s_len // 3,
                        s_len - 1, s_len} - {0}):
        run = tda.split_length(rows, n, tile)
        assert run % tile == 0 and run >= tda.MIN_RUN_TILES * tile
        assert -(-rows // run) <= n and run * n >= rows


def test_the_wrapper_reads_no_length_on_the_host(monkeypatch):
    """Both entries launch from the shapes alone: with every tensor on the
    meta device (any read of a value raises) and the launch recorded, each
    passes the one C entry its route's splits, a null lse for the whole
    cache, and counts one launch."""
    calls = []
    monkeypatch.setattr(tda, "check_cuda", lambda names, *ts, **kw: 0)
    monkeypatch.setattr(
        tda, "_scratch", lambda dev, n_ws, n_ctr: (
            torch.empty(n_ws, device="meta"),
            torch.empty(n_ctr, dtype=torch.int32, device="meta")))
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    q = torch.empty((3, 64, 128), dtype=torch.bfloat16, device="meta")
    cache = torch.empty((3, 8, 4096, 128), dtype=torch.bfloat16,
                        device="meta")
    valid = torch.empty(3, dtype=torch.int32, device="meta")
    counts = dict(tda.LAUNCHES)
    tda.decode_attention(q, cache, cache, valid, softcap=50.0, window=7)
    tda.decode_attention_partial(q, cache, cache, valid, 4096)
    assert tda.LAUNCHES == {k: v + 1 for k, v in counts.items()}
    splits = tda.num_splits(3, 8, 4096, 128, 2, "mma")
    (n0, a0), (n1, a1) = calls
    assert n0 == n1 == "attn_decode"
    assert a0[5] is None and a0[13] == 0 and a0[-1] == splits
    assert a1[5] == 0 and a1[13] == 4096 and a1[-1] == splits
    assert a0[8:13] == (3, 64, 8, 8, 4096) and a0[14:16] == (128, 1)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mma_emulation(q, ck, cv, valid, pos0, *, window, softcap, splits,
                   partial, split_p=True):
    """``decode_mma``'s arithmetic on the CPU in float32 over bf16 values:
    a slot's admitted rows cut into runs of ``split_length`` rows (the
    route's tile); each run read tile by tile, each of a tile's row groups
    taking its 16 rows a step with its own online softmax per q head (S
    scaled after the product, soft-capped, masked by position; l from the
    unrounded p); O += P_hi . V + P_lo . V (or P rounded once); the groups
    merged, then the runs in run order.  Returns o (and lse when
    ``partial``; the whole cache's rows with nothing admitted read all S
    rows with every score 0)."""
    b, hq, hd = q.shape
    hkv, s_len = ck.shape[1], ck.shape[2]
    g = hq // hkv
    tile = tda.tile_rows(hd, 2, "mma")
    n_groups = tile // 16
    neg = torch.tensor(-2e38)
    out = torch.zeros((b, hq, hd))
    lse = torch.full((b, hq), -math.inf)
    for row in range(b):
        hi = min(int(valid[row]) - pos0, s_len)
        first = max(0, int(valid[row]) - window + 1 - pos0) if window else 0
        uniform = hi <= first
        if uniform and partial:
            continue
        if uniform:
            first, hi = 0, s_len
        run = tda.split_length(hi - first, splits, tile)
        for hk in range(hkv):
            qs = q[row, hk * g:(hk + 1) * g]
            parts = []
            for start in range(first, hi, run):
                end = min(start + run, hi)
                m = torch.full((n_groups, g), -2e38)
                l = torch.zeros((n_groups, g))
                acc = torch.zeros((n_groups, g, hd))
                for p0 in range(start, end, tile):
                    pos = p0 + torch.arange(tile).reshape(n_groups, 16)
                    ok = pos < end
                    kk = ck[row, hk][pos.clamp_max(s_len - 1)]
                    vv = cv[row, hk][pos.clamp_max(s_len - 1)]
                    sc = torch.einsum("grd,hd->ghr", kk, qs) / math.sqrt(hd)
                    if uniform:
                        sc = torch.zeros_like(sc)
                    elif softcap:
                        sc = softcap * torch.tanh(sc / softcap)
                    sc = torch.where(ok[:, None, :], sc, neg)
                    mx = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - mx)
                    p = torch.where(ok[:, None, :],
                                    torch.exp(sc - mx[..., None]), 0.0)
                    l = l * alpha + p.sum(-1)
                    ph = _bf16(p)
                    pv = torch.einsum("ghr,grd->ghd", ph, vv)
                    if split_p:
                        pv = pv + torch.einsum("ghr,grd->ghd", _bf16(p - ph),
                                               vv)
                    acc = acc * alpha[..., None] + pv
                    m = mx
                big = m.amax(0)
                f = torch.exp(m - big)
                parts.append((big, (l * f).sum(0),
                              (acc * f[..., None]).sum(0)))
            big = torch.stack([pm for pm, _, _ in parts]).amax(0)
            den, num = torch.zeros(g), torch.zeros((g, hd))
            for pm, pl, pacc in parts:   # run order
                f = torch.exp(pm - big)
                den = den + pl * f
                num = num + pacc * f[:, None]
            out[row, hk * g:(hk + 1) * g] = num / den.clamp_min(1e-37)[:, None]
            lse[row, hk * g:(hk + 1) * g] = big + torch.log(den)
    return (out, lse) if partial else out


def _bf16_case(seed, b, hq, hkv, s_len, hd):
    rng = np.random.default_rng(seed)
    return tuple(_bf16(torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32))
                 for shape in ((b, hq, hd), (b, hkv, s_len, hd),
                               (b, hkv, s_len, hd)))


@pytest.mark.parametrize("hq,hkv,hd,window,softcap", [
    (8, 1, 64, 0, 0.0), (8, 2, 128, 301, 30.0), (16, 1, 64, 0, 50.0),
    (8, 1, 256, 0, 0.0)])
def test_mma_arithmetic_vs_interpret_kernel(hq, hkv, hd, window, softcap):
    """The whole cache at a run's edges (its length - 1, the length, + 1),
    a slot at 1, one at the whole cache and one with nothing admitted,
    against the reference's kernel in interpret mode, at float32's 3e-5."""
    s_len, splits = 1024, 3   # the interpret kernel takes 512-row blocks
    tile = tda.tile_rows(hd, 2, "mma")
    run = tda.split_length(s_len, splits, tile)
    valid = [1, run - 1, run, run + 1, s_len, 0]
    q, ck, cv = _bf16_case(hd + hq, len(valid), hq, hkv, s_len, hd)
    got = _mma_emulation(q, ck, cv, valid, 0, window=window,
                         softcap=softcap, splits=splits, partial=False)
    for row, v in enumerate(valid):
        want = jdecode(jnp.asarray(q[row:row + 1].numpy()),
                       jnp.asarray(ck[row:row + 1].numpy()),
                       jnp.asarray(cv[row:row + 1].numpy()), jnp.int32(v),
                       softcap=softcap, window=window)
        np.testing.assert_allclose(got[row:row + 1].numpy(), np.asarray(want),
                                   **F32)


@pytest.mark.parametrize("hq,hd", [(8, 128), (16, 256)])
def test_mma_partial_needs_the_split_p(hq, hd):
    """A block of positions (pos0 S/2 of a cache of S): o within 3e-5 of
    the plain version and lse alike with P split into hi + lo; P rounded
    to bf16 once moves o by more than 3e-5."""
    s_len, pos0 = 600, 300
    valid = [1, 301, 450, 900, 10]
    q, ck, cv = _bf16_case(hq + hd, len(valid), hq, 1, s_len, hd)
    want_o, want_lse = tref.decode_attention_partial_ref(
        q, ck, cv, torch.tensor(valid, dtype=torch.int32), pos0)
    for split_p in (True, False):
        o, lse = _mma_emulation(q, ck, cv, valid, pos0, window=0, softcap=0.0,
                                splits=2, partial=True, split_p=split_p)
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        err = float((o - want_o).abs().max())
        if split_p:
            torch.testing.assert_close(o, want_o, **F32)
            torch.testing.assert_close(lse, want_lse, **F32)
        else:
            assert err > 3e-5, err
