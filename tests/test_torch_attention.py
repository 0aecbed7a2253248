"""The serving slice's attention and model layers against the JAX package.

The same numpy inputs go through the reference (its Pallas kernels in
interpret mode, or its jnp oracles where interpret mode cannot take the
shape) and through the port's plain versions on the CPU.  Everything is
float32: attention is held to 3e-5 (the tolerance the reference holds its
own kernels to), the layers to 1e-6, the attention block to 1e-5 and the
whole reduced model to 1e-4 (sums in another order through several
layers).  The CUDA kernels are held against the plain versions on the card
by ``tests/test_torch_cuda.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as JT
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from repro_torch.models.config import MAMBA, NONE, LayerSpec, ModelConfig

F32 = dict(atol=3e-5, rtol=3e-5)


def t(a):
    return torch.as_tensor(np.array(a))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, b, hq, hkv, sq, skv, hd):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, hq, sq, hd), _normal(rng, b, hkv, skv, hd),
            _normal(rng, b, hkv, skv, hd))


def _jax_tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# flash attention: the plain version against the reference's kernel
# ---------------------------------------------------------------------------

class TestFlashAttention:
    @pytest.mark.parametrize(
        "B,Hq,Hkv,Sq,Skv,hd",
        [(1, 4, 4, 256, 256, 64), (2, 4, 2, 256, 512, 64),
         (1, 4, 1, 128, 384, 128), (1, 8, 8, 512, 512, 64),
         (1, 8, 1, 128, 256, 256),    # PaliGemma's head_dim and 8:1 group
         # hd 256 at the bf16 kernel's tile edges: one warpgroup's 64 rows
         # over one kv tile (Hq / Hkv 1), three q tiles over six kv tiles
         # (more than its two-stage ring, Hq / Hkv 2)
         (1, 2, 2, 64, 64, 256), (1, 4, 2, 384, 384, 256)],
    )
    def test_causal_vs_interpret_kernel(self, B, Hq, Hkv, Sq, Skv, hd):
        q, k, v = _qkv(0, B, Hq, Hkv, Sq, Skv, hd)
        got = tops.flash_attention(t(q), t(k), t(v), causal=True).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jflash(q, k, v, causal=True)), **F32)
        np.testing.assert_allclose(
            got, np.asarray(jref.flash_attention_ref(q, k, v, causal=True)),
            **F32)

    @pytest.mark.parametrize("window,softcap,hkv", [
        (64, 0.0, 2), (128, 0.0, 2), (0, 30.0, 2), (96, 50.0, 1),
    ])
    def test_window_softcap_gqa_vs_interpret_kernel(self, window, softcap,
                                                    hkv):
        q, k, v = _qkv(1, 1, 2, hkv, 256, 256, 64)
        kw = dict(causal=True, window=window, softcap=softcap)
        got = tops.flash_attention(t(q), t(k), t(v), **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(jflash(q, k, v, **kw)),
                                   **F32)
        np.testing.assert_allclose(
            got, np.asarray(jref.flash_attention_ref(q, k, v, **kw)), **F32)

    @pytest.mark.parametrize("window,softcap", [
        (64, 0.0), (0, 30.0),
        # a window shorter than a 64-row kv tile with softcap 50, and one
        # whose lower edge lies one row into a tile
        (32, 50.0), (65, 0.0),
    ])
    def test_head_dim_256_vs_interpret_kernel(self, window, softcap):
        """head_dim 256 (PaliGemma's) with a window or a softcap, 8 q heads
        over one kv head."""
        q, k, v = _qkv(5, 1, 8, 1, 128, 128, 256)
        kw = dict(causal=True, window=window, softcap=softcap)
        got = tops.flash_attention(t(q), t(k), t(v), **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(jflash(q, k, v, **kw)),
                                   **F32)
        np.testing.assert_allclose(
            got, np.asarray(jref.flash_attention_ref(q, k, v, **kw)), **F32)

    @pytest.mark.parametrize("Sq,Skv,window,causal", [
        (37, 37, 0, True), (100, 100, 24, True), (5, 70, 0, False),
        (65, 65, 64, True),
    ])
    def test_ragged_lengths_vs_reference_oracle(self, Sq, Skv, window,
                                                causal):
        """Prompt lengths are arbitrary; the reference's kernel asserts
        tile divisibility, so these are held against its oracle only."""
        q, k, v = _qkv(2, 2, 4, 2, Sq, Skv, 64)
        kw = dict(causal=causal, window=window, softcap=50.0)
        np.testing.assert_allclose(
            tops.flash_attention(t(q), t(k), t(v), **kw).numpy(),
            np.asarray(jref.flash_attention_ref(q, k, v, **kw)), **F32)


def _bf16_kernel_emulation(q, k, v, *, causal, window, softcap, split,
                           bk=64):
    """The bf16 CUDA flash kernel's arithmetic on the CPU: bf16 inputs,
    float32 scores scaled by 1/sqrt(hd) after the product, the tanh softcap,
    online softmax over kv tiles of ``bk`` with float32 m and l (the sum of
    the unrounded p), P passed to the P.V product as bf16(p) plus, with
    ``split``, bf16(p - bf16(p)), the products summed in float32 as the
    tensor cores sum them, and one bf16 rounding of acc / l at the end."""
    hq, hkv, sq, skv, hd = (q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                            q.shape[3])
    qf = q.float()
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    neg = torch.tensor(-2e38)
    m = torch.full((*q.shape[:3], 1), -2e38)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bk):
        k_pos = torch.arange(k0, min(k0 + bk, skv))[None, :]
        s = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) \
            * torch.tensor(1 / math.sqrt(hd))
        if softcap:
            s = softcap * torch.tanh(s * torch.tensor(1 / softcap))
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok &= k_pos <= q_pos
        if window:
            ok &= k_pos > q_pos - window
        s = torch.where(ok, s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        parts = [p_hi, (p - p_hi).bfloat16().float()] if split else [p_hi]
        acc = acc * alpha + sum(part @ vf[:, :, k0:k0 + bk] for part in parts)
        m = m_new
    return (acc / l.clamp_min(1e-37)).bfloat16()


def _rounding_steps(got, want):
    """Largest difference in units of one bf16 rounding step of each value,
    ``3e-5 + 2^-7 |x|``, the rule chip_smoke.py holds the kernel to."""
    want = want.float()
    return float(((got.float() - want).abs()
                  / (3e-5 + 2.0 ** -7 * want.abs())).max())


class TestBf16KernelPrecision:
    """Why the bf16 kernel splits P: at Gemma2's head ratio and softcap 50,
    and at PaliGemma's head_dim 256 over one kv head, P kept to ~16 bits
    stays within one bf16 rounding step of the plain version, and P rounded
    once to bf16 (2^-9) does not, on rows with few admitted keys whose
    outputs lie near zero."""

    @staticmethod
    def _case(window):
        rng = np.random.default_rng(14)
        q, k, v = (t(_normal(rng, *shape)).bfloat16() for shape in
                   ((1, 4, 320, 128), (1, 2, 320, 128), (1, 2, 320, 128)))
        kw = dict(causal=True, window=window, softcap=50.0)
        return q, k, v, kw, tops.flash_attention(q, k, v, **kw)

    @pytest.mark.parametrize("window", [0, 100])
    def test_split_p_within_one_rounding_step(self, window):
        q, k, v, kw, want = self._case(window)
        got = _bf16_kernel_emulation(q, k, v, split=True, **kw)
        assert _rounding_steps(got, want) <= 1.0

    @pytest.mark.parametrize("window", [0, 100])
    def test_p_rounded_once_exceeds_the_step(self, window):
        q, k, v, kw, want = self._case(window)
        got = _bf16_kernel_emulation(q, k, v, split=False, **kw)
        assert _rounding_steps(got, want) > 1.0

    @staticmethod
    def _case_hd256(sq, window, softcap):
        """PaliGemma's head_dim and 8 q heads over one kv head."""
        rng = np.random.default_rng(31)
        q, k, v = (t(_normal(rng, *shape)).bfloat16() for shape in
                   ((1, 8, sq, 256), (1, 1, sq, 256), (1, 1, sq, 256)))
        kw = dict(causal=True, window=window, softcap=softcap)
        return q, k, v, kw, tops.flash_attention(q, k, v, **kw)

    # Sq off the 128-row q tile and 64-row kv tile, a window shorter than a
    # kv tile with softcap 50; five q tiles, no window, softcap 0
    HD256_CASES = [(193, 32, 50.0), (320, 0, 0.0)]

    @pytest.mark.parametrize("sq,window,softcap", HD256_CASES)
    def test_split_p_within_one_rounding_step_hd256(self, sq, window,
                                                    softcap):
        q, k, v, kw, want = self._case_hd256(sq, window, softcap)
        got = _bf16_kernel_emulation(q, k, v, split=True, **kw)
        assert _rounding_steps(got, want) <= 1.0

    @pytest.mark.parametrize("sq,window,softcap", HD256_CASES)
    def test_p_rounded_once_exceeds_the_step_hd256(self, sq, window,
                                                   softcap):
        q, k, v, kw, want = self._case_hd256(sq, window, softcap)
        got = _bf16_kernel_emulation(q, k, v, split=False, **kw)
        assert _rounding_steps(got, want) > 1.0


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _decode_case(seed, b, hq, hkv, s, hd):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, hq, hd), _normal(rng, b, hkv, s, hd),
            _normal(rng, b, hkv, s, hd))


class TestDecodeAttention:
    @pytest.mark.parametrize("B,Hq,Hkv,S,hd,valid", [
        (2, 4, 4, 512, 64, 300), (1, 8, 2, 1024, 128, 1024),
        (2, 4, 1, 512, 64, 17),
        (1, 8, 1, 256, 256, 40),      # PaliGemma's head_dim and group
        (1, 16, 1, 256, 64, 100),     # 16 q heads per kv head
        (2, 4, 2, 128, 64, 0),        # no admitted row: the mean of V
    ])
    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
    def test_scalar_valid_len_vs_interpret_kernel(self, B, Hq, Hkv, S, hd,
                                                  valid, window, softcap):
        q, ck, cv = _decode_case(3, B, Hq, Hkv, S, hd)
        kw = dict(softcap=softcap, window=window)
        got = tops.decode_attention(t(q), t(ck), t(cv), valid, **kw).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jdecode(q, ck, cv, jnp.int32(valid), **kw)),
            **F32)

    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 30.0)])
    def test_per_slot_valid_len_vs_reference_row_by_row(self, window,
                                                        softcap):
        """One length per slot (the engine's ragged batch), a slot at 1
        included; each row equals the reference's scalar oracle on that
        row."""
        q, ck, cv = _decode_case(4, 4, 4, 2, 64, 16)
        valid = np.array([1, 9, 40, 64], np.int32)
        kw = dict(softcap=softcap, window=window)
        got = tops.decode_attention(t(q), t(ck), t(cv), t(valid), **kw)
        for r in range(4):
            want = jref.decode_attention_ref(
                q[r:r + 1], ck[r:r + 1], cv[r:r + 1], int(valid[r]), **kw)
            np.testing.assert_allclose(got[r:r + 1].numpy(),
                                       np.asarray(want), **F32)


def _split_kv_emulation(q, ck, cv, valid, *, window, softcap, splits, tile):
    """The split-KV CUDA decode kernel's arithmetic on the CPU in float32:
    q pre-scaled by 1/sqrt(hd); a slot's admitted positions cut into runs
    of ``split_length`` rows from its first admitted one, each run read in
    tiles of ``tile`` rows by ``tile / 4`` lane groups that take 4 rows a
    step and keep their own online softmax (m, l, acc) per q head; the
    groups merged per run, then the runs merged in run order; a lone run
    written directly; a slot with no admitted row reads all S rows with
    every score 0 (the mean of V, as under the reference's finite mask)."""
    from repro_torch.kernels.decode_attention import split_length

    b, hq, hd = q.shape
    hkv, s_len = ck.shape[1], ck.shape[2]
    g, groups, neg = hq // hkv, tile // 4, torch.tensor(-2e38)
    out = torch.zeros_like(q)
    r_idx = torch.arange(4)[:, None] * groups + torch.arange(groups)[None]
    for row in range(b):
        hi = min(int(valid[row]), s_len)
        first = max(0, int(valid[row]) - window + 1) if window else 0
        uniform = hi <= first
        if uniform:
            first, hi = 0, s_len
        run = split_length(hi - first, splits, tile)
        for hk in range(hkv):
            qs = q[row, hk * g:(hk + 1) * g] * torch.tensor(1 / math.sqrt(hd))
            parts = []
            for start in range(first, hi, run):
                end = min(start + run, hi)
                m = torch.full((groups, g), -2e38)
                l = torch.zeros((groups, g))
                acc = torch.zeros((groups, g, hd))
                for p0 in range(start, end, tile):
                    ok = r_idx < min(tile, end - p0)            # [4, groups]
                    pos = torch.where(ok, p0 + r_idx, 0)
                    kk = ck[row, hk][pos] * ok[..., None]       # [4, grp, hd]
                    vv = cv[row, hk][pos] * ok[..., None]
                    sc = torch.einsum("ugd,hd->ghu", kk, qs)
                    if uniform:
                        sc = torch.zeros_like(sc)
                    elif softcap:
                        sc = softcap * torch.tanh(sc / softcap)
                    sc = torch.where(ok.T[:, None, :], sc, neg)
                    mx = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - mx)
                    p = torch.where(ok.T[:, None, :],
                                    torch.exp(sc - mx[..., None]), 0.0)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] \
                        + torch.einsum("ghu,ugd->ghd", p, vv)
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
    return out


class TestSplitKvDecode:
    """The split-KV decode kernel's split-and-merge arithmetic, emulated in
    float32, against the reference's Pallas kernel in interpret mode: at
    the edges of a run (its length - 1, the length, + 1), a slot at 1 and
    one at the whole cache, and a window whose first admitted row (where the
    runs start) is off a tile boundary; with the split count the wrapper
    picks for this shape (runs of the fewest tiles, 128 rows) and with 4
    splits (256 rows at the whole cache)."""

    S, HQ, HKV, HD = 1024, 4, 2, 64
    _jax = {}

    @classmethod
    def _reference(cls, q, ck, cv, row, valid, window, softcap):
        key = (row, valid, window, softcap)
        if key not in cls._jax:
            cls._jax[key] = np.asarray(jdecode(
                q[row:row + 1], ck[row:row + 1], cv[row:row + 1],
                jnp.int32(valid), softcap=softcap, window=window))[0]
        return cls._jax[key]

    @pytest.mark.parametrize("window,softcap", [
        (0, 0.0), (0, 50.0), (301, 30.0)])
    @pytest.mark.parametrize("wrapper_splits", [True, False])
    def test_split_and_merge_vs_interpret_kernel(self, wrapper_splits,
                                                 window, softcap):
        from repro_torch.kernels import decode_attention as tda

        tile = tda.tile_rows(self.HD, 4)
        splits = tda.num_splits(5, self.HKV, self.S, self.HD, 4) \
            if wrapper_splits else 4
        run = tda.split_length(self.S, splits, tile)
        assert run == (tda.MIN_RUN_TILES * tile if wrapper_splits
                       else tda.SPLIT_ROWS)
        valid = [1, run - 1, run, run + 1, self.S]
        if window:
            assert (valid[-1] - window + 1) % tile
        q, ck, cv = _decode_case(15, 5, self.HQ, self.HKV, self.S, self.HD)
        got = _split_kv_emulation(t(q), t(ck), t(cv), valid, window=window,
                                  softcap=softcap, splits=splits, tile=tile)
        for row, v in enumerate(valid):
            np.testing.assert_allclose(
                got[row].numpy(),
                self._reference(q, ck, cv, row, v, window, softcap), **F32)

    def test_no_admitted_row_is_the_mean_of_v(self):
        """valid_len 0, and a window that ends past the cache (nothing
        admitted in [0, S)): every row weighs alike, as the reference's
        kernel weighs them under its finite mask; beside a normal slot."""
        from repro_torch.kernels import decode_attention as tda

        tile = tda.tile_rows(self.HD, 4)
        splits = tda.num_splits(3, self.HKV, self.S, self.HD, 4)
        q, ck, cv = _decode_case(16, 3, self.HQ, self.HKV, self.S, self.HD)
        window = 50
        valid = [0, 300, self.S + window]
        got = _split_kv_emulation(t(q), t(ck), t(cv), valid, window=window,
                                  softcap=30.0, splits=splits, tile=tile)
        for row, v in enumerate(valid):
            np.testing.assert_allclose(
                got[row].numpy(),
                self._reference(q, ck, cv, row, v, window, 30.0), **F32)
        np.testing.assert_allclose(
            got[0].numpy(), np.repeat(cv[0].mean(axis=1), 2, axis=0), **F32)
        np.testing.assert_allclose(
            tops.decode_attention(t(q), t(ck), t(cv), t(np.int32(valid)),
                                  window=window, softcap=30.0).numpy(),
            got.numpy(), **F32)

    @pytest.mark.parametrize("b,hkv,s_len,hd,itemsize", [
        (8, 16, 8192, 128, 2), (8, 16, 8192, 128, 4), (1, 1, 100000, 64, 2),
        (2, 4, 512, 64, 4)])
    def test_split_rule(self, b, hkv, s_len, hd, itemsize):
        """At most 64 splits and no more than the cache has tiles; a whole
        cache in runs of whole tiles that cover it; 256-row runs once the
        grid has several waves of blocks."""
        from repro_torch.kernels import decode_attention as tda

        tile = tda.tile_rows(hd, itemsize)
        n = tda.num_splits(b, hkv, s_len, hd, itemsize)
        assert 1 <= n <= min(tda.MAX_SPLITS, -(-s_len // tile))
        run = tda.split_length(s_len, n, tile)
        assert run % tile == 0 and run >= tda.MIN_RUN_TILES * tile
        assert run * n >= s_len
        if b * hkv * -(-s_len // tda.SPLIT_ROWS) >= tda.WAVE_BLOCKS \
                and s_len <= tda.MAX_SPLITS * tda.SPLIT_ROWS:
            assert run == tda.SPLIT_ROWS

    @pytest.mark.parametrize("view", ["whole", "narrowed_heads", "one_slot",
                                      "transposed", "sliced_rows"])
    def test_slot_heads(self, view):
        """The cache layouts the kernel reads in place (each slot's ``[Hkv,
        S, hd]`` dense, slots ``slot_heads`` heads apart), where the
        kernel's address of slot b, kv head h, ``(b * slot + h) * S * hd``
        past the view's first element, finds the view's rows; other layouts
        give None (the wrapper copies them)."""
        from repro_torch.kernels import decode_attention as tda

        base = torch.arange(3 * 8 * 5 * 4, dtype=torch.float32).reshape(
            3, 8, 5, 4)
        t, want = {"whole": (base, 8),
                   "narrowed_heads": (base.narrow(1, 2, 4), 8),
                   "one_slot": (base[1:2, 3:5], 2),
                   "transposed": (base.transpose(2, 3), None),
                   "sliced_rows": (base[:, :, :3], None)}[view]
        assert tda.slot_heads(t) == want
        if want is not None:
            b, h, s_len, hd = t.shape
            rows = (torch.arange(b)[:, None] * want + torch.arange(h)) \
                * s_len * hd
            idx = t.storage_offset() + rows[..., None] \
                + torch.arange(s_len * hd)
            assert torch.equal(base.flatten()[idx].reshape(t.shape), t)



# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

L6 = dict(atol=1e-6, rtol=1e-6)


class TestLayers:
    def test_rmsnorm(self):
        rng = np.random.default_rng(5)
        x, scale = _normal(rng, 3, 7, 32), _normal(rng, 32) * 0.1
        np.testing.assert_allclose(
            tlayers.rmsnorm(t(x), t(scale), 1e-6).numpy(),
            np.asarray(jlayers.rmsnorm(x, {"scale": scale}, 1e-6)), **L6)

    def test_rope_halves_per_slot_positions(self):
        rng = np.random.default_rng(6)
        x = _normal(rng, 2, 5, 3, 16)
        pos = np.array([[0, 1, 2, 3, 4], [40, 41, 42, 43, 44]], np.int32)
        np.testing.assert_allclose(
            tlayers.rope(t(x), t(pos), 1e4).numpy(),
            np.asarray(jlayers.rope(x, pos, 1e4)), **L6)

    @pytest.mark.parametrize("act", ["gelu", "silu"])
    def test_gated_mlp(self, act):
        rng = np.random.default_rng(7)
        x = _normal(rng, 2, 3, 16)
        p = {"wi_gate": _normal(rng, 16, 24) * 0.25,
             "wi_up": _normal(rng, 16, 24) * 0.25,
             "wo": _normal(rng, 24, 16) * 0.2}
        mlp = tlayers.MLP(16, 24, act, dtype=torch.float32, device="cpu")
        for name, w in p.items():
            getattr(mlp, name).data.copy_(t(w))
        np.testing.assert_allclose(
            mlp(t(x)).numpy(), np.asarray(jlayers.mlp(x, p, act)), **L6)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_scaled_embedding(self, dtype):
        rng = np.random.default_rng(8)
        table = _normal(rng, 50, 4608) * 0.02
        tokens = np.array([[3, 0, 49]], np.int32)
        tdt = getattr(torch, dtype)
        got = tlayers.embed(t(tokens).long(), t(table), scale=True,
                            d_model=4608, compute_dtype=tdt)
        want = jlayers.embed(tokens, {"table": table}, scale=True,
                             d_model=4608, compute_dtype=jnp.dtype(dtype))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **L6)
        if dtype == "bfloat16":  # sqrt(4608) rounds to 68.0 before the product
            rows = t(table[tokens[0]]).to(tdt)
            assert torch.equal(got[0], rows * torch.tensor(68.0, dtype=tdt))

    def test_capped_unembed(self):
        rng = np.random.default_rng(9)
        x, table = _normal(rng, 2, 1, 32) * 4, _normal(rng, 40, 32)
        np.testing.assert_allclose(
            tlayers.unembed(t(x), t(table), softcap=30.0).numpy(),
            np.asarray(jlayers.unembed(x, {"table": table}, softcap=30.0)),
            atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# attention block: prefill and decode
# ---------------------------------------------------------------------------

D, HQ, HKV, HD, WIN, SMAX = 32, 4, 2, 16, 8, 32


def _block_params(seed):
    rng = np.random.default_rng(seed)
    p = {"wq": _normal(rng, D, HQ, HD) * D ** -0.5,
         "wk": _normal(rng, D, HKV, HD) * D ** -0.5,
         "wv": _normal(rng, D, HKV, HD) * D ** -0.5,
         "wo": _normal(rng, HQ, HD, D) * (HQ * HD) ** -0.5}
    mod = tattn.Attention(D, HQ, HKV, HD, dtype=torch.float32, device="cpu")
    for name, w in p.items():
        getattr(mod, name).data.copy_(t(w))
    return p, mod


class TestAttentionBlock:
    @pytest.mark.parametrize("mode", ["causal", "sliding"])
    def test_prefill_writes_cache_and_matches(self, mode):
        p, mod = _block_params(10)
        x = _normal(np.random.default_rng(11), 2, 20, D)
        kw = dict(mode=mode, rope_theta=1e4, window=WIN, softcap=50.0)
        jcache = jattn.init_kv_cache(2, SMAX, HKV, HD, jnp.float32)
        jout, jnew = jattn.attention_block(x, p, cache=jcache, **kw)
        cache = tattn.init_kv_cache(2, SMAX, HKV, HD, torch.float32, "cpu")
        out, cache = tattn.attention_block(t(x), mod, cache=cache, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache[name].transpose(1, 2).numpy(), np.asarray(jnew[name]),
                atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("mode", ["causal", "sliding"])
    def test_decode_per_slot_positions_cross_the_window(self, mode):
        """Ragged per-slot positions (one below the window, two past it):
        the port writes the token into the cache and attends window + 1
        positions of it; the reference attends the cache and the token
        apart.  Outputs and the written rows agree."""
        p, mod = _block_params(12)
        rng = np.random.default_rng(13)
        idx = np.array([3, 12, 27], np.int32)
        ck, cv = _normal(rng, 3, SMAX, HKV, HD), _normal(rng, 3, SMAX, HKV, HD)
        x = _normal(rng, 3, 1, D)
        kw = dict(mode=mode, rope_theta=1e4, window=WIN, softcap=50.0)
        jout, jtok = jattn.attention_block(
            x, p, cache={"k": ck, "v": cv}, cache_index=jnp.asarray(idx), **kw)
        cache = {"k": t(ck).transpose(1, 2).contiguous(),
                 "v": t(cv).transpose(1, 2).contiguous()}
        out, cache = tattn.attention_block(t(x), mod, cache=cache,
                                           cache_index=t(idx), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
        for b, i in enumerate(idx):
            np.testing.assert_allclose(
                cache["k"][b, :, i].numpy(), np.asarray(jtok["k_tok"])[b, 0],
                atol=1e-6)
            np.testing.assert_allclose(
                cache["v"][b, :, i].numpy(), np.asarray(jtok["v_tok"])[b, 0],
                atol=1e-6)

    def test_naive_oracle_equals_flash_path(self):
        p, mod = _block_params(14)
        rng = np.random.default_rng(15)
        q, k, v = (_normal(rng, 2, 19, HQ, HD), _normal(rng, 2, 19, HKV, HD),
                   _normal(rng, 2, 19, HKV, HD))
        for mode in ("causal", "sliding"):
            want = jattn.attend_naive(q, k, v, mode=mode, window=WIN,
                                      softcap=50.0)
            got = tattn.attend_naive(t(q), t(k), t(v), mode=mode, window=WIN,
                                     softcap=50.0)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
            flash = tops.flash_attention(
                t(q).transpose(1, 2), t(k).transpose(1, 2),
                t(v).transpose(1, 2), window=WIN if mode == "sliding" else 0,
                softcap=50.0).transpose(1, 2)
            np.testing.assert_allclose(flash.numpy(), got.numpy(), **F32)


# ---------------------------------------------------------------------------
# configs and the whole reduced model
# ---------------------------------------------------------------------------

class TestConfigs:
    @pytest.mark.parametrize("name", ["gemma2-27b", "gemma2_27b",
                                      "paper-synthetic", "mamba2-780m",
                                      "deepseek-moe-16b", "codeqwen1.5-7b",
                                      "granite-8b", "minicpm-2b",
                                      "kimi-k2-1t-a32b",
                                      "jamba-1.5-large-398b",
                                      "paligemma-3b",
                                      "seamless-m4t-medium"])
    def test_same_fields_as_reference(self, name):
        for reduce in (False, True):
            jc, tc = jconfigs.get(name), tconfigs.get(name)
            if reduce:
                jc, tc = jc.reduced(), tc.reduced()
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert tc.cdtype == getattr(torch, tc.compute_dtype)
            assert tc.padded_vocab == jc.padded_vocab
            assert tc.layout()[2] == jc.layout()[2]

    def test_unported_and_unknown_architectures(self):
        """Every name the reference registers (and its aliases) resolves in
        the port to the reference's configuration; an unknown name is a
        KeyError."""
        assert tconfigs.names() == jconfigs.names()
        for name in jconfigs.names():
            assert dataclasses.asdict(tconfigs.get(name)) == \
                dataclasses.asdict(jconfigs.get(name))
            alias = tconfigs.get(name).name
            assert tconfigs.get(alias).name == jconfigs.get(alias).name
        with pytest.raises(KeyError):
            tconfigs.get("no-such-model")

    def test_models_outside_the_slice_refuse(self):
        """The model refuses unknown layer kinds, and Mamba layers without
        an SSMConfig; encoder-decoder and prefix-embedding configurations
        build."""
        base = ModelConfig(name="x", family="dense", num_layers=2, d_model=8,
                           num_heads=2, num_kv_heads=2, d_ff=8,
                           vocab_size=16)
        with pytest.raises(NotImplementedError, match="not ported"):
            TT.init_params(dataclasses.replace(
                base, unit=(LayerSpec("rwkv", NONE),)), device="cpu")
        for cfg in (dataclasses.replace(base, encoder_layers=2),
                    dataclasses.replace(base, num_prefix_embeds=4)):
            assert TT.init_params(cfg, device="cpu").frontend_proj is not None
        ssm = dataclasses.replace(base, unit=(LayerSpec(MAMBA, NONE),))
        with pytest.raises(ValueError, match="SSMConfig"):
            TT.init_caches(ssm, 1, 4, device="cpu")


@pytest.fixture(scope="module")
def gemma_small():
    cfg = jconfigs.get("gemma2-27b").reduced()
    tree = _jax_tree(JT.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = tconfigs.get("gemma2-27b").reduced()
    return cfg, tree, tcfg, params_from_reference(tree, tcfg, device="cpu")


class TestReducedGemma2:
    def test_prefill_and_eight_decode_steps(self, gemma_small):
        """Window 16; the 20-token prompts and 8 steps cross it."""
        cfg, tree, tcfg, model = gemma_small
        rng = np.random.default_rng(16)
        prompt = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
        jcaches = JT.init_caches(cfg, 2, 48, cfg.cdtype)
        jlog, jcaches = JT.prefill_forward(tree, {"tokens": prompt}, cfg,
                                           jcaches)
        caches = TT.init_caches(tcfg, 2, 48, device="cpu")
        tlog, caches = TT.prefill_forward(
            model, {"tokens": t(prompt).long()}, tcfg, caches)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                                   rtol=1e-4)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
        for step in range(8):
            idx = np.full(2, 20 + step, np.int32)
            jlog, jcaches = JT.decode_forward(tree, {"tokens": tok}, cfg,
                                              jcaches, jnp.asarray(idx))
            tlog, caches = TT.decode_forward(
                model, {"tokens": t(tok).long()}, tcfg, caches, t(idx))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=1e-4, rtol=1e-4)
            tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]

    def test_weights_round_trip(self, gemma_small):
        cfg, tree, tcfg, model = gemma_small
        back = params_to_reference(model, tcfg)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                          flat_b[path])

    def test_init_params_stddevs(self):
        tcfg = tconfigs.get("gemma2-27b").reduced()
        g = torch.Generator().manual_seed(3)
        model = TT.init_params(tcfg, device="cpu", generator=g)
        assert model.embed.shape == (tcfg.padded_vocab, tcfg.d_model)
        assert len(model.layers) == tcfg.num_layers
        # a [-2, 2]-truncated unit normal has stddev 0.8796
        assert abs(float(model.embed.std()) / 0.02 - 0.8796) < 0.02
        assert float(model.embed.abs().max()) <= 0.04
        wq = model.layers[0].mixer.wq
        assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 0.8796) < 0.05
        assert not model.final_norm.scale.any()
        again = TT.init_params(tcfg, device="cpu",
                               generator=torch.Generator().manual_seed(3))
        assert torch.equal(again.layers[1].mlp.wo, model.layers[1].mlp.wo)
