"""A CPU model of the bf16 flash backward kernels' arithmetic, against the
plain version and the JAX package, on the CPU.

``csrc/flash_attention_backward.cu`` runs bfloat16 at every head_dim on
the tensor cores: bf16 operands, float32 sums, and P and dS, the only
values its products round, each split into ``bf16(x) + bf16(x -
bf16(x))``.  :func:`repro_torch.kernels.ref.flash_attention_backward_wgmma_model`
does that arithmetic on the CPU over the kernels' tile plan (128-row
blocks of two 64-row warpgroups, their ranges and skipped tiles, the
per-element mask on the tiles that cross an edge; at head_dim 256, 64-row
dK/dV blocks whose warpgroups split dK's and dV's columns, the group's q
heads split over blocks with float32 partials added in order, and 32-row
kv tiles in dQ).  Here, for every mask mode of ``test_torch_cuda.py``'s
``BWD_CASES`` at head_dim 64 or 128 and PaliGemma-3B's at 256 (at most 200
rows; the GQA prefix-LM cases span two 128-row kv blocks with a ragged Sq):

* the model with both splits stays within phase 6's limits of the plain
  version (``chip_smoke.py``: 2e-2 of each gradient's largest magnitude,
  and one bf16 rounding step of each value plus 1e-4 of the largest);
* without either split it does not: a single bf16 rounding of P (dV) or
  of dS (dQ, dK) moves gradients by several rounding steps;
* the plain version in float32 equals ``jax.grad`` of the reference's
  ``attend_chunked`` to 1e-4 of each gradient's largest magnitude, and
  the plain version and the model in bf16 stay within 2e-2 of it (their
  forward output O, and so D = rowsum(dO o O), is rounded to bf16).

Rows that admit no key contribute nothing in the port (``lse = +inf``);
the reference's forward gives them the mean of V, so its gradient is taken
with their dO zeroed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ref as tref

#: (B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap, prefix_len): the
#: modes of test_torch_cuda.py's BWD_CASES, the prefix-LM ones at 190 rows
#: (the last PaliGemma-3B's heads: 8 q heads over 1 of 256)
CASES = {
    "causal": (2, 4, 4, 130, 130, 64, True, 0, 0.0, 0),
    "sliding softcap GQA": (1, 8, 2, 200, 200, 128, True, 50, 30.0, 0),
    "bidirectional": (1, 4, 4, 97, 97, 64, False, 0, 10.0, 0),
    "cross": (2, 4, 2, 70, 150, 128, False, 0, 0.0, 0),
    "rows without keys": (1, 2, 1, 60, 30, 64, True, 11, 0.0, 0),
    "GQA ragged prefix-LM": (1, 8, 2, 190, 190, 64, True, 0, 0.0, 50),
    "hd 256 GQA 8/1 prefix-LM": (1, 8, 1, 190, 190, 256, True, 0, 0.0, 50),
}
#: phase 6's limits (chip_smoke.py's F32_GRAD_REL, BF16_TOL, BF16_STEP)
F32_GRAD_REL = 1e-4
BF16_TOL = 2e-2
BF16_STEP = 2.0 ** -7


def _mask_kw(case):
    return dict(zip(("causal", "window", "softcap", "prefix_len"), case[6:]))


def _inputs(case, seed=0):
    """q, k, v, dO with bf16 values from numpy, the forward's bf16 output
    and its lse (the plain forward's, as the kernels' forward writes)."""
    b, hq, hkv, sq, skv, hd = case[:6]
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape)
                               .astype(np.float32)).bfloat16()
    q, k, v, do = r(b, hq, sq, hd), r(b, hkv, skv, hd), r(b, hkv, skv, hd), \
        r(b, hq, sq, hd)
    kw = _mask_kw(case)
    return q, k, v, do, tref.flash_attention_ref(q, k, v, **kw), \
        tref.flash_attention_lse_ref(q, k, **kw)


def _rounding_steps(got, want):
    """Largest error as a share of one bf16 rounding step of each value
    plus F32_GRAD_REL of the largest magnitude (phase 6's step check)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    return float(((g - w).abs() / (F32_GRAD_REL * scale
                                   + BF16_STEP * w.abs())).max())


def _share(got, want):
    """Largest error as a share of ``want``'s largest magnitude."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / float(w.abs().max())


def _jax_grads(case, q, k, v, do, lse):
    """``jax.vjp`` of the reference's attend_chunked (``[B, S, H, hd]``,
    float32, one block each way) at the bf16 inputs' values; the rows that
    admit no key get a zero dO."""
    sq, skv = case[3], case[4]
    causal, window, softcap, prefix = case[6:]
    if not causal:
        mode = jattn.BIDIR
    elif window:
        mode = jattn.SLIDING
    else:
        mode = jattn.PREFIX if prefix else jattn.CAUSAL

    def to_jax(t):
        return jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3))

    def attend(q_, k_, v_):
        return jattn.attend_chunked(q_, k_, v_, mode=mode, window=window,
                                    prefix_len=prefix, softcap=softcap,
                                    block_q=sq, block_k=skv)
    live_do = torch.where(torch.isfinite(lse)[..., None], do.float(), 0.0)
    _, vjp = jax.vjp(attend, to_jax(q), to_jax(k), to_jax(v))
    return [torch.as_tensor(np.array(g).transpose(0, 2, 1, 3))
            for g in vjp(to_jax(live_do))]


@pytest.mark.parametrize("mode", list(CASES))
def test_model_with_splits_within_one_rounding_step(mode):
    case = CASES[mode]
    q, k, v, do, o, lse = _inputs(case)
    kw = _mask_kw(case)
    want = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    got = tref.flash_attention_backward_wgmma_model(q, k, v, o, lse, do,
                                                    **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _share(g, w) <= BF16_TOL
        assert _rounding_steps(g, w) <= 1.0


@pytest.mark.parametrize("mode", ["causal", "sliding softcap GQA",
                                  "hd 256 GQA 8/1 prefix-LM"])
def test_model_without_splits_exceeds_the_step(mode):
    """One bf16 rounding of P moves dV, of dS moves dQ and dK, beyond one
    rounding step of the plain version (5-12 steps in these cases; at
    head_dim 256 too)."""
    case = CASES[mode]
    q, k, v, do, o, lse = _inputs(case)
    kw = _mask_kw(case)
    want = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    no_p = tref.flash_attention_backward_wgmma_model(
        q, k, v, o, lse, do, split_p=False, **kw)
    no_ds = tref.flash_attention_backward_wgmma_model(
        q, k, v, o, lse, do, split_ds=False, **kw)
    assert _rounding_steps(no_p[2], want[2]) > 2.0          # dV
    assert _rounding_steps(no_ds[0], want[0]) > 2.0         # dQ
    assert _rounding_steps(no_ds[1], want[1]) > 2.0         # dK
    # each split touches only the gradients whose product reads it
    with_both = tref.flash_attention_backward_wgmma_model(q, k, v, o, lse,
                                                          do, **kw)
    assert torch.equal(no_p[0], with_both[0])
    assert torch.equal(no_ds[2], with_both[2])


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_hd256_head_splits_add_in_order(splits):
    """At head_dim 256 the dK/dV blocks split the group's q heads and add
    their float32 partials in order: dQ does not move, dK and dV stay
    within a rounding step of the plain version at every split count."""
    case = CASES["hd 256 GQA 8/1 prefix-LM"]
    q, k, v, do, o, lse = _inputs(case, seed=2)
    kw = _mask_kw(case)
    want = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    whole = tref.flash_attention_backward_wgmma_model(
        q, k, v, o, lse, do, head_splits=1, **kw)
    got = tref.flash_attention_backward_wgmma_model(
        q, k, v, o, lse, do, head_splits=splits, **kw)
    assert torch.equal(got[0], whole[0])
    for g, w in zip(got[1:], want[1:]):
        assert _rounding_steps(g, w) <= 1.0


def test_head_splits_fill_the_card():
    """The wrapper's split: bf16 at head_dim 256 only, the smallest divisor
    of the group giving 1.5 blocks an SM of 132 (PaliGemma-3B's one kv
    head: 4 at its 4,352 training positions, 68 kv tiles, and at 4,096, 64
    tiles), the group when none does; 1 for every other case."""
    from repro_torch.kernels.flash_attention import head_splits

    bf16 = torch.bfloat16
    assert head_splits(1, 8, 1, 4352, 256, bf16) == 4
    assert head_splits(1, 8, 1, 4096, 256, bf16) == 4
    assert head_splits(1, 8, 1, 190, 256, bf16) == 8
    assert head_splits(4, 8, 1, 4352, 256, bf16) == 1
    assert head_splits(1, 8, 1, 4352, 256, torch.float32) == 1
    assert head_splits(1, 36, 36, 4096, 64, bf16) == 1
    assert head_splits(1, 8, 1, 4352, 256, bf16, sms=16) == 1


@pytest.mark.parametrize("mode", list(CASES))
def test_model_and_plain_against_jax_grad(mode):
    case = CASES[mode]
    q, k, v, do, o, lse = _inputs(case, seed=1)
    kw = _mask_kw(case)
    jax_grads = _jax_grads(case, q, k, v, do, lse)
    f32 = [t.float() for t in (q, k, v, do)]
    o32 = tref.flash_attention_ref(*f32[:3], **kw)
    plain32 = tref.flash_attention_backward_ref(*f32[:3], o32, lse, f32[3],
                                                **kw)
    plain = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
    model = tref.flash_attention_backward_wgmma_model(q, k, v, o, lse, do,
                                                      **kw)
    for p32, p, m, j in zip(plain32, plain, model, jax_grads):
        assert _share(p32, j) <= F32_GRAD_REL
        assert _share(p, j) <= BF16_TOL
        assert _share(m, j) <= BF16_TOL


if __name__ == "__main__":
    # each case's largest share of a rounding step against the plain
    # version, with both splits and without each (the numbers PERF.md
    # quotes):  PYTHONPATH=src python tests/test_torch_flash_backward.py
    for name, case in CASES.items():
        q, k, v, do, o, lse = _inputs(case)
        kw = _mask_kw(case)
        want = tref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
        row = []
        for label, splits in (("both", {}), ("no P split", {"split_p": False}),
                              ("no dS split", {"split_ds": False})):
            got = tref.flash_attention_backward_wgmma_model(
                q, k, v, o, lse, do, **splits, **kw)
            steps = [_rounding_steps(g, w) for g, w in zip(got, want)]
            row.append(f"{label}: dq {steps[0]:.3f} dk {steps[1]:.3f} "
                       f"dv {steps[2]:.3f}")
        print(f"{name}: " + "; ".join(row))
