"""Flash attention for prefill: wrapper around the CUDA kernel.

Port of ``repro/kernels/flash_attention.py``.  The kernels are in
``csrc/flash_attention.cu``: causal, sliding-window, prefix-LM and
bidirectional attention with online softmax, softcap and GQA, head_dim 64,
128 or 256.  The prefix-LM mask (``k <= q or k < prefix_len``) is the
reference model's ``PREFIX`` mode (``repro/models/attention.py``), which
its Pallas kernel does not take: the JAX model computes it outside the
kernel, the port's prefill through it.  bfloat16 inputs go to
``flash_forward_wgmma`` at every head_dim (tensor-core products fed by TMA,
float32 scores and softmax; at 256 a ring of two K/V stages); float32
inputs to ``flash_forward`` (float32 FMAs on the CUDA cores); there is no
other route, and a launch the card refuses raises.  For training,
:func:`flash_attention` also writes each row's log-sum-exp when given
``lse``, and
:func:`flash_attention_backward` launches the backward kernels
(``csrc/flash_attention_backward.cu``, no atomics: D, then dK/dV and dQ
as ``flash_bwd_dkdv_wgmma`` / ``flash_bwd_dq_wgmma`` for bfloat16 at every
head_dim, tensor-core products fed by TMA with P and dS split into two bf16
parts, at 256 with the group's q heads split over :func:`head_splits`
blocks a kv tile whose float32 partials a fourth kernel adds in order; as
the float32-FMA ``flash_bwd_dkdv`` / ``flash_bwd_dq`` for float32), which
:class:`FlashAttentionFunction` ties to the forward for autograd.  The
wrappers take CUDA tensors only: each checks
device, dtype, shape and contiguity, allocates the output, launches on the
current stream through the shared helpers of
:mod:`repro_torch.kernels._build`, raises if the launch was refused, and
counts the launch in :data:`LAUNCHES`.  CPU tensors go to
:func:`repro_torch.kernels.ref.flash_attention_ref` through
:mod:`repro_torch.kernels.ops`, never through this wrapper.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._build import check_cuda

__all__ = ["HEAD_DIMS", "LAUNCHES", "FlashAttentionFunction",
           "check_attention_inputs", "check_prefix", "dead_rows_start",
           "flash_attention", "flash_attention_backward", "head_splits",
           "workspace_floats"]

#: kernel launches (reset with ``ops.reset_launch_counts``); a backward call
#: (three kernels, four in bfloat16 at head_dim 256) counts once
LAUNCHES = {"flash_attention": 0, "flash_attention_backward": 0}
#: the head dims the kernels are compiled for
HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kv rows of a bf16 dK/dV block at head_dim 256 (BwdPlan<256> of
#: ``csrc/flash_attention_backward.cu``)
WIDE_KV_ROWS = 64
#: the SMs of an H100, the default of :func:`head_splits`
H100_SMS = 132


def head_splits(b: int, hq: int, hkv: int, skv: int, hd: int, dtype,
                sms: int = H100_SMS) -> int:
    """The dK/dV blocks a kv tile's group of q heads is split over, each
    writing float32 partials: for bfloat16 at head_dim 256, the smallest
    divisor of the group ``hq // hkv`` that gives at least 1.5 blocks an SM
    (``sms`` SMs; the group when none does), so that a model with one kv
    head fills the card; 1 otherwise.  A block takes 193 KB of shared
    memory, one an SM.  At PaliGemma-3B's 8 q heads over 1 kv head on an
    H100 (``chip_smoke.py --only-flash``, PERF.md) 4 splits were the
    fastest at 4,096 and 4,352 positions (1.9-2.1 blocks an SM); 2 (1.0)
    took 1.45x their time, 8 (3.9-4.1) 2-7% more: any bar between 1.03 and
    1.94 blocks an SM picks 4 at both."""
    if dtype != torch.bfloat16 or hd != 256:
        return 1
    group = hq // hkv
    blocks = b * hkv * -(-skv // WIDE_KV_ROWS)
    return next(s for s in range(1, group + 1)
                if group % s == 0
                and (2 * blocks * s >= 3 * sms or s == group))


def workspace_floats(b: int, hq: int, hkv: int, sq: int, skv: int, hd: int,
                     dtype, splits: int) -> int:
    """The backward's float32 workspace: D ``[B, Hq, Sq]`` rounded up to 64
    floats, then, for bfloat16 at head_dim 256, dK's and dV's ``splits``
    partials ``[2, splits, B * Hkv * Skv, hd]`` (the kernel's layout)."""
    n = -(-b * hq * sq // 64) * 64
    if dtype == torch.bfloat16 and hd == 256:
        n += 2 * splits * b * hkv * skv * hd
    return n


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    if device == _build.META:
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_attention_inputs(what: str, q, k, v) -> None:
    """One dtype the kernels take, head_dim in :data:`HEAD_DIMS`, 16-byte
    aligned storage (the kernels load rows as vectors), q heads a multiple
    of kv heads, and k, v of one shape."""
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS or k.shape[-1] != hd:
        raise ValueError(f"{what}: head_dim must be one of {HEAD_DIMS}, got "
                         f"q {q.shape[-1]} and k {k.shape[-1]}")
    if k.shape != v.shape:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"differ")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def check_prefix(prefix_len: int, skv: int, causal: bool,
                 window: int) -> None:
    """``0 <= prefix_len <= Skv``, and a prefix only with the causal mask
    and no window (the reference's ``PREFIX`` mode has neither)."""
    if not 0 <= prefix_len <= skv:
        raise ValueError(f"flash_attention: prefix_len must lie in [0, "
                         f"{skv}], got {prefix_len}")
    if prefix_len and (not causal or window):
        raise ValueError(f"flash_attention: prefix_len {prefix_len} needs "
                         f"causal=True and no window (got causal={causal}, "
                         f"window={window})")


def dead_rows_start(sq: int, skv: int, window: int) -> int:
    """The first query row that admits no key: with a window, row ``q``
    sees keys ``(q - window, q]`` (or ``(q - window, Skv)`` without the
    causal mask), none of which lies below ``Skv`` once ``q >= Skv + window
    - 1``; without a window every row sees key 0.  ``sq`` when there is no
    such row."""
    if window > 0:
        return min(sq, max(0, skv + window - 1))
    return sq if skv else 0


def _check_flash(what: str, q, k, v, causal: bool, window: int,
                 prefix_len: int) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: need q [B,Hq,Sq,hd] and k, v "
                         f"[B,Hkv,Skv,hd], got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    check_attention_inputs(what, q, k, v)
    b, hq = q.shape[:2]
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or hkv == 0 or hq % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (batch, or Hq % Hkv)")
    if hq > 65535 or b > 65535:
        raise ValueError(f"{what}: batch and heads must be < 65536")
    if window < 0:
        raise ValueError(f"{what}: window must be >= 0, got {window}")
    check_prefix(prefix_len, skv, causal, window)


def _check_like(what: str, ref, **tensors) -> None:
    """Each of ``tensors`` has ``ref``'s shape and dtype and 16-byte aligned
    storage."""
    for name, t in tensors.items():
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} "
                             f"does not match {tuple(ref.shape)} {ref.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _check_lse(what: str, q, lse) -> None:
    if lse.dtype != torch.float32 or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"{what}: lse must be float32 {tuple(q.shape[:3])}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, prefix_len: int = 0,
                    lse=None) -> torch.Tensor:
    """q ``[B, Hq, Sq, hd]``; k, v ``[B, Hkv, Skv, hd]`` -> ``[B, Hq, Sq,
    hd]`` of q's dtype.  Any ``Sq`` (the ragged last tile is masked).
    With ``causal``, query ``i`` sees keys ``j <= i`` and, with
    ``prefix_len``, every key ``j < prefix_len``.

    ``lse``: None (serving), or a float32 ``[B, Hq, Sq]`` tensor that
    receives each row's log-sum-exp (natural log) of its scaled,
    soft-capped, admitted scores, which :func:`flash_attention_backward`
    reads.  A row that admits no key (only with a window, from
    :func:`dead_rows_start` on) has ``lse = +inf``, so the backward gives
    it no gradient; its output is the plain version's, the mean of V over
    all ``Skv`` keys (a softmax over scores all at -2e38), which this
    wrapper writes after the kernel."""
    what = "flash_attention"
    dev = check_cuda(("q", "k", "v") + (("lse",) if lse is not None else ()),
                     q, k, v, *(() if lse is None else (lse,)))
    _check_flash(what, q, k, v, causal, window, prefix_len)
    if lse is not None:
        _check_lse(what, q, lse)
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.numel() == 0 or skv == 0:  # no key: the plain version's zeros
        if lse is not None:
            lse.fill_(float("inf"))
        return out.zero_()
    _build.launch("attn_flash_forward", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, hq, hkv, sq,
                  skv, hd, DTYPE_CODES[q.dtype], int(causal), int(window),
                  float(softcap), int(prefix_len))
    _build.count(LAUNCHES, "flash_attention", dev,
                 lambda: costs.flash_attention_cost(
                     b, hq, hkv, sq, skv, hd, q.element_size(),
                     lse=lse is not None, causal=causal, window=window,
                     softcap=softcap, prefix_len=prefix_len))
    dead = dead_rows_start(sq, skv, window)
    if dead < sq:
        mean_v = v.float().mean(dim=2, keepdim=True)
        out[:, :, dead:] = mean_v.repeat_interleave(hq // hkv, dim=1) \
            .to(q.dtype)
    return out


def flash_attention_backward(q, k, v, o, lse, dout, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             prefix_len: int = 0):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention`'s output
    ``o`` for its gradient ``dout`` (``[B, Hq, Sq, hd]`` like q), from the
    forward's ``lse``; the same options as the forward's.  Each in its
    input's dtype, accumulated in float32 and rounded once; a row whose lse
    is +inf contributes nothing.  Three kernels a call
    (``csrc/flash_attention_backward.cu``: D, dK/dV, dQ; the dK/dV and dQ
    kernels routed by dtype as the forward's; bfloat16 at head_dim 256 adds
    the sum of the dK/dV partials of :func:`head_splits` blocks), counted as
    one launch; no atomics, so a call's result is the same bits every
    time."""
    what = "flash_attention_backward"
    dev = check_cuda(("q", "k", "v", "o", "lse", "dout"), q, k, v, o, lse,
                     dout)
    _check_flash(what, q, k, v, causal, window, prefix_len)
    _check_like(what, q, o=o, dout=dout)
    _check_lse(what, q, lse)
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    splits = head_splits(b, hq, hkv, skv, hd, q.dtype, _sm_count(dev))
    work = torch.empty(workspace_floats(b, hq, hkv, sq, skv, hd, q.dtype,
                                        splits),
                       dtype=torch.float32, device=q.device)
    _build.launch("attn_flash_backward", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), work.data_ptr(), b, hq, hkv, sq, skv, hd,
                  DTYPE_CODES[q.dtype], int(causal), int(window),
                  float(softcap), int(prefix_len), splits)
    _build.count(LAUNCHES, "flash_attention_backward", dev,
                 lambda: costs.flash_attention_backward_cost(
                     b, hq, hkv, sq, skv, hd, q.element_size(),
                     causal=causal, window=window, softcap=softcap,
                     prefix_len=prefix_len))
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with 16-byte aligned storage (copied if not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` with its gradient from
    :func:`flash_attention_backward`: the forward launches the kernel with
    ``lse``, keeps q, k, v, its output and ``lse``, and the backward
    launches the backward kernels.  ``apply(q, k, v, causal, window,
    softcap, prefix_len)``; q, k, v contiguous and aligned."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, prefix_len):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        o = flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap, prefix_len=prefix_len, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap,
                        prefix_len=prefix_len)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, _aligned(dout),
                                              **ctx.mask)
        return dq, dk, dv, None, None, None, None
