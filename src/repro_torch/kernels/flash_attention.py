"""Flash attention for prefill: wrapper around the CUDA kernel.

Port of ``repro/kernels/flash_attention.py``.  The kernels are in
``csrc/flash_attention.cu``: causal, sliding-window, prefix-LM and
bidirectional attention with online softmax, softcap and GQA, head_dim 64,
128 or 256.  The prefix-LM mask (``k <= q or k < prefix_len``) is the
reference model's ``PREFIX`` mode (``repro/models/attention.py``), which
its Pallas kernel does not take: the JAX model computes it outside the
kernel, the port's prefill through it.  bfloat16 inputs
at head_dim 64 and 128 go to ``flash_forward_wgmma`` (tensor-core products
fed by TMA, float32 scores and softmax); float32 inputs, and head_dim 256
in either dtype, to ``flash_forward`` (float32 FMAs on the CUDA cores);
there is no other route.  The wrapper takes CUDA tensors only: it checks
device, dtype, shape and contiguity, allocates the output, launches on the
current stream through the shared helpers of
:mod:`repro_torch.kernels._build`, raises if the launch was refused, and
counts the launch in :data:`LAUNCHES`.  CPU tensors go to
:func:`repro_torch.kernels.ref.flash_attention_ref` through
:mod:`repro_torch.kernels.ops`, never through this wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda

__all__ = ["HEAD_DIMS", "LAUNCHES", "check_attention_inputs",
           "check_prefix", "flash_attention"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"flash_attention": 0}
#: the head dims the kernels are compiled for
HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    prefix_len: int = 0) -> torch.Tensor:
    """q ``[B, Hq, Sq, hd]``; k, v ``[B, Hkv, Skv, hd]`` -> ``[B, Hq, Sq,
    hd]`` of q's dtype.  Any ``Sq`` (the ragged last tile is masked).
    With ``causal``, query ``i`` sees keys ``j <= i`` and, with
    ``prefix_len``, every key ``j < prefix_len``."""
    dev = check_cuda(("q", "k", "v"), q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: need q [B,Hq,Sq,hd] and k, v "
                         f"[B,Hkv,Skv,hd], got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    check_attention_inputs("flash_attention", q, k, v)
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} (batch, or Hq % Hkv)")
    if hq > 65535 or b > 65535:
        raise ValueError("flash_attention: batch and heads must be < 65536")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    check_prefix(prefix_len, skv, causal, window)
    out = torch.empty_like(q)
    if q.numel() == 0 or skv == 0:  # no key: the plain version's zeros
        return out.zero_()
    _build.launch("attn_flash_forward", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, hd,
                  DTYPE_CODES[q.dtype], int(causal), int(window),
                  float(softcap), int(prefix_len))
    LAUNCHES["flash_attention"] += 1
    return out
