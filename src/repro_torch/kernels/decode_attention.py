"""Decode attention against the KV cache: wrapper around the CUDA kernel.

Port of ``repro/kernels/decode_attention.py``.  The kernel is
``csrc/decode_attention.cu``: one query row per (slot, q head) against the
cached rows ``p < valid_len[slot]`` (and ``p > valid_len[slot] - window``),
with softcap and GQA, float32 math for float32 or bfloat16 inputs,
head_dim 64 or 128, at most 8 q heads per kv head.  ``valid_len`` is one
length per slot (int32 ``[B]``); a scalar broadcasts.  The wrapper takes
CUDA tensors only, checks them, launches on the current stream, raises on a
refused launch and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES,
    check_attention_inputs,
)
from repro_torch.kernels.segment_reduce import check_cuda

__all__ = ["LAUNCHES", "MAX_GROUP", "decode_attention"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"decode_attention": 0}
#: most q heads one kv head may serve
MAX_GROUP = 8


def decode_attention(q, cache_k, cache_v, valid_len, *, softcap: float = 0.0,
                     window: int = 0) -> torch.Tensor:
    """q ``[B, Hq, hd]``; cache ``[B, Hkv, S, hd]``; ``valid_len`` int32
    ``[B]`` (or a scalar) with every entry >= 1 -> ``[B, Hq, hd]``.

    A row with ``valid_len`` 0 admits no position; the kernel then returns
    zeros where the plain version averages the masked rows, so callers pass
    at least 1 (the model passes the cache index plus one)."""
    b = q.shape[0]
    if not isinstance(valid_len, torch.Tensor) or valid_len.dim() == 0:
        valid_len = torch.full((b,), int(valid_len), dtype=torch.int32,
                               device=q.device)
    dev = check_cuda(q=q, cache_k=cache_k, cache_v=cache_v,
                     valid_len=valid_len)
    if q.dim() != 3 or cache_k.dim() != 4:
        raise ValueError(f"decode_attention: need q [B,Hq,hd] and cache "
                         f"[B,Hkv,S,hd], got {tuple(q.shape)} and "
                         f"{tuple(cache_k.shape)}")
    check_attention_inputs("decode_attention", q, cache_k, cache_v)
    hq, hd = q.shape[1], q.shape[2]
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape[0] != b or hkv == 0 or hq % hkv or s_len == 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"the cache {tuple(cache_k.shape)}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {hq // hkv} q heads per kv head "
                         f"exceed {MAX_GROUP}")
    if valid_len.dtype != torch.int32 or valid_len.shape != (b,):
        raise ValueError(f"decode_attention: valid_len must be int32 [{b}], "
                         f"got {valid_len.dtype} {tuple(valid_len.shape)}")
    if window < 0:
        raise ValueError(f"decode_attention: window must be >= 0, got {window}")
    if b > 65535:
        raise ValueError("decode_attention: batch must be < 65536")
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = _build.library().attn_decode_forward
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                valid_len.data_ptr(), out.data_ptr(), b, hq, hkv, s_len, hd,
                DTYPE_CODES[q.dtype], int(window), float(softcap),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    LAUNCHES["decode_attention"] += 1
    return out
