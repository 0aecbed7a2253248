"""GQA attention: causal, sliding-window, prefix-LM, bidirectional and
cross attention, with prefill (cache write) and decode (cache read), through
the flash and decode attention kernels.

Port of ``repro/models/attention.py`` for one card: the layers run
unpadded heads.  :func:`padded_head_counts` is the reference's
tensor-parallel head padding, which ``launch/steps.py`` reads to size the
caches of a mesh layout; the padding itself runs with the multi-card
mesh (ROADMAP).  The mask modes are the reference's: ``CAUSAL``, ``SLIDING``, ``PREFIX``
(bidirectional over the first ``prefix_len`` positions, causal after:
``k <= q or k < prefix_len``, which is what the reference's rule reduces
to) and ``BIDIR`` (the encoder).  Cross attention
(:func:`cross_attention_block`) reads the encoder's k/v
(:func:`encode_cross_kv`), with no rope, as the reference does.

The KV cache of a layer is ``{"k", "v"}``, each ``[B, Hkv, S_max, hd]``:
the decode kernel's layout, so neither mode transposes the cache.  A step
of ``attention_block``:

* **prefill** (``cache_index is None``): writes the prompt's k/v into the
  cache rows ``[0, S)`` and attends with ``ops.flash_attention``; without
  a cache (the encoder) it only attends;
* **decode** (``cache_index`` given, one token per slot): writes the
  token's k/v into the cache IN PLACE at each slot's own position, then
  attends with ``ops.decode_attention`` over ``valid_len = index + 1``.
  The reference attends the cache at ``k > index - window`` plus the
  token's own k/v passed apart, ``window`` keys in all; with the token in
  the cache and ``valid_len = index + 1`` the same keys need the kernel's
  window to be ``window + 1``.

:func:`attend_naive` is the plain, materializing oracle the tests use.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -2.0e38

# mask modes
CAUSAL = "causal"
SLIDING = "sliding"
PREFIX = "prefix"   # bidirectional over [0, prefix_len), causal after
BIDIR = "bidir"
MODES = (CAUSAL, SLIDING, PREFIX, BIDIR)


def padded_head_counts(n_heads: int, n_kv: int, tp: int):
    """TP head padding, the reference's arithmetic: when the q heads do not
    divide over ``tp``, pad them (zeros) to the next multiple of ``tp`` and
    the kv heads by the same group ratio.  Returns ``(Hq_pad, Hkv_pad)``,
    unchanged when padding cannot help (attention then stays
    TP-replicated)."""
    if tp <= 1 or n_heads == 0 or n_heads % tp == 0:
        return n_heads, n_kv
    g = n_heads // n_kv
    hq_pad = -(-n_heads // tp) * tp
    kv_pad = hq_pad // g
    if hq_pad % g or kv_pad % tp:
        return n_heads, n_kv
    return hq_pad, kv_pad


class Attention(nn.Module):
    """Projections ``wq [d, Hq, hd]``, ``wk``/``wv [d, Hkv, hd]``,
    ``wo [Hq, hd, d]`` (the reference's layouts)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, dtype, device):
        super().__init__()
        if n_kv <= 0 or n_heads % n_kv:
            raise ValueError(f"{n_heads} q heads do not group over {n_kv} "
                             f"kv heads")
        def param(*shape):
            return layers.zeros_param(shape, dtype, device)

        self.wq = param(d_model, n_heads, head_dim)
        self.wk = param(d_model, n_kv, head_dim)
        self.wv = param(d_model, n_kv, head_dim)
        self.wo = param(n_heads, head_dim, d_model)

    def init_weights(self, generator) -> None:
        d = self.wq.shape[0]
        for w in (self.wq, self.wk, self.wv):
            layers.truncated_normal_(w.data, d ** -0.5, generator)
        n, hd = self.wo.shape[:2]
        layers.truncated_normal_(self.wo.data, (n * hd) ** -0.5, generator)


def _project(x, w):
    """x ``[B, S, d]`` @ w ``[d, H, hd]`` -> ``[B, S, H, hd]``."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).view(*x.shape[:2], h, hd)


def _mask(q_pos, k_pos, mode: str, window: int, prefix_len: int):
    """The admitted (q, k) pairs ``[len(q_pos), len(k_pos)]`` of ``mode``
    (the reference's ``_mask_bias``)."""
    q, k = q_pos[:, None], k_pos[None, :]
    if mode == BIDIR:
        return torch.ones(q.shape[0], k.shape[1], dtype=torch.bool,
                          device=q.device)
    allowed = k <= q
    if mode == SLIDING:
        allowed &= k > q - window
    elif mode == PREFIX:
        allowed |= k < prefix_len
    elif mode != CAUSAL:
        raise ValueError(f"attention mode {mode!r}; known: {MODES}")
    return allowed


def attend_naive(q, k, v, *, mode=CAUSAL, window=0, prefix_len=0,
                 softcap=0.0, q_offset=0, kv_valid_len=None):
    """Materializing oracle. q ``[B, Sq, Hq, hd]``; k, v ``[B, Skv, Hkv, hd]``
    -> ``[B, Sq, Hq, hd]``; float32 scores, p cast to v's dtype for P.V as
    in the reference."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    s = s.reshape(b, hq, sq, skv) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    allowed = _mask(q_pos, k_pos, mode, window, prefix_len)[None, None]
    if kv_valid_len is not None:
        allowed = allowed & (k_pos < kv_valid_len)[None, None, None, :]
    s = torch.where(allowed, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).reshape(b, hkv, g, sq, skv)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(b, sq, hq, hd)


def _positions(cache_index, b: int, s: int, device) -> torch.Tensor:
    base = torch.as_tensor(0 if cache_index is None else cache_index,
                           device=device).reshape(-1)
    if base.numel() == 1:
        base = base.expand(b)
    return base[:, None].to(torch.int64) + torch.arange(s, device=device)


def attention_block(x, params: Attention, *, mode: str, rope_theta: float,
                    window: int = 0, prefix_len: int = 0,
                    softcap: float = 0.0, cache: Optional[dict] = None,
                    cache_index=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x ``[B, S, d]`` -> (out ``[B, S, d]``, cache).

    * ``cache_index is None``: the whole sequence from position 0 under
      ``mode`` (``PREFIX`` with ``prefix_len``; ``BIDIR`` for the encoder,
      which has no cache); with a cache, its rows ``[0, S)`` are
      overwritten with the sequence's k/v (a prefill).
    * ``cache_index`` a scalar or one position per slot ``[B]``, ``S == 1``:
      decode; the token's k/v land in the cache in place at those positions
      (each must be ``< S_max``) and the step attends positions
      ``[0, index]`` (the last ``window`` of them for a sliding layer).
    The cache is updated in place and returned."""
    if mode not in MODES:
        raise ValueError(f"attention mode {mode!r}; known: {MODES}")
    b, s, _ = x.shape
    q = _project(x, params.wq)
    k = _project(x, params.wk)
    v = _project(x, params.wv)
    positions = _positions(cache_index, b, s, x.device)
    q = layers.rope(q, positions, rope_theta)
    k = layers.rope(k, positions, rope_theta)
    win = window if mode == SLIDING else 0

    if cache_index is not None:
        if cache is None or s != 1:
            raise ValueError("decode needs a cache and one token per slot")
        idx = positions[:, 0]
        slots = torch.arange(b, device=x.device)
        ck, cv = cache["k"], cache["v"]
        ck[slots, :, idx] = k[:, 0].to(ck.dtype)
        cv[slots, :, idx] = v[:, 0].to(cv.dtype)
        o = ops.decode_attention(
            q[:, 0], ck, cv, (idx + 1).to(torch.int32),
            softcap=softcap, window=win + 1 if win else 0,
        )[:, None]                                        # [B, 1, Hq, hd]
    else:
        if cache is not None:
            cache["k"][:, :, :s] = k.transpose(1, 2).to(cache["k"].dtype)
            cache["v"][:, :, :s] = v.transpose(1, 2).to(cache["v"].dtype)
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=mode != BIDIR, window=win, softcap=softcap,
            prefix_len=prefix_len if mode == PREFIX else 0,
        ).transpose(1, 2)                                 # [B, S, Hq, hd]
    return _out(o, params.wo, x.dtype), cache


def _out(o, wo, dtype):
    """o ``[B, S, Hq, hd]`` @ wo ``[Hq, hd, d]`` -> ``[B, S, d]``."""
    b, s = o.shape[:2]
    hq, hd, d = wo.shape
    return o.reshape(b, s, hq * hd) @ wo.to(dtype).reshape(hq * hd, d)


def encode_cross_kv(enc_out, params: Attention) -> dict:
    """The encoder output ``[B, S_src, d]`` through a cross layer's ``wk``,
    ``wv`` (no rope) -> ``{"k", "v"}``, each ``[B, Hkv, S_src, hd]``: the
    flash and decode kernels' layout (the reference's is ``[B, S_src, Hkv,
    hd]``)."""
    return {"k": _project(enc_out, params.wk).transpose(1, 2).contiguous(),
            "v": _project(enc_out, params.wv).transpose(1, 2).contiguous()}


def cross_attention_block(x, params: Attention,
                          enc_kv: dict) -> torch.Tensor:
    """Decoder cross attention ``[B, S, d]`` -> ``[B, S, d]`` against the
    encoder's k/v (:func:`encode_cross_kv`), every source position
    admitted, no rope.  ``S`` queries run ``ops.flash_attention`` with no
    causal mask (against ``S_src`` keys); one query a slot (a decode step)
    runs ``ops.decode_attention`` with ``valid_len = S_src``."""
    q = _project(x, params.wq)                            # [B, S, Hq, hd]
    k, v = enc_kv["k"], enc_kv["v"]
    if x.shape[1] == 1:
        o = ops.decode_attention(q[:, 0], k, v, k.shape[2])[:, None]
    else:
        o = ops.flash_attention(q.transpose(1, 2), k, v,
                                causal=False).transpose(1, 2)
    return _out(o, params.wo, x.dtype)


def init_kv_cache(batch: int, s_max: int, n_kv: int, head_dim: int, dtype,
                  device) -> dict:
    return {
        "k": torch.zeros((batch, n_kv, s_max, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_kv, s_max, head_dim), dtype=dtype,
                         device=device),
    }
