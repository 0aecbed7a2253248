"""GQA attention: causal, sliding-window, prefix-LM, bidirectional and
cross attention, with prefill (cache write) and decode (cache read), through
the flash and decode attention kernels.

Port of ``repro/models/attention.py``.  Under sharding rules with a live
mesh (:mod:`repro_torch.launch.sharding`) whose model axis has ``n > 1``
ranks, a layer runs this rank's heads: the reference's TP head padding
(:func:`padded_head_counts`: q heads padded with zeros to a multiple of
``n``, kv heads by the group ratio), q, k and v for the rank's block of
the padded heads (projected by its shard of ``wq``/``wk``/``wv``, or
projected whole, padded and sliced when the weights are replicated), flash
or decode on those heads, and ``wo`` row-parallel: the rows of the rank's
real heads, the partial sum all-reduced (the reference's next
``constrain``).  Heads that do not divide and cannot be padded stay
TP-replicated, as in the reference.  Without rules the layers run every
head.  The mask modes are the reference's: ``CAUSAL``, ``SLIDING``, ``PREFIX``
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

The long-context decode (active rules with ``seq_axis``: the batch does
not divide the data axes, so every data rank serves the whole batch and
the KV caches' sequence is split over them, the rank at index ``i``
holding rows ``[i S_local, (i + 1) S_local)``): only the rank that holds
``index`` writes the token's k/v, every rank runs
``ops.decode_attention_partial`` over its rows (global positions in its
mask), and the blocks' float32 ``(o, lse)`` merge over the axis after one
all-gather (:func:`_merge_blocks`), as GSPMD does the reference's.  The
model axis's kv heads combine with it as above.

:func:`attend_naive` is the plain, materializing oracle the tests use.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import active_rules, constrain
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

        self.n_heads, self.n_kv = n_heads, n_kv
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


def kv_block(q_lo: int, hq: int, group: int):
    """(first kv head, count) when q heads ``[q_lo, q_lo + hq)`` of GQA
    groups of ``group`` read a block of kv heads in equal shares (each kv
    head of the block by ``hq / count`` of them), the layout of a ``narrow``
    view; None otherwise."""
    ids = [(q_lo + j) // group for j in range(hq)]
    first, count = ids[0], ids[-1] - ids[0] + 1
    if hq % count == 0 and ids == [first + j // (hq // count)
                                   for j in range(hq)]:
        return first, count
    return None


class _Heads:
    """One rank's heads under active rules whose model axis has ``n > 1``
    ranks and pads or divides the q heads (:func:`_heads` gives None
    otherwise).  Head indices below are global, over the padded heads:
    the rank's q heads are ``[lo, lo + hq)``."""

    def __init__(self, rules, n: int, params: "Attention"):
        self.live, self.axis = rules.live, rules.tp
        self.n_heads = params.n_heads
        self.hq_pad, self.kv_pad = padded_head_counts(params.n_heads,
                                                      params.n_kv, n)
        self.group = self.hq_pad // self.kv_pad
        self.hq = self.hq_pad // n
        self.lo = self.live.index(self.axis) * self.hq
        # whether a projection holds every head (replicated over the model
        # axis) rather than this rank's shard, which holds 1/n of them
        self.q_full = params.wq.shape[1] == params.n_heads
        self.kv_full = params.wk.shape[1] == params.n_kv

    def enter(self, x, params: "Attention"):
        """The block's input and weights as this rank uses them: x and
        every replicated weight through ``copy_in``, so their gradients sum
        over the ranks' heads."""
        live, axis = self.live, self.axis

        def use(t, full):
            return mesh_lib.copy_in(t, live, axis) if full else t

        return (mesh_lib.copy_in(x, live, axis), use(params.wq, self.q_full),
                use(params.wk, self.kv_full), use(params.wv, self.kv_full),
                use(params.wo, self.q_full))

    def q_local(self, q):
        """q ``[B, S, H, hd]`` of every (unpadded) head or of this rank's
        block -> this rank's padded block."""
        if not self.q_full:
            return q
        return constrain(_pad_heads(q, self.hq_pad), "batch", None, "tp",
                         None, have=("batch", None, None, None))

    def kv_heads(self, t):
        """k or v ``[B, S, Hkv, hd]`` of every kv head or of this rank's
        shard -> (padded tensor, global index of its first head)."""
        if not self.kv_full:
            return t, self.live.index(self.axis) * t.shape[2]
        return _pad_heads(t, self.kv_pad), 0

    def cache_lo(self, cache) -> int:
        """The global index of the cache's first kv head (the cache holds
        the rank's block of the padded kv heads, or all of them)."""
        c = cache["k"].shape[1]
        return 0 if c == self.kv_pad else self.live.index(self.axis) * c

    def for_q(self, t, lo: int, dim: int):
        """The kv heads this rank's q heads read, from ``t`` holding heads
        ``[lo, ...)`` along ``dim``: a block of whole GQA groups as a view
        (the decode kernel reads a cache's block in place), or one kv head
        per q head, copied, where the rank's q heads take unequal shares of
        their groups."""
        block = kv_block(self.lo, self.hq, self.group)
        if block is not None:
            return t.narrow(dim, block[0] - lo, block[1])
        ids = [(self.lo + j) // self.group - lo for j in range(self.hq)]
        return t.index_select(dim, torch.tensor(ids, device=t.device))

    def out(self, o, wo, dtype):
        """o ``[B, S, hq, hd]`` of this rank's padded heads -> the block's
        output: its real heads through their ``wo`` rows, the partial sums
        all-reduced."""
        if self.q_full:                       # wo replicated: the real rows
            real = max(0, min(self.hq, self.n_heads - self.lo))
            o, wo = o[:, :, :real], wo[self.lo:self.lo + real]
        return constrain(_out(o, wo, dtype), "batch", None, None,
                         partial="tp")


def _heads(params: "Attention"):
    rules = active_rules()
    if rules is None or rules.tp is None:
        return None
    n = rules.live.size(rules.tp)
    if n == 1 or padded_head_counts(params.n_heads, params.n_kv, n)[0] % n:
        return None
    return _Heads(rules, n, params)


def _pad_heads(t, n_pad: int):
    """``[B, S, H, hd]`` with zero heads appended up to ``n_pad``."""
    h = t.shape[2]
    if n_pad == h:
        return t
    return torch.nn.functional.pad(t, (0, 0, 0, n_pad - h))


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
    The cache is updated in place and returned.  Under active rules the
    rank's heads run (module docstring); its cache holds the kv heads its
    spec gives it."""
    if mode not in MODES:
        raise ValueError(f"attention mode {mode!r}; known: {MODES}")
    b, s, _ = x.shape
    tp = _heads(params)
    if tp is None:
        wq, wk, wv, wo = params.wq, params.wk, params.wv, params.wo
    else:
        x, wq, wk, wv, wo = tp.enter(x, params)
    q = _project(x, wq)
    k = _project(x, wk)
    v = _project(x, wv)
    k_lo = 0
    if tp is not None:
        q = tp.q_local(q)
        (k, k_lo), (v, _) = tp.kv_heads(k), tp.kv_heads(v)
    positions = _positions(cache_index, b, s, x.device)
    q = layers.rope(q, positions, rope_theta)
    k = layers.rope(k, positions, rope_theta)
    win = window if mode == SLIDING else 0

    def cache_heads(t):
        """The heads of k or v the cache holds."""
        if tp is None:
            return t
        c_lo = tp.cache_lo(cache)
        return t.narrow(2, c_lo - k_lo, cache["k"].shape[1])

    if cache_index is not None:
        if cache is None or s != 1:
            raise ValueError("decode needs a cache and one token per slot")
        idx = positions[:, 0]
        ck, cv = cache["k"], cache["v"]
        seq = _seq_block(ck.shape[2])
        _write_token(ck, cv, cache_heads(k)[:, 0], cache_heads(v)[:, 0], idx,
                     None if seq is None else seq[2])
        if tp is not None:
            c_lo = tp.cache_lo(cache)
            ck, cv = tp.for_q(ck, c_lo, 1), tp.for_q(cv, c_lo, 1)
        o = decode_cache(q[:, 0], ck, cv, (idx + 1).to(torch.int32),
                         softcap=softcap, window=win + 1 if win else 0,
                         seq=seq)[:, None]                # [B, 1, Hq, hd]
    else:
        if cache is not None:
            cache["k"][:, :, :s] = cache_heads(k).transpose(1, 2).to(
                cache["k"].dtype)
            cache["v"][:, :, :s] = cache_heads(v).transpose(1, 2).to(
                cache["v"].dtype)
        if tp is not None:
            k, v = tp.for_q(k, k_lo, 2), tp.for_q(v, k_lo, 2)
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=mode != BIDIR, window=win, softcap=softcap,
            prefix_len=prefix_len if mode == PREFIX else 0,
        ).transpose(1, 2)                                 # [B, S, Hq, hd]
    if tp is not None:
        return tp.out(o, wo, x.dtype), cache
    return _out(o, wo, x.dtype), cache


def decode_cache(q, ck, cv, valid_len, *, softcap=0.0, window=0, seq=None):
    """One decode step's attention, q ``[B, Hq, hd]``, over the cache this
    rank holds (``[B, Hkv, S_local, hd]``): ``ops.decode_attention`` over a
    whole cache; in a long-context decode (``seq``, :func:`_seq_block`; by
    default read from the active rules) the rank's block of global
    positions through ``ops.decode_attention_partial``, the blocks merged
    over the sequence axis (:func:`_merge_blocks`).  ``valid_len`` and
    ``window`` are on global positions."""
    if seq is None:
        seq = _seq_block(ck.shape[2])
    kw = dict(softcap=softcap, window=window)
    if seq is None:
        return ops.decode_attention(q, ck, cv, valid_len, **kw)
    return _merge_blocks(*ops.decode_attention_partial(
        q, ck, cv, valid_len, seq[2], **kw), seq, q.dtype)


def _seq_block(s_local: int):
    """Under active rules whose ``seq_axis`` splits the KV caches'
    sequence (a long-context decode): ``(live mesh, axis, first global
    position of this rank's rows)``, the rank at index ``i`` along the axis
    holding rows ``[i S_local, (i + 1) S_local)``; None otherwise."""
    rules = active_rules()
    if rules is None or rules.seq_axis is None:
        return None
    live = rules.live
    if live.size(rules.seq_axis) == 1:
        return None
    return live, rules.seq_axis, live.index(rules.seq_axis) * s_local


def _write_token(ck, cv, k_tok, v_tok, idx, lo) -> None:
    """The token's k/v ``[B, Hkv, hd]`` into the caches in place at
    positions ``idx``.  With ``lo`` (a long-context decode) the caches hold
    global rows ``[lo, lo + S_local)``: only the rank that holds a slot's
    position writes it, at local row ``idx - lo``; the others write that
    row's own values back (no host read of ``idx``)."""
    slots = torch.arange(ck.shape[0], device=ck.device)
    if lo is None:
        ck[slots, :, idx] = k_tok.to(ck.dtype)
        cv[slots, :, idx] = v_tok.to(cv.dtype)
        return
    s_local = ck.shape[2]
    local = idx - lo
    own = ((local >= 0) & (local < s_local))[:, None, None]
    row = local.clamp(0, s_local - 1)
    ck[slots, :, row] = torch.where(own, k_tok.to(ck.dtype), ck[slots, :, row])
    cv[slots, :, row] = torch.where(own, v_tok.to(cv.dtype), cv[slots, :, row])


def _merge_blocks(o, lse, seq, dtype):
    """The ranks' blocks of one decode merged over the sequence axis, in
    float32, rounded once to ``dtype``: one all-gather of each rank's ``(o,
    lse)`` (``[B, Hq, hd]`` and ``[B, Hq]``), then ``lse = logsumexp_r
    lse_r`` and ``o = sum_r exp(lse_r - lse) o_r`` in rank order (every
    rank computes the same sum).  A block with no admitted row has ``lse =
    -inf``: weight 0."""
    live, axis, _ = seq
    both = torch.cat([o, lse[..., None]], dim=-1)[None]   # [1, B, Hq, hd+1]
    every = mesh_lib.all_gather(both, live, axis, 0)
    o_r, lse_r = every[..., :-1], every[..., -1]
    total = torch.logsumexp(lse_r, dim=0)
    return (torch.exp(lse_r - total)[..., None] * o_r).sum(dim=0).to(dtype)


def _out(o, wo, dtype):
    """o ``[B, S, Hq, hd]`` @ wo ``[Hq, hd, d]`` -> ``[B, S, d]``."""
    b, s = o.shape[:2]
    hq, hd, d = wo.shape
    return o.reshape(b, s, hq * hd) @ wo.to(dtype).reshape(hq * hd, d)


def encode_cross_kv(enc_out, params: Attention) -> dict:
    """The encoder output ``[B, S_src, d]`` through a cross layer's ``wk``,
    ``wv`` (no rope) -> ``{"k", "v"}``, each ``[B, Hkv, S_src, hd]``: the
    flash and decode kernels' layout (the reference's is ``[B, S_src, Hkv,
    hd]``).  Under active rules, the kv heads this rank's q heads read."""
    tp = _heads(params)
    if tp is None:
        return {"k": _project(enc_out, params.wk).transpose(1, 2)
                .contiguous(),
                "v": _project(enc_out, params.wv).transpose(1, 2)
                .contiguous()}
    enc_out, _, wk, wv, _ = tp.enter(enc_out, params)
    out = {}
    for name, w in (("k", wk), ("v", wv)):
        t, lo = tp.kv_heads(_project(enc_out, w))
        out[name] = tp.for_q(t, lo, 2).transpose(1, 2).contiguous()
    return out


def cross_attention_block(x, params: Attention,
                          enc_kv: dict) -> torch.Tensor:
    """Decoder cross attention ``[B, S, d]`` -> ``[B, S, d]`` against the
    encoder's k/v (:func:`encode_cross_kv`), every source position
    admitted, no rope.  ``S`` queries run ``ops.flash_attention`` with no
    causal mask (against ``S_src`` keys); one query a slot (a decode step)
    runs ``ops.decode_attention`` with ``valid_len = S_src``."""
    tp = _heads(params)
    if tp is None:
        wq, wo = params.wq, params.wo
    else:
        x, wq, _, _, wo = tp.enter(x, params)
    q = _project(x, wq)                                   # [B, S, Hq, hd]
    if tp is not None:
        q = tp.q_local(q)
    k, v = enc_kv["k"], enc_kv["v"]
    if x.shape[1] == 1:
        o = ops.decode_attention(q[:, 0], k, v, k.shape[2])[:, None]
    else:
        o = ops.flash_attention(q.transpose(1, 2), k, v,
                                causal=False).transpose(1, 2)
    if tp is not None:
        return tp.out(o, wo, x.dtype)
    return _out(o, wo, x.dtype)


def init_kv_cache(batch: int, s_max: int, n_kv: int, head_dim: int, dtype,
                  device) -> dict:
    return {
        "k": torch.zeros((batch, n_kv, s_max, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_kv, s_max, head_dim), dtype=dtype,
                         device=device),
    }
