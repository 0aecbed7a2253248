"""Plain PyTorch versions of the port's kernels.

The keyed plane's four (segment sum, scatter-add, the two table lookups),
the serving path's two (flash attention for prefill, decode attention
against the KV cache), the flash backward of the training path (with the
forward's row log-sum-exp), the Mamba-2 chunked SSD scan and the MoE
gather, plus the MoE combine, which has no kernel.  Each function computes what its
CUDA kernel computes, on tensors of any device.  The wrappers take these for CPU
tensors; on the card only ``chip_smoke.py``, the GPU tests and ``ops``
mode ``"ref"`` use them.

Integer accumulators: ``segment_sum`` sums integers into int32 with
wraparound (the reference's i32 partials); ``scatter_add`` accumulates in
the table's own dtype (int64 for the window table's columns, int32 wrapping
when held against the reference's i32 kernel).  Ids outside ``[0, n)``
contribute nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: masked attention score, as in the reference's kernels
NEG_INF = -2.0e38


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), explicitly."""
    low = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(low >= 2 ** 31, low - 2 ** 32, low).to(torch.int32)


def _accumulate(out: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor):
    """``out[ids[r]] += rows[r]`` in place for ids in range; int32 outputs
    accumulate in int64 and wrap back."""
    n = out.shape[0]
    ids = ids.to(torch.int64)
    keep = (ids >= 0) & (ids < n)
    ids, rows = ids[keep], rows[keep]
    if out.dtype == torch.int32:
        wide = out.to(torch.int64)
        wide.index_put_((ids,), rows.to(torch.int64), accumulate=True)
        out.copy_(wrap_i32(wide))
    else:
        out.index_put_((ids,), rows.to(out.dtype), accumulate=True)
    return out


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_floating_point:
        return torch.float32
    return torch.int32


def segment_sum_ref(values, seg_ids, num_segments: int) -> torch.Tensor:
    """values ``[R, d]``; seg_ids ``[R]``; returns ``[S, d]`` in int32
    (integers, wrapping) or float32."""
    out = torch.zeros(
        (num_segments, values.shape[1]), dtype=_acc_dtype(values.dtype),
        device=values.device,
    )
    return _accumulate(out, seg_ids, values)


def segment_sum_sorted(values, seg_ids, num_segments: int) -> torch.Tensor:
    """Segment sum for **sorted** ids: prefix sum + gather, no scatter.

    ``P[k]`` is the running total of the first ``k`` rows; each segment is
    the difference of the prefix rows at its end and at its start
    (``searchsorted``).  Integers sum in int64 and wrap to int32, which
    gives the same values as the reference's int32 prefix with wraparound.
    Ids outside ``[0, num_segments)`` sort to the head or the tail and drop
    out, as in the kernels (the reference's realization, defined for ids in
    ``[0, S]``, would fold negative ids into segment 0).
    PRECONDITION, not checked: unsorted ids give wrong sums."""
    d = values.shape[1]
    acc = _acc_dtype(values.dtype)
    wide = torch.float32 if acc == torch.float32 else torch.int64
    zero = torch.zeros((1, d), dtype=wide, device=values.device)
    prefix = torch.cat([zero, torch.cumsum(values.to(wide), dim=0)])
    ids = seg_ids.contiguous()
    segs = torch.arange(num_segments, dtype=ids.dtype, device=ids.device)
    starts = torch.searchsorted(ids, segs)
    ends = torch.searchsorted(ids, segs, right=True)
    out = prefix[ends] - prefix[starts]
    return wrap_i32(out) if acc == torch.int32 else out


def table_acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator of a scatter-add into a table of ``dtype``: int64 stays
    int64, other integers int32, floats float32."""
    return torch.int64 if dtype == torch.int64 else _acc_dtype(dtype)


def scatter_add_ref(table, ids, rows) -> torch.Tensor:
    """``out = table.clone(); out[ids[r]] += rows[r]`` in the table's own
    accumulator (:func:`table_acc_dtype`)."""
    acc = table_acc_dtype(table.dtype)
    return scatter_add_ref_(table.to(acc).clone(), ids, rows)


def scatter_add_ref_(table, ids, rows) -> torch.Tensor:
    """In-place form of :func:`scatter_add_ref` (the table's dtype)."""
    return _accumulate(table, ids, rows)


def table_lookup_ref(cell_keys, cell_starts, table_keys, table_starts,
                     table_occ, max_probes: int) -> torch.Tensor:
    """Row of each ``(key, start)`` cell in one table of ``capacity =
    len(table_keys)`` rows: the first row of the cell's probe window, in
    probe order, that is occupied and holds the cell; int32 ``[n]`` with
    ``capacity`` = miss.  :func:`batched_table_lookup_ref` with one
    shard."""
    return batched_table_lookup_ref(
        None, cell_keys, cell_starts, table_keys, table_starts, table_occ,
        table_keys.shape[0], max_probes,
    )


def batched_table_lookup_ref(cell_owners, cell_keys, cell_starts,
                             table_keys, table_starts, table_occ,
                             capacity: int, max_probes: int) -> torch.Tensor:
    """Global row of each ``(owner, key, start)`` cell in ``n_w`` stacked
    segments of ``capacity`` rows; int32 ``[n]`` with ``n_rows`` = miss.

    The cell's home is ``h = cell_hash(key, start, capacity)``; its
    candidates are ``owner * capacity + (h + p) % capacity`` for ``p`` in
    ``0 .. max_probes - 1``; the result is the first candidate in probe
    order that is occupied and whose key and start equal the cell's (the
    CUDA kernel's function, ``csrc/hash_table.cu``).  ``cell_owners`` None
    means owner 0; an owner outside ``[0, n_rows / capacity)`` has no
    segment and misses, as in the reference.
    Under the table's invariant this is the least matching row of the whole
    table, the reference's full-scan result; on a table that breaks it the
    two differ."""
    # the keyed package imports this module: take its hash at call time
    from repro_torch.keyed.table import cell_hash

    n, total = cell_keys.shape[0], table_keys.shape[0]
    dev = cell_keys.device
    if not n or not total:
        return torch.full((n,), total, dtype=torch.int32, device=dev)
    p = torch.arange(max_probes, dtype=torch.int64, device=dev)
    cand = torch.remainder(
        cell_hash(cell_keys, cell_starts, capacity)[:, None] + p, capacity)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    if cell_owners is not None:
        owners = cell_owners.to(torch.int64)
        live = (owners >= 0) & (owners < total // capacity)
        cand = cand + torch.where(live, owners, 0)[:, None] * capacity
    m = table_occ[cand].to(torch.bool) & live[:, None] \
        & (table_keys[cand] == cell_keys[:, None]) \
        & (table_starts[cand] == cell_starts[:, None])
    rows = cand.gather(1, m.to(torch.uint8).argmax(dim=1)[:, None])[:, 0]
    return torch.where(m.any(dim=1), rows, total).to(torch.int32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _masked_softmax_pv(s, mask, vf, out_dtype):
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                        device=s.device))
    p = torch.softmax(s, dim=-1)
    return (p @ vf).to(out_dtype)


def _flash_scores(q, k, causal, window, softcap, prefix_len):
    """Float32 scores ``[B, Hq, Sq, Skv]`` (scaled, soft-capped), k with its
    heads repeated to q's, and the mask ``[Sq, Skv]`` of the admitted
    pairs."""
    hq, hkv, sq, skv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    g = hq // hkv
    kf = k.float().repeat_interleave(g, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= (k_pos <= q_pos) | (k_pos < prefix_len)
    if window:
        mask &= k_pos > q_pos - window
    return s, kf, mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        prefix_len=0):
    """q ``[B, Hq, Sq, hd]``; k, v ``[B, Hkv, Skv, hd]`` -> like q.

    Float32 math; GQA maps q head ``h`` to kv head ``h // (Hq // Hkv)``;
    the mask keeps ``k <= q or k < prefix_len`` (causal; the prefix-LM
    mask when ``prefix_len > 0``) and ``k > q - window`` (window), with
    query and key positions both counted from 0.  A row that admits no key
    gets the mean of V over all keys (its scores are all -2e38)."""
    s, _, mask = _flash_scores(q, k, causal, window, softcap, prefix_len)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return _masked_softmax_pv(s, mask, vf, q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, window=0, softcap=0.0,
                            prefix_len=0):
    """Each row's log-sum-exp ``[B, Hq, Sq]`` float32 of its admitted
    scores (natural log), +inf for a row that admits no key: what the
    forward kernel writes into ``lse``."""
    s, _, mask = _flash_scores(q, k, causal, window, softcap, prefix_len)
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.where(mask.any(dim=-1), lse,
                       torch.full((), math.inf, device=q.device))


def flash_attention_backward_ref(q, k, v, o, lse, dout, *, causal=True,
                                 window=0, softcap=0.0, prefix_len=0):
    """The plain version of the backward kernels, written out from their
    formulas on dense float32 scores: ``P = exp(s - lse)`` on admitted
    pairs (0 elsewhere and on rows with ``lse = +inf``), ``D =
    rowsum(dO o O)``, ``dS = P o (dO.V^T - D)`` times ``1 - (s / c)^2``
    under a softcap ``c``, ``dV = P^T.dO``, ``dK = dS^T.Q / sqrt(hd)``,
    ``dQ = dS.K / sqrt(hd)``; a kv head's dK, dV sum over its group's q
    heads.  Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    s, kf, mask = _flash_scores(q, k, causal, window, softcap, prefix_len)
    vf = v.float().repeat_interleave(g, dim=1)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    dof = dout.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    if softcap:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    dv = p.transpose(-1, -2) @ dof
    dk = dk.reshape(b, hkv, g, skv, hd).sum(dim=2)
    dv = dv.reshape(b, hkv, g, skv, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The bf16 backward kernels' tile plan by head_dim (BwdPlan of
# csrc/flash_attention_backward.cu): a dK/dV block's own kv rows, its
# warpgroups' first own rows and dK/dV column ranges, the streamed q tile;
# a dQ block's own q rows (two warpgroups of 64) and streamed kv tile.
_WG_PLAN = {
    hd: dict(kv_own=128, kv_wg=(0, 64), cols=((0, hd),), q_tile=64,
             q_own=128, kv_tile=64) for hd in (64, 128)}
_WG_PLAN[256] = dict(kv_own=64, kv_wg=(0,), cols=((0, 128), (128, 256)),
                     q_tile=64, q_own=128, kv_tile=32)
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _kv_range(q0, q_last, skv, causal, window, prefix):
    """attention_common.cuh's kv_range: the keys some row of ``[q0,
    q_last]`` admits, ``[lo, hi)``."""
    hi = min(skv, max(q_last + 1, prefix)) if causal else skv
    return (max(0, q0 - window + 1) if window > 0 else 0), hi


def _q_range(k0, k_last, sq, causal, window, prefix):
    """attention_common.cuh's q_range: the query rows some key of ``[k0,
    k_last]`` is admitted by, ``[lo, hi)``."""
    lo = min(k0, sq) if causal and k0 >= prefix else 0
    return lo, (min(sq, k_last + window) if window > 0 else sq)


def _tile_admitted(q0, q_last, k0, k_last, sq, skv, causal, window, prefix):
    """attention_common.cuh's tile_admitted: every pair of the tile is
    admitted, inside Sq and Skv."""
    whole = q_last < sq and k_last < skv
    if causal:
        whole = whole and (k_last <= q0 or k_last < prefix)
    if window > 0:
        whole = whole and k0 > q_last - window
    return whole


def _bf16_parts(x, split):
    """The bf16 operands a kernel's product takes for float32 ``x``:
    ``[bf16(x), bf16(x - bf16(x))]`` split, ``[bf16(x)]`` not, as float32."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def flash_attention_backward_wgmma_model(q, k, v, o, lse, dout, *,
                                         causal=True, window=0, softcap=0.0,
                                         prefix_len=0, split_p=True,
                                         split_ds=True, head_splits=None):
    """A CPU model of the bf16 backward kernels' arithmetic
    (``flash_bwd_dkdv_wgmma``, ``flash_bwd_dq_wgmma``): their tile plan by
    head_dim (at 256: 64-row dK/dV blocks whose two warpgroups each take
    128 of dK's and dV's columns, 32-row kv tiles in dQ), ranges, skipped
    tiles and per-element mask on the tiles that cross an edge; bf16
    operands (the inputs are rounded to bf16 first); P and dS rounded to
    bf16 for the products that read them, each split into ``bf16(x) +
    bf16(x - bf16(x))`` (two products) when ``split_p`` / ``split_ds``;
    float32 scores and sums; at head_dim 256 the group's q heads split over
    ``head_splits`` blocks (default: the wrapper's
    :func:`~repro_torch.kernels.flash_attention.head_splits` on an H100),
    whose float32 dK/dV partials are added in split order; each gradient
    rounded once to bf16.  Returns ``(dq, dk, dv)`` in bf16.  Not on any
    path: the tests hold it against :func:`flash_attention_backward_ref` and
    the JAX package to show what the roundings cost."""
    from repro_torch.kernels.flash_attention import head_splits as splits_of

    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    plan = _WG_PLAN[hd]
    kv_own, q_tile = plan["kv_own"], plan["q_tile"]
    q_own, kv_tile = plan["q_own"], plan["kv_tile"]
    if head_splits is None:
        head_splits = splits_of(b, hq, hkv, skv, hd, torch.bfloat16)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    mask_args = (causal, window, prefix_len)
    qf, kf, vf, of, dof = (t.to(torch.bfloat16).float()
                           for t in (q, k, v, o, dout))
    # the streamed and own tiles read TMA's zero fill past Sq and Skv
    pad_q = (-sq) % q_own + q_own
    pad_k = (-skv) % 128 + 128
    qp, dop = (F.pad(t, (0, 0, 0, pad_q)) for t in (qf, dof))
    kp, vp = (F.pad(t, (0, 0, 0, pad_k)) for t in (kf, vf))
    lse_p = F.pad(lse.float(), (0, pad_q), value=math.inf)
    delta = F.pad((dof * of).sum(dim=-1), (0, pad_q))

    def p_and_ds(s, dp, lse_t, d_t, ok):
        """P and dS of a tile whose rows hold lse_t, d_t (broadcast), as
        the kernels take them: P = exp2(x log2(e) - lse log2(e))."""
        lse2 = lse_t * _LOG2E
        if softcap:
            t = torch.tanh(s * scale * (1.0 / softcap))
            p = torch.exp2(softcap * t * _LOG2E - lse2)
            ds = p * (dp - d_t) * (1.0 - t * t)
        else:
            p = torch.exp2(s * (scale * _LOG2E) - lse2)
            ds = p * (dp - d_t)
        return torch.where(ok, p, 0.0), torch.where(ok, ds, 0.0)

    def tile_mask(q0, nq, k0, nk):
        """[nq q rows, nk keys]: the per-element mask, or all of it on a
        tile that tile_admitted passes whole."""
        if _tile_admitted(q0, q0 + nq - 1, k0, k0 + nk - 1, sq, skv,
                          *mask_args):
            return torch.ones((nq, nk), dtype=torch.bool)
        qi = torch.arange(q0, q0 + nq)[:, None]
        kj = torch.arange(k0, k0 + nk)[None, :]
        ok = (qi < sq) & (kj < skv)
        if causal:
            ok &= (kj <= qi) | (kj < prefix_len)
        if window > 0:
            ok &= kj > qi - window
        return ok

    def product(x, split, b_op):
        return sum(part @ b_op for part in _bf16_parts(x, split))

    dq = torch.zeros((b, hq, sq + pad_q, hd))
    # dK and dV: one float32 partial per head split
    dk = torch.zeros((head_splits, b, hkv, skv + pad_k, hd))
    dv = torch.zeros_like(dk)
    heads = g // head_splits
    for bi in range(b):
        for hk in range(hkv):
            # dK/dV: a block of kv_own kv rows streams its split's q heads
            # times the q tiles its rows admit; a warpgroup skips the tiles
            # its own 64 rows' range does not reach, and adds to dK and dV
            # over its columns
            for k0 in range(0, skv, kv_own):
                lo, hi = _q_range(k0, min(k0 + kv_own, skv) - 1, sq,
                                  *mask_args)
                q_tiles = range(lo // q_tile * q_tile, hi, q_tile)
                for ka in (k0 + off for off in plan["kv_wg"]):
                    if ka >= skv:
                        continue
                    wlo, whi = _q_range(ka, min(ka + 63, skv - 1), sq,
                                        *mask_args)
                    kt, vt = kp[bi, hk, ka:ka + 64], vp[bi, hk, ka:ka + 64]
                    for split in range(head_splits):
                        h0 = hk * g + split * heads
                        for h in range(h0, h0 + heads):
                            for q0 in q_tiles:
                                if not (q0 < whi and q0 + q_tile > wlo):
                                    continue
                                qt = qp[bi, h, q0:q0 + q_tile]
                                dot = dop[bi, h, q0:q0 + q_tile]
                                p, ds = p_and_ds(
                                    kt @ qt.T, vt @ dot.T,
                                    lse_p[bi, h, q0:q0 + q_tile][None, :],
                                    delta[bi, h, q0:q0 + q_tile][None, :],
                                    tile_mask(q0, q_tile, ka, 64).T)
                                for c0, c1 in plan["cols"]:
                                    dv[split, bi, hk, ka:ka + 64, c0:c1] += \
                                        product(p, split_p, dot[:, c0:c1])
                                    dk[split, bi, hk, ka:ka + 64, c0:c1] += \
                                        product(ds, split_ds, qt[:, c0:c1])
        for h in range(hq):
            hk = h // g
            # dQ: a block of q_own q rows streams the kv tiles its rows
            # admit
            for q0 in range(0, sq, q_own):
                lo, hi = _kv_range(q0, min(q0 + q_own, sq) - 1, skv,
                                   *mask_args)
                k_tiles = range(lo // kv_tile * kv_tile, hi, kv_tile)
                for qa in (q0, q0 + 64):
                    if qa >= sq:
                        continue
                    wlo, whi = _kv_range(qa, min(qa + 63, sq - 1), skv,
                                         *mask_args)
                    qt, dot = qp[bi, h, qa:qa + 64], dop[bi, h, qa:qa + 64]
                    for k0 in k_tiles:
                        if not (k0 < whi and k0 + kv_tile > wlo):
                            continue
                        kt = kp[bi, hk, k0:k0 + kv_tile]
                        vt = vp[bi, hk, k0:k0 + kv_tile]
                        _, ds = p_and_ds(
                            qt @ kt.T, dot @ vt.T,
                            lse_p[bi, h, qa:qa + 64][:, None],
                            delta[bi, h, qa:qa + 64][:, None],
                            tile_mask(qa, 64, k0, kv_tile))
                        dq[bi, h, qa:qa + 64] += product(ds, split_ds, kt)
    # the partials added in split order (flash_bwd_dkdv_sum)
    dk_sum, dv_sum = dk[0], dv[0]
    for split in range(1, head_splits):
        dk_sum = dk_sum + dk[split]
        dv_sum = dv_sum + dv[split]
    bf = torch.bfloat16
    return ((dq[:, :, :sq] * scale).to(bf),
            (dk_sum[:, :, :skv] * scale).to(bf), dv_sum[:, :, :skv].to(bf))


def _decode_scores(q, cache_k, cache_v, valid_len, pos0, softcap, window):
    """A decode's float32 scores ``[B, Hq, S]`` (scaled, soft-capped), V
    with its heads repeated to q's, and the admitted positions ``[B, Hq,
    S]``: ``pos0 + r < valid_len`` and, with a window, ``> valid_len -
    window``."""
    b, hq, hd = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    g = hq // hkv
    kf = cache_k.float().repeat_interleave(g, dim=1)
    vf = cache_v.float().repeat_interleave(g, dim=1)
    s = (q.float()[:, :, None, :] @ kf.transpose(-1, -2))[:, :, 0] \
        / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1, 1)
    pos = pos0 + torch.arange(s_len, device=q.device)[None, None, :]
    mask = (pos < valid).expand(b, hq, s_len)
    if window:
        mask = mask & (pos > valid - window)
    return s, vf, mask


def decode_attention_ref(q, cache_k, cache_v, valid_len, *, softcap=0.0,
                         window=0):
    """q ``[B, Hq, hd]``; cache ``[B, Hkv, S, hd]``; ``valid_len`` a scalar
    or ``[B]`` (one length per slot) -> ``[B, Hq, hd]``.

    Position ``p`` of row ``b`` is attended when ``p < valid_len[b]`` and,
    with a window, ``p > valid_len[b] - window``.  Float32 math."""
    s, vf, mask = _decode_scores(q, cache_k, cache_v, valid_len, 0, softcap,
                                 window)
    return _masked_softmax_pv(s[:, :, None, :], mask[:, :, None, :], vf,
                              q.dtype)[:, :, 0]


def decode_attention_partial_ref(q, cache_k, cache_v, valid_len, pos0: int,
                                 *, softcap=0.0, window=0):
    """The decode over a block of global positions: cache ``[B, Hkv, S,
    hd]`` holds positions ``[pos0, pos0 + S)``; position ``pos0 + r`` of
    row ``b`` is attended when below ``valid_len[b]`` and, with a window,
    above ``valid_len[b] - window`` -> ``(o, lse)``, float32 ``[B, Hq,
    hd]`` and ``[B, Hq]``: the block's softmax-weighted V and the
    log-sum-exp of its scaled (soft-capped) scores; a row with no admitted
    position gets ``o = 0`` and ``lse = -inf``.  Blocks merge as ``lse =
    logsumexp_r lse_r``, ``o = sum_r exp(lse_r - lse) o_r``."""
    s, vf, mask = _decode_scores(q, cache_k, cache_v, valid_len, pos0,
                                 softcap, window)
    m = torch.where(mask, s, float("-inf")).amax(dim=-1)  # [B, Hq]
    p = torch.where(mask, torch.exp(s - torch.where(
        torch.isfinite(m), m, 0.0)[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = (p[:, :, None, :] @ vf)[:, :, 0] / l.clamp_min(1e-37)[..., None]
    return o, m + torch.log(l)


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan
# ---------------------------------------------------------------------------

#: the decays' clip, as in the reference's chunked formulation and kernel
SSD_CLIP = -60.0


def _clip_exp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(t.clamp(SSD_CLIP, 0.0))


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """x ``[B, H, S, P]``; dt ``[B, H, S]`` (softplus'd, float32); A ``[H]``
    (negative); Bm, Cm ``[B, H, S, N]`` -> (y like x, final h ``[B, H, N,
    P]`` float32), from a zero state.

    The chunked formulation of ``repro/kernels/ssd_scan.py`` in float32:
    within a chunk ``y = (C B^T o L)(x dt) + C exp(cum) h``, across chunks
    ``h <- h exp(total) + sum_j exp(total - cum_j) B_j x_j dt_j``, every
    decay clipped to ``[-60, 0]``.  Any S: the tail is padded with
    ``dt = 0``, which leaves the state unchanged.  The chunk changes the
    result only through the clip (below ``exp(-60)``) and rounding.  Inputs
    may be strided views (an expanded ``[B, H, S, N]`` of one shared B/C
    group, a transposed ``[B, S, H, P]``)."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    nc = (s + pad) // c
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    xc = (xf * dtf[..., None]).reshape(b, h, nc, c, p)
    Bc = Bf.reshape(b, h, nc, c, n)
    Cc = Cf.reshape(b, h, nc, c, n)
    cum = torch.cumsum((dtf * A.float()[None, :, None]).reshape(b, h, nc, c),
                       dim=-1)
    total = cum[..., -1]                                   # [b, h, nc]
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tril, _clip_exp(cum[..., :, None] - cum[..., None, :]),
                        torch.zeros((), device=x.device))
    y = ((Cc @ Bc.transpose(-1, -2)) * decay) @ xc         # [b, h, nc, c, p]
    states = (Bc * _clip_exp(total[..., None] - cum)[..., None]) \
        .transpose(-1, -2) @ xc                            # [b, h, nc, n, p]
    hs = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    h_prev = []
    for k in range(nc):
        h_prev.append(hs)
        hs = hs * _clip_exp(total[..., k])[..., None, None] + states[:, :, k]
    y = y + (Cc * _clip_exp(cum)[..., None]) @ torch.stack(h_prev, dim=2)
    return y.reshape(b, h, nc * c, p)[:, :, :s].to(x.dtype), hs


def ssd_scan_sequential(x, dt, A, Bm, Cm):
    """The same scan as a recurrence over positions, float32, without the
    clip: the small-size oracle (the reference's ``ref.ssd_scan_ref``)."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    hs = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, :, t] * A.float()[None, :])
        hs = hs * dA[..., None, None] + Bf[:, :, t, :, None] \
            * (xf[:, :, t] * dtf[:, :, t, None])[:, :, None, :]
        ys.append((Cf[:, :, t, :, None] * hs).sum(dim=2))
    return torch.stack(ys, dim=2).to(x.dtype), hs


def _clip_grad_mask(t: torch.Tensor) -> torch.Tensor:
    """Where the clip to ``[-60, 0]`` passes a gradient (autograd's clamp:
    both ends included)."""
    return (t >= SSD_CLIP) & (t <= 0.0)


def ssd_scan_backward_ref(x, dt, A, Bm, Cm, dy, dh_final=None, *,
                          chunk: int = 256):
    """The gradients ``(dx, ddt, dA, dB, dC)`` of :func:`ssd_scan_ref`'s
    outputs ``(y, h)`` for their gradients ``dy`` ``[B, H, S, P]`` and
    ``dh_final`` ``[B, H, N, P]`` (None: zero), by explicit formulas in
    float32, chunk by chunk (no autograd).  Bm, Cm ``[B, G, S, N]`` with
    ``G = 1`` (one group read by every head) or ``G = H``; dB and dC come
    back in that layout, a group's heads summed.  dx, dB, dC take their
    input's dtype; ddt ``[B, H, S]`` and dA ``[H]`` are float32.

    Per chunk (positions i, j; ``u = x dt``; ``cum`` the running sum of
    ``dt A``; ``e_i = exp(cum_i)``, ``w_j = exp(total - cum_j)``, ``L_ij =
    exp(cum_i - cum_j)`` for ``j <= i``, each clipped to ``[-60, 0]``):

    * the state's gradient passes backwards from the last chunk:
      ``g_{k-1} = exp(total_k) g_k + sum_i e_i C_i dy_i^T``, ``g_last =
      dh_final``;
    * ``du_j = sum_i (C_i . B_j) L_ij dy_i + w_j g_k^T B_j``; ``dC_i =
      sum_j L_ij (dy_i . u_j) B_j + e_i h_{k-1} dy_i``; ``dB_j = sum_i
      L_ij (dy_i . u_j) C_i + w_j g_k u_j``, with ``h_{k-1}`` the state
      entering the chunk;
    * the gradient of ``cum`` collects the decays' (each zero where its
      clip is active), the last position taking ``total``'s; a reverse
      running sum inside the chunk turns it into that of ``dt A``, whence
      ``ddt`` (with ``du . x``) and ``dA``."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    nc = (s + pad) // c

    def chunks(t, last):
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0, 0, pad) if last else (0, pad))
        return t.reshape(b, h, nc, c, *((t.shape[-1],) if last else ()))

    xc, dtc, dyc = chunks(x, True), chunks(dt, False), chunks(dy, True)
    Bc = chunks(Bm.expand(b, h, s, n), True)
    Cc = chunks(Cm.expand(b, h, s, n), True)
    Af = A.float()[None, :, None, None]
    uc = xc * dtc[..., None]
    cum = torch.cumsum(dtc * Af, dim=-1)                   # [b, h, nc, c]
    total = cum[..., -1]                                   # [b, h, nc]
    e, w, dec = _clip_exp(cum), _clip_exp(total[..., None] - cum), \
        _clip_exp(total)
    # the states entering each chunk, as the forward passes them
    states = (Bc * w[..., None]).transpose(-1, -2) @ uc    # [b, h, nc, n, p]
    hs = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    h_prev = []
    for k in range(nc):
        h_prev.append(hs)
        hs = hs * dec[..., k, None, None] + states[:, :, k]
    h_prev = torch.stack(h_prev, dim=2)
    # the state's gradient, from the last chunk back
    q = (Cc * e[..., None]).transpose(-1, -2) @ dyc        # [b, h, nc, n, p]
    g = torch.zeros_like(hs) if dh_final is None else dh_final.float()
    g_out = [None] * nc
    for k in reversed(range(nc)):
        g_out[k] = g
        g = g * dec[..., k, None, None] + q[:, :, k]
    g_out = torch.stack(g_out, dim=2)
    # inside each chunk
    v = cum[..., :, None] - cum[..., None, :]              # [.., i, j]
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    zero = torch.zeros((), device=x.device)
    L = torch.where(tril, _clip_exp(v), zero)
    Lg = torch.where(tril & _clip_grad_mask(v), L, zero)
    G = Cc @ Bc.transpose(-1, -2)                          # C_i . B_j
    dyu = dyc @ uc.transpose(-1, -2)                       # dy_i . u_j
    bg = Bc @ g_out                                        # [.., c, p]
    du = (G * L).transpose(-1, -2) @ dyc + w[..., None] * bg
    dyh = dyc @ h_prev.transpose(-1, -2)                   # [.., c, n]
    dC = (L * dyu) @ Bc + e[..., None] * dyh
    dB = (L * dyu).transpose(-1, -2) @ Cc \
        + w[..., None] * (uc @ g_out.transpose(-1, -2))
    M = G * dyu * Lg
    dw = (bg * uc).sum(-1)
    wg = torch.where(_clip_grad_mask(total[..., None] - cum), w, zero) * dw
    dcum = M.sum(-1) - M.sum(-2) - wg + torch.where(
        _clip_grad_mask(cum), e, zero) * (Cc * dyh).sum(-1)
    dcum[..., -1] += wg.sum(-1) + torch.where(
        _clip_grad_mask(total), dec, zero) * (h_prev * g_out).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    dx = du * dtc[..., None]
    ddt = (du * xc).sum(-1) + da * Af
    dA = (da * dtc).sum((0, 2, 3))

    def unchunk(t, dtype, groups=h):
        t = t.reshape(b, h, nc * c, *t.shape[4:])[:, :, :s]
        if groups == 1:
            t = t.sum(1, keepdim=True)
        return t.to(dtype)

    return (unchunk(dx, x.dtype), unchunk(ddt, torch.float32), dA,
            unchunk(dB, Bm.dtype, Bm.shape[1]),
            unchunk(dC, Cm.dtype, Cm.shape[1]))


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------

def moe_gather_ref(x, row_token) -> torch.Tensor:
    """x ``[T, d]``; row_token ``[R]`` -> ``[R, d]`` with ``out[r] =
    x[row_token[r]]``; a token outside ``[0, T)`` (the dummy ``T``) gives a
    zero row."""
    t = x.shape[0]
    tok = row_token.to(torch.int64)
    ok = (tok >= 0) & (tok < t)
    out = x[torch.where(ok, tok, 0)] if t else x.new_zeros(
        (len(tok), x.shape[1]))
    return torch.where(ok[:, None], out, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def token_rows_table(row_token, num_tokens: int,
                     max_rows_per_token: int) -> torch.Tensor:
    """``[num_tokens, max(k, 1)]`` int64: ``table[t, j]`` is the buffer
    index of token ``t``'s ``j``-th row in buffer order, or ``R`` (no row);
    ``k = max_rows_per_token`` bounds a token's rows and drops the rest.
    Rows of a token outside ``[0, num_tokens)`` appear nowhere.  Index
    preparation (a stable sort by token, then positions), shared by the
    combine and the gather's backward; the plain version of the
    ``moe_token_table`` kernel (``moe_dispatch.token_rows_table``)."""
    r = row_token.shape[0]
    dev = row_token.device
    if dev.type == "meta":
        # the table's shape is static; bincount has no meta kernel, and a
        # meta tensor (the dry-run's) holds no entries to compute
        return torch.empty((num_tokens, max(max_rows_per_token, 1)),
                           dtype=torch.int64, device=dev)
    tok = row_token.to(torch.int64)
    tok = torch.where((tok >= 0) & (tok < num_tokens), tok, num_tokens)
    order = torch.sort(tok, stable=True).indices
    t_sorted = tok[order]
    counts = torch.bincount(t_sorted, minlength=num_tokens + 1)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(r, device=dev) - start[t_sorted]
    # the dummy token's row and a spare last column take what the bound
    # drops
    table = torch.full((num_tokens + 1, max(max_rows_per_token, 1) + 1), r,
                       dtype=torch.int64, device=dev)
    table[t_sorted, pos.clamp(max=table.shape[1] - 1)] = order
    return table[:num_tokens, :-1]


def moe_combine_ref(expert_out, row_token, row_weight, num_tokens: int, *,
                    max_rows_per_token: int, table=None) -> torch.Tensor:
    """expert_out ``[R, d]``; ``y[t] = sum_{r: row_token[r] == t} w_r *
    expert_out[r]`` for ``t < num_tokens`` (rows of other tokens drop) ->
    ``[num_tokens, d]`` in expert_out's dtype.

    Accumulates in float32 in a fixed order and rounds once: each token
    sums its rows in the order of their buffer index, so two runs give the
    same bits on any device (a bfloat16 ``index_add_`` on the card adds in
    the atomics' order).  ``max_rows_per_token`` bounds the rows of one
    token (``top_k`` in the model).  ``table``: the rows'
    :func:`token_rows_table` (int64 or int32), built here when None."""
    d = expert_out.shape[1]
    if table is None:
        table = token_rows_table(row_token, num_tokens, max_rows_per_token)
    rows = torch.cat([expert_out.float() * row_weight.float()[:, None],
                      expert_out.new_zeros((1, d), dtype=torch.float32)])
    y = torch.zeros((num_tokens, d), dtype=torch.float32,
                    device=expert_out.device)
    for j in range(table.shape[1]):
        y += rows[table[:, j]]
    return y.to(expert_out.dtype)


def moe_gather_backward_ref(dout, row_token, num_tokens: int, *,
                            max_rows_per_token: int,
                            table=None) -> torch.Tensor:
    """The gradient of :func:`moe_gather_ref` for its output's gradient
    ``dout`` ``[R, d]``: ``dx[t] = sum_{r: row_token[r] == t} dout[r]``
    for ``t < num_tokens`` -> ``[num_tokens, d]`` of dout's dtype, each
    token's at most ``max_rows_per_token`` rows summed in buffer order in
    float32 and rounded once (the combine with unit weights); dummy rows
    give nothing.  ``table`` as for :func:`moe_combine_ref`."""
    return moe_combine_ref(dout, row_token,
                           torch.ones((), device=dout.device)
                           .expand(dout.shape[0]), num_tokens,
                           max_rows_per_token=max_rows_per_token, table=table)
