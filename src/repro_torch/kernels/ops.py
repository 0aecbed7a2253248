"""Dispatch layer: CUDA kernel for CUDA tensors, plain PyTorch for CPU ones.

Port of ``repro/kernels/ops.py``: the keyed plane's four kernels, the
serving path's two attention kernels, the Mamba-2 SSD scan and the MoE
gather; the MoE combine has no kernel and takes its plain version on every
device, as in the reference.
``use_kernels(mode)`` sets the dispatch globally:

* ``"auto"`` (default): a CUDA tensor launches the kernel, a CPU tensor
  takes the plain version;
* ``"kernel"``: the kernel, and a CPU tensor raises;
* ``"ref"``: the plain version on whatever device the tensors live
  (``chip_smoke.py`` and the tests use it to hold the kernels against
  their plain versions on the card).

There is no fallback: a CUDA tensor in ``auto`` mode gets the kernel or an
exception.  The wrappers count their launches (:func:`launch_counts`).

Gradients (training): on the CPU, and in mode ``"ref"``, every function is
plain PyTorch, which autograd differentiates.  Where the kernels run,
:func:`flash_attention`, :func:`ssd_scan` and :func:`moe_gather` are
``torch.autograd.Function`` classes whose backwards are hand-written backward
kernels; :func:`moe_combine` is plain PyTorch in every mode (as the
reference's jnp combine), which autograd differentiates.  Only
:func:`decode_attention`, which serving alone calls, has no backward: it
raises ``NotImplementedError`` when grad mode is on and an input requires
grad, rather than return an output without a gradient.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _dk
from repro_torch.kernels import flash_attention as _fk
from repro_torch.kernels import hash_table as _ht
from repro_torch.kernels import moe_dispatch as _mk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import segment_reduce as _sr
from repro_torch.kernels import ssd_scan as _sk

MODES = ("auto", "kernel", "ref")
_MODE = "auto"


def use_kernels(mode: str) -> None:
    global _MODE
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _MODE = mode


def kernels_active(device) -> bool:
    """True when tensors on ``device`` dispatch to the CUDA kernels."""
    dev = torch.device(device)
    if _MODE == "ref":
        return False
    if _MODE == "kernel":
        if dev.type != "cuda":
            raise RuntimeError(f"ops mode 'kernel' needs CUDA tensors, got {dev}")
        return True
    return dev.type == "cuda"


_COUNTERS = (_sr.LAUNCHES, _ht.LAUNCHES, _fk.LAUNCHES, _dk.LAUNCHES,
             _sk.LAUNCHES, _mk.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


def _requires_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    """Raise when a kernel without a backward would cut a gradient."""
    if _requires_grad(*tensors):
        raise NotImplementedError(
            f"ops.{name} has no backward kernel (it serves decoding, which "
            f"needs none); with grad enabled on an input that requires grad "
            f"its output would silently carry no gradient.  Run it under "
            f"torch.no_grad(), on the CPU or in ops mode 'ref'")


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).contiguous()


def segment_sum(values, seg_ids, num_segments: int) -> torch.Tensor:
    """Per-segment sums (int32 wrapping for integers, float32 for floats),
    order-blind in every mode."""
    if kernels_active(values.device):
        acc = torch.float32 if values.dtype.is_floating_point else torch.int32
        return _sr.segment_sum(values.to(acc).contiguous(), _i32(seg_ids),
                               num_segments)
    return _ref.segment_sum_ref(values, seg_ids, num_segments)


def segment_sum_sorted(values, seg_ids, num_segments: int) -> torch.Tensor:
    """Segment sums for ids already sorted ascending (the keyed layer
    sorts first).  PRECONDITION, not checked (a check costs a reduction and
    a host sync): unsorted ids give wrong sums.  CUDA tensors take the
    single-pass reduce-by-key kernel (one launch, no zeroing); the plain
    path is the scatter-free prefix-sum realization."""
    if kernels_active(values.device):
        acc = torch.float32 if values.dtype.is_floating_point else torch.int32
        return _sr.segment_sum_sorted(values.to(acc).contiguous(),
                                      _i32(seg_ids), num_segments)
    return _ref.segment_sum_sorted(values, seg_ids, num_segments)


def scatter_add_(table, ids, rows) -> torch.Tensor:
    """``table[ids[r]] += rows[r]`` in place, accumulating in the table's
    dtype (the window table's int64 columns accumulate exactly)."""
    if kernels_active(table.device):
        return _sr.scatter_add_(table, _i32(ids),
                                rows.to(table.dtype).contiguous())
    return _ref.scatter_add_ref_(table, ids, rows)


def scatter_add(table, ids, rows) -> torch.Tensor:
    """Functional form, as the reference's ``scatter_add``: returns the
    updated copy (int64 tables stay int64; other integers accumulate in
    int32, floats in float32)."""
    if kernels_active(table.device):
        acc = _ref.table_acc_dtype(table.dtype)
        return scatter_add_(table.to(acc).clone(), ids, rows)
    return _ref.scatter_add_ref(table, ids, rows)


def table_lookup(cell_keys, cell_starts, table_keys, table_starts,
                 table_occ, max_probes: int) -> torch.Tensor:
    """Row index of each ``(key, start)`` cell, int32, ``capacity`` = miss:
    the first occupied match in the cell's probe window of ``max_probes``
    rows (``capacity = len(table_keys)``)."""
    args = (_i64(cell_keys), _i64(cell_starts), _i64(table_keys),
            _i64(table_starts), table_occ.to(torch.bool).contiguous(),
            max_probes)
    if kernels_active(cell_keys.device):
        return _ht.table_lookup(*args)
    _ht.check_lookup(len(table_keys), len(table_keys), max_probes)
    return _ref.table_lookup_ref(*args)


def batched_table_lookup(cell_owners, cell_keys, cell_starts, table_keys,
                         table_starts, table_occ, capacity: int,
                         max_probes: int) -> torch.Tensor:
    """Global row of each ``(owner, key, start)`` cell in the stacked
    all-shard planes of ``capacity`` rows per shard, int32, ``n_w *
    capacity`` = miss: the first occupied match in the probe window inside
    the owner's segment."""
    args = (_i32(cell_owners), _i64(cell_keys), _i64(cell_starts),
            _i64(table_keys), _i64(table_starts),
            table_occ.to(torch.bool).contiguous(), capacity, max_probes)
    if kernels_active(cell_keys.device):
        return _ht.batched_table_lookup(*args)
    _ht.check_lookup(len(table_keys), capacity, max_probes)
    return _ref.batched_table_lookup_ref(*args)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    prefix_len=0):
    """q ``[B, Hq, Sq, hd]``; k, v ``[B, Hkv, Skv, hd]`` -> like q: causal /
    sliding-window / prefix-LM (``causal`` with ``prefix_len`` keys that
    every query sees) / bidirectional (``causal=False``) attention with
    softcap and GQA, float32 math.  Differentiable in every mode: with grad
    on and an input that requires grad, the kernel route runs
    :class:`~repro_torch.kernels.flash_attention.FlashAttentionFunction`
    (the forward with its row log-sum-exp, the backward kernel for the
    gradient)."""
    if kernels_active(q.device):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _requires_grad(q, k, v):
            return _fk.FlashAttentionFunction.apply(q, k, v, causal, window,
                                                    softcap, prefix_len)
        return _fk.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, prefix_len=prefix_len)
    _fk.check_prefix(prefix_len, k.shape[2], causal, window)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, prefix_len=prefix_len)


def decode_attention(q, cache_k, cache_v, valid_len, *, softcap=0.0,
                     window=0):
    """q ``[B, Hq, hd]`` against the cache ``[B, Hkv, S, hd]`` at positions
    ``p < valid_len`` (``> valid_len - window``); ``valid_len`` a scalar or
    one length per slot ``[B]``; a slot with no admitted position gets the
    mean of V over all S rows, as the reference gives."""
    if kernels_active(q.device):
        _no_backward("decode_attention", q, cache_k, cache_v)
        if isinstance(valid_len, torch.Tensor):
            valid_len = _i32(valid_len.to(q.device))
        return _dk.decode_attention(q.contiguous(), cache_k.contiguous(),
                                    cache_v.contiguous(), valid_len,
                                    softcap=softcap, window=window)
    return _ref.decode_attention_ref(q, cache_k, cache_v, valid_len,
                                     softcap=softcap, window=window)


def ssd_scan(x, dt, A, Bm, Cm):
    """x ``[B, H, S, P]``; dt ``[B, H, S]``; A ``[H]``; Bm, Cm ``[B, G, S,
    N]`` with ``G = 1`` (one group read by every head) or H (strided views
    allowed) -> (y ``[B, H, S, P]``, final h ``[B, H, N, P]`` float32): the
    chunked SSD scan from a zero state, any S.  Differentiable in every
    mode: with grad on and an input that requires grad, the kernel route
    runs :class:`~repro_torch.kernels.ssd_scan.SsdScanFunction` (a shared
    group's gradient summed over the heads by the backward kernel)."""
    heads = x.shape[1]
    if kernels_active(x.device):
        args = (x, dt.float(), A.float(), Bm.to(x.dtype), Cm.to(x.dtype))
        if _requires_grad(*args):
            return _sk.SsdScanFunction.apply(*args)
        return _sk.ssd_scan(*args[:3], _sk.heads_view(args[3], heads),
                            _sk.heads_view(args[4], heads))
    return _ref.ssd_scan_ref(x, dt, A, _sk.heads_view(Bm, heads),
                             _sk.heads_view(Cm, heads))


def moe_gather(x, row_token, *, max_rows_per_token=None) -> torch.Tensor:
    """x ``[T, d]``; row_token ``[R]`` -> ``[R, d]``: ``x[row_token[r]]``,
    zeros for a token outside ``[0, T)`` (the dummy ``T``).  Differentiable
    in every mode: with grad on and x requiring grad, the kernel route runs
    :class:`~repro_torch.kernels.moe_dispatch.MoeGatherFunction`, whose
    backward sums each token's at most ``max_rows_per_token`` rows (``top_k``
    in the model), which it then needs."""
    if kernels_active(x.device):
        x, row_token = x.contiguous(), _i32(row_token)
        if _requires_grad(x):
            if max_rows_per_token is None:
                raise ValueError("ops.moe_gather under grad needs "
                                 "max_rows_per_token (the bound of a "
                                 "token's rows)")
            return _mk.MoeGatherFunction.apply(x, row_token,
                                               max_rows_per_token)
        return _mk.moe_gather(x, row_token)
    return _ref.moe_gather_ref(x, row_token)


def moe_combine(expert_out, row_token, row_weight, num_tokens: int, *,
                max_rows_per_token: int) -> torch.Tensor:
    """``y[t] = sum_{r: row_token[r] == t} w_r expert_out[r]``, float32
    accumulation in a fixed order, rounded once to expert_out's dtype.  No
    kernel, in every mode (the reference's ``ops.moe_combine`` is its jnp
    version too), so autograd differentiates it everywhere; its gradient is
    deterministic (each row of ``expert_out`` sits in one cell of the
    token table)."""
    return _ref.moe_combine_ref(expert_out, row_token, row_weight,
                                num_tokens,
                                max_rows_per_token=max_rows_per_token)
