"""Closed forms of the hand kernels' work: one per :mod:`~repro_torch.
kernels.ops` entry, and the card's peak rates that turn work into a bound.

Each ``*_cost`` function returns a :class:`Cost` for one call at the
shapes given: ``flops`` (every operation, 2 per multiply-add),
``products`` (the multiply-adds of the products alone, 2 per
multiply-add, the share of ``flops`` that runs on tensor cores where the
kernel uses them) and ``bytes`` (what the function must move: each input
read once and each output written once, on the card's HBM).  Work that
depends on the data is given by the caller: attention by its admitted
(query, key) pairs (:func:`admitted_pairs`: causal, window and prefix
masks counted exactly), decode by the cache rows its slots admit
(:func:`decode_rows`; a ``meta`` tensor holds no lengths, so a cost count
takes the cache's whole length and says so), the lookups by their probe
windows.  Workspaces and the kernels' own scratch are not in ``bytes``.

Each kernel wrapper reports its launch's cost from here when it runs on
``meta`` tensors inside :func:`~repro_torch.kernels.ops.cost_count`
(:func:`~repro_torch.kernels._build.count`);
:mod:`repro_torch.launch.cost_analysis` adds them to a step's count, and
``chip_smoke.py`` takes every kernel's bound from here.

The peaks are the NVIDIA H100 SXM's published dense rates at 700 W.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["ATTN_POINTWISE", "Cost", "PEAK_BF16_S", "PEAK_BYTES_S",
           "PEAK_OPS_S", "admitted_pairs", "attention_bound",
           "batched_table_lookup_cost", "bound", "decode_attention_cost",
           "decode_rows", "flash_attention_backward_cost",
           "flash_attention_cost", "flash_backward_bound",
           "moe_gather_backward_cost", "moe_gather_cost", "roofline_ms",
           "scan_backward_bound", "scatter_add_cost", "segment_sum_cost",
           "ssd_pairs", "ssd_scan_backward_cost", "ssd_scan_cost",
           "ssd_work", "table_lookup_cost", "token_rows_table_cost"]

#: HBM bytes per second
PEAK_BYTES_S = 3.35e12
#: the 32-bit non-tensor-core operation rate (the data sheet's float32)
PEAK_OPS_S = 67e12
#: the bf16 tensor-core rate (dense)
PEAK_BF16_S = 989e12
#: operations per admitted (query, key) pair and head besides the two
#: products: scale, running max, subtract, exp, sum
ATTN_POINTWISE = 5
#: and with a softcap: divide, tanh, multiply
SOFTCAP_POINTWISE = 3


class Cost(NamedTuple):
    """One call's work: operations, the products' share, HBM bytes."""
    flops: int
    products: int
    bytes: int


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def bound(nbytes, ops):
    """(ms, "bytes" | "operations"): ``nbytes`` at the memory rate or
    ``ops`` at the 32-bit rate, whichever takes longer."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def attention_bound(pairs, heads, hd, nbytes):
    """4 * hd flops per admitted (query, key) pair and head at the bf16
    tensor-core rate, or the bytes read and written once, whichever is
    larger."""
    t_ops = pairs * heads * 4 * hd / PEAK_BF16_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def flash_backward_bound(pairs, hq, hkv, sq, skv, hd, elem):
    """The backward's least time: 2.5x the forward's products (10 * hd
    flops per admitted pair and head) at the bf16 tensor-core rate, or the
    bytes read once (q, k, v, o, dO, lse) and written once (dq, dk, dv)."""
    t_ops = pairs * hq * 10 * hd / PEAK_BF16_S * 1e3
    t_bytes = _flash_backward_bytes(1, hq, hkv, sq, skv, hd, elem) \
        / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def scan_backward_bound(b, h, s, p, n, groups, elem):
    """The scan backward's least time: its bytes (x, dy, dx and B, C, dB,
    dC of the groups in ``elem`` bytes, dt and ddt float32, each once) at
    the memory rate, or its least operations, the recurrence's backward (per
    position and head the state recomputed, its gradient passed back and
    dx, dB, dC: 5 N P multiply-adds) at the bf16 tensor-core rate.
    Returns ``(ms, bound_by, bytes, operations)``."""
    nbytes = _scan_backward_bytes(b, h, s, p, n, groups, elem)
    ops_n = 10 * b * h * s * n * p
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_n / PEAK_BF16_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops_n


def roofline_ms(flops, hbm_bytes):
    """A step's roofline: its operations at the bf16 tensor-core rate or
    its HBM bytes at the memory rate, whichever takes longer."""
    return max(flops / PEAK_BF16_S, hbm_bytes / PEAK_BYTES_S) * 1e3


# ---------------------------------------------------------------------------
# data-dependent work
# ---------------------------------------------------------------------------

def admitted_pairs(sq, skv, causal, window, prefix=0):
    """(q, k) pairs the flash mask admits for one (batch, head): with
    ``causal`` the keys ``k <= q`` and, with a prefix, every ``k <
    prefix``."""
    q = np.arange(sq, dtype=np.int64)
    hi = (np.minimum(np.maximum(q + 1, prefix), skv) if causal
          else np.full(sq, skv))
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def decode_rows(valid, window, s):
    """Cache rows the decode kernel reads for one kv head, summed over the
    slots, by the kernel's own rule: positions ``[first, hi)`` with
    ``hi = min(valid, S)`` and ``first = max(0, valid - window + 1)`` for
    a window, else 0."""
    valid = np.asarray(valid, np.int64)
    hi = np.minimum(valid, s)
    first = np.maximum(valid - window + 1, 0) if window else 0
    return int(np.maximum(hi - first, 0).sum())


def ssd_pairs(s, chunk):
    """(i, j) pairs with ``j <= i`` inside the chunks of a sequence of
    ``s`` positions cut at ``chunk``."""
    full, tail = divmod(s, chunk)
    return full * chunk * (chunk + 1) // 2 + tail * (tail + 1) // 2


def ssd_work(b, h, s, p, n, chunk):
    """Operations of the chunked formulation at ``chunk`` positions:
    per chunk and head, the masked scores ``C B^T`` and their product with
    ``x dt`` over the causal half (``c (c + 1) / 2`` pairs, ``N + P`` each)
    and the carry-in and state products (``c N P`` each), 2 flops per
    multiply-add."""
    return 2 * b * h * (ssd_pairs(s, chunk) * (n + p) + 2 * s * n * p)


# ---------------------------------------------------------------------------
# one closed form per entry
# ---------------------------------------------------------------------------

def segment_sum_cost(r, d, segments, elem=4) -> Cost:
    """R rows of width d into ``segments`` sums: an add per value; the
    int32 ids, the values and the sums once."""
    return Cost(r * d, 0, r * 4 + r * d * elem + segments * d * elem)


def scatter_add_cost(r, d, elem) -> Cost:
    """R rows added into their table rows: an add per value; the ids and
    rows once, each target row read and written."""
    return Cost(r * d, 0, r * 4 + r * d * elem + 2 * r * d * elem)


def _lookup(n, cell_bytes, rows, probes, planes=5, row_bytes=17) -> Cost:
    """The probe window: each cell read once and its int32 row written, the
    window's ``probes`` rows (int64 key and start, bool occupancy) read,
    capped at the whole table; ``planes`` 32-bit compares a probe."""
    window = min(n * probes * row_bytes, rows * row_bytes)
    return Cost(n * probes * planes, 0, n * (cell_bytes + 4) + window)


def table_lookup_cost(n, rows, probes) -> Cost:
    return _lookup(n, 16, rows, probes)


def batched_table_lookup_cost(n, rows, probes) -> Cost:
    return _lookup(n, 20, rows, probes)


def flash_attention_cost(b, hq, hkv, sq, skv, hd, elem, *, causal=True,
                         window=0, prefix_len=0, softcap=0.0,
                         lse=False) -> Cost:
    """4 hd flops of products per admitted pair and q head, and
    :data:`ATTN_POINTWISE` (+ :data:`SOFTCAP_POINTWISE`) besides; q, k, v
    read and o (and the float32 lse) written once."""
    pairs = b * hq * admitted_pairs(sq, skv, causal, window, prefix_len)
    products = 4 * hd * pairs
    point = ATTN_POINTWISE + (SOFTCAP_POINTWISE if softcap else 0)
    nbytes = elem * b * (2 * hq * sq * hd + 2 * hkv * skv * hd) \
        + (4 * b * hq * sq if lse else 0)
    return Cost(products + point * pairs, products, nbytes)


def _flash_backward_bytes(b, hq, hkv, sq, skv, hd, elem):
    return b * (elem * (3 * hq * sq * hd + 2 * hkv * skv * hd)
                + 4 * hq * sq + elem * (hq * sq * hd + 2 * hkv * skv * hd))


def flash_attention_backward_cost(b, hq, hkv, sq, skv, hd, elem, *,
                                  causal=True, window=0, prefix_len=0,
                                  softcap=0.0) -> Cost:
    """2.5x the forward's products (the scores recomputed, dO V^T, dV, dK,
    dQ: 10 hd flops per admitted pair and q head) and the pointwise work of
    P and dS; q, k, v, o, dO, lse read and dq, dk, dv written once."""
    pairs = b * hq * admitted_pairs(sq, skv, causal, window, prefix_len)
    products = 10 * hd * pairs
    point = ATTN_POINTWISE + (2 * SOFTCAP_POINTWISE if softcap else 0)
    return Cost(products + point * pairs, products,
                _flash_backward_bytes(b, hq, hkv, sq, skv, hd, elem))


def decode_attention_cost(b, hq, hkv, s, hd, elem, rows, *, softcap=0.0,
                          partial=False) -> Cost:
    """``rows`` admitted cache rows summed over the slots (per kv head,
    :func:`decode_rows`): 4 hd flops of products per row and q head; those
    rows of K and V read once, q read and o written once (the partial
    entry's o and lse in float32)."""
    products = 4 * hd * rows * hq
    point = ATTN_POINTWISE + (SOFTCAP_POINTWISE if softcap else 0)
    out = b * hq * (hd + 1) * 4 if partial else b * hq * hd * elem
    nbytes = 2 * rows * hkv * hd * elem + b * hq * hd * elem + out
    return Cost(products + point * rows * hq, products, nbytes)


def ssd_scan_cost(b, h, s, p, n, groups, elem, chunk) -> Cost:
    """The chunked formulation's products at the kernel's ``chunk``
    (:func:`ssd_work`) and, besides, the decays (an exp per admitted pair
    and head, the running sums and the inputs' ``x dt``); x, dt, A, B, C
    (``groups`` of them) read and y and the final float32 state written
    once."""
    products = ssd_work(b, h, s, p, n, chunk)
    point = b * h * (ssd_pairs(s, chunk) + s * (p + 2))
    nbytes = elem * (2 * b * h * s * p + 2 * b * groups * s * n) \
        + 4 * (b * h * s + h + b * h * n * p)
    return Cost(products + point, products, nbytes)


def _scan_backward_bytes(b, h, s, p, n, groups, elem):
    return elem * (3 * b * h * s * p + 4 * b * groups * s * n) \
        + 4 * (2 * b * h * s + 2 * h)


def ssd_scan_backward_cost(b, h, s, p, n, groups, elem, chunk) -> Cost:
    """The chunked backward's products at the forward's ``chunk``: per
    admitted pair and head the scores recomputed and dC, dB inside the
    chunk (N each), dS = dy x^T and dx (P each); per position and head the
    carried state's four (dC from the state entering, the state's gradient,
    dB and dx from it: N P each); x, dt, A, B, C, dy read and dx, ddt, dA,
    dB, dC written once (:func:`scan_backward_bound`'s bytes)."""
    pairs = ssd_pairs(s, chunk)
    products = 2 * b * h * (pairs * (3 * n + 2 * p) + 4 * s * n * p)
    point = 2 * b * h * (pairs + s * (p + 2))
    return Cost(products + point, products,
                _scan_backward_bytes(b, h, s, p, n, groups, elem))


def moe_gather_cost(r, d, elem) -> Cost:
    """R rows of x copied out: each read and written once, the int32
    tokens read."""
    return Cost(0, 0, 2 * r * d * elem + r * 4)


def moe_gather_backward_cost(t, r, d, k, elem) -> Cost:
    """Each token's at most k rows summed (an add per value of a row);
    the rows' gradient and the int32 table read, dx written once."""
    return Cost(r * d, 0, r * d * elem + t * k * 4 + t * d * elem)


def token_rows_table_cost(r, t, k) -> Cost:
    """The rows' int32 tokens read once (a compare each round of k) and the
    int32 table written once."""
    return Cost(r * max(k, 1), 0, r * 4 + t * max(k, 1) * 4)
