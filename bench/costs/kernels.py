"""Frozen copies of the closed forms of ``repro_torch/kernels/costs.py``
that the roofline metrics read, and the H100's published peaks.

A copy, not an import: the yardstick stays as it is when the program's own
count changes.  Each ``*_cost`` gives one launch's operations (2 per
multiply-add), the products' share of them, and the HBM bytes it must move
(each input read once, each output written once).  :func:`least_s` turns a
cost into the least time the card could take.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: NVIDIA H100 SXM, dense, at 700 W: bf16 tensor cores, HBM bytes
PEAK_BF16_S = 989e12
PEAK_BYTES_S = 3.35e12
#: operations per admitted (query, key) pair and head besides the products
ATTN_POINTWISE = 5


class Cost(NamedTuple):
    flops: int
    products: int
    bytes: int


def least_s(cost: Cost) -> float:
    """Operations at the bf16 tensor-core rate or bytes at the memory
    rate, whichever takes longer."""
    return max(cost.flops / PEAK_BF16_S, cost.bytes / PEAK_BYTES_S)


def admitted_pairs(sq, skv, causal, window=0, prefix=0):
    q = np.arange(sq, dtype=np.int64)
    hi = (np.minimum(np.maximum(q + 1, prefix), skv) if causal
          else np.full(sq, skv))
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def decode_rows(valid, window, s):
    valid = np.asarray(valid, np.int64)
    hi = np.minimum(valid, s)
    first = np.maximum(valid - window + 1, 0) if window else 0
    return int(np.maximum(hi - first, 0).sum())


def flash_attention_cost(b, hq, hkv, sq, skv, hd, elem, *, causal=True,
                         window=0, prefix_len=0, lse=False) -> Cost:
    pairs = b * hq * admitted_pairs(sq, skv, causal, window, prefix_len)
    products = 4 * hd * pairs
    nbytes = elem * b * (2 * hq * sq * hd + 2 * hkv * skv * hd) \
        + (4 * b * hq * sq if lse else 0)
    return Cost(products + ATTN_POINTWISE * pairs, products, nbytes)


def flash_attention_backward_cost(b, hq, hkv, sq, skv, hd, elem, *,
                                  causal=True, window=0,
                                  prefix_len=0) -> Cost:
    pairs = b * hq * admitted_pairs(sq, skv, causal, window, prefix_len)
    products = 10 * hd * pairs
    nbytes = b * (elem * (3 * hq * sq * hd + 2 * hkv * skv * hd)
                  + 4 * hq * sq + elem * (hq * sq * hd + 2 * hkv * skv * hd))
    return Cost(products + ATTN_POINTWISE * pairs, products, nbytes)


def decode_attention_cost(b, hq, hkv, hd, elem, rows) -> Cost:
    """``rows``: admitted cache rows per kv head summed over the slots."""
    products = 4 * hd * rows * hq
    nbytes = 2 * rows * hkv * hd * elem + 2 * b * hq * hd * elem
    return Cost(products + ATTN_POINTWISE * rows * hq, products, nbytes)


def moe_gather_cost(r, d, elem, read=None) -> Cost:
    """R buffer rows written, ``read`` rows of x read (default: R), the
    int32 tokens read.  The program's own count reads a row of x for every
    buffer row; a row with no token is only written (zeros) and a token
    that several rows copy need be read once, so the roofline passes the
    number of distinct tokens that the rows copy."""
    read = r if read is None else read
    return Cost(0, 0, (r + read) * d * elem + r * 4)
