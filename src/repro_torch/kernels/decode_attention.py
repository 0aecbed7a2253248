"""Decode attention against the KV cache: wrapper around the CUDA kernels.

Port of ``repro/kernels/decode_attention.py``.  The kernels are
``csrc/decode_attention.cu``: one query row per (slot, q head) against the
cached rows ``p < valid_len[slot]`` (and ``p > valid_len[slot] - window``),
with softcap and GQA, float32 math for float32 or bfloat16 inputs,
head_dim 64, 128 or 256, any number of q heads per kv head.  ``valid_len``
is one length per slot (int32 ``[B]``); a scalar broadcasts.  The cache
may be a block of kv heads narrowed out of a cache that holds more
(:func:`slot_heads`), which the kernels read in place; any other layout is
copied to a contiguous one first.  A slot with no admitted position
(``valid_len`` 0) gets the mean of V over all S rows, as the reference's
finite mask gives.

:func:`decode_attention_partial` is the same over a block of global
positions ``[pos0, pos0 + S)`` (a cache whose sequence is split over
ranks): float32 ``o`` and the rows' log-sum-exp, from which the blocks
merge, and ``o = 0``, ``lse = -inf`` where a block admits no row.  Both
call the one C entry ``attn_decode`` (a null ``lse`` for the whole cache).

Two routes, a pure function of the dtype and the group (:func:`route`):
``"mma"``, the tensor cores, for bfloat16 at 4 or more q heads per kv head
(a block serves 16 of them, the rows of an ``mma.sync`` tile); ``"split"``,
the CUDA cores, for float32 and for bfloat16 at 1 or 2 (a block serves 8).
Either cuts each slot's admitted positions into at most :func:`num_splits`
runs of whole tiles (:func:`split_length`), one block per (run, kv head x
chunk, slot), and merges the runs in the same launch (split-KV,
flash-decoding): the split route's last block through a float32 workspace
and per-(slot, kv head, chunk) counters, which the kernel leaves at zero,
the mma route's blocks of one (slot, kv head, chunk) as a thread-block
cluster through their shared memory.  The wrapper picks the number of runs
from the shapes alone (it never reads ``valid_len`` on the host), keeps the
workspace and counters per device and stream, takes CUDA tensors only,
checks them, launches on the current stream through the shared helpers of
:mod:`repro_torch.kernels._build`, raises on a refused launch and counts
the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._build import check_cuda
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES,
    check_attention_inputs,
)

__all__ = ["LAUNCHES", "MAX_GROUP", "chunks", "decode_attention",
           "decode_attention_partial", "num_splits", "route", "slot_heads",
           "split_length", "tile_rows"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"decode_attention": 0, "decode_attention_partial": 0}
#: most q heads one block serves, by route (``kMaxGroup``, ``kMmaGroup``)
MAX_GROUP = {"split": 8, "mma": 16}
#: the kernels' constants (``csrc/decode_attention.cu``): the split route's
#: bytes of K (and of V) in one shared-memory tile, the mma route's rows of
#: a tile by head_dim, most splits per slot (split route: the merge's
#: table; mma route: a cluster's blocks), the fewest tiles in a run; the
#: rows of a split of a full cache and the blocks that make several waves on
#: the H100's 132 SMs (split route), the blocks that give every SM one (mma
#: route)
TILE_BYTES = 8192
MMA_TILE_ROWS = {64: 64, 128: 64, 256: 32}
MAX_SPLITS = 64
MMA_MAX_SPLITS = 8
MIN_RUN_TILES = 4
SPLIT_ROWS = 256
WAVE_BLOCKS = 8 * 132
MMA_WAVE_BLOCKS = 132

#: (device, stream) -> (workspace, counters), grown as shapes need
_SCRATCH: dict = {}


def route(dtype: torch.dtype, head_dim: int, group: int) -> str:
    """The kernel a launch takes: ``"mma"`` (tensor cores) for bfloat16 at
    ``group`` >= 4 q heads per kv head, else ``"split"`` (CUDA cores); the
    C entry decides alike.  ``head_dim`` does not change it."""
    return "mma" if dtype == torch.bfloat16 and group >= 4 else "split"


def chunks(hq: int, hkv: int, kind: str = "split") -> int:
    """Blocks per kv head and split: its q heads in chunks of at most
    ``MAX_GROUP[kind]``."""
    return -(-(hq // hkv) // MAX_GROUP[kind])


def tile_rows(head_dim: int, itemsize: int, kind: str = "split") -> int:
    """Cache rows in one tile of the route's shared-memory ring."""
    if kind == "mma":
        return MMA_TILE_ROWS[head_dim]
    return TILE_BYTES // (head_dim * itemsize)


@functools.lru_cache(maxsize=256)
def num_splits(b: int, hkv: int, s_len: int, head_dim: int,
               itemsize: int, kind: str = "split") -> int:
    """Splits per slot, the grid's first axis, for ``b`` slots of ``hkv``
    blocks each (kv heads times chunks); never more than ``S`` has tiles.
    The split route: ``ceil(S / 256)``, raised until the grid has
    :data:`WAVE_BLOCKS` blocks, at most :data:`MAX_SPLITS`.  The mma route:
    the splits of a (slot, kv head, chunk) are one thread-block cluster, so
    a power of two up to :data:`MMA_MAX_SPLITS`, the fewest that give the
    grid :data:`MMA_WAVE_BLOCKS` blocks (long runs a block; measured
    fastest, PERF.md)."""
    tiles = -(-s_len // tile_rows(head_dim, itemsize, kind))
    if kind == "mma":
        n = 1
        while n < MMA_MAX_SPLITS and b * hkv * n < MMA_WAVE_BLOCKS:
            n *= 2
        while n > tiles:
            n //= 2
        return n
    n = -(-s_len // SPLIT_ROWS)
    if b * hkv * n < WAVE_BLOCKS:
        n = -(-WAVE_BLOCKS // (b * hkv))
    return max(1, min(n, tiles, MAX_SPLITS))


def slot_heads(cache: torch.Tensor):
    """The heads between two slots of ``cache [B, Hkv, S, hd]`` when each
    slot's ``[Hkv, S, hd]`` is dense and the slots lie whole heads apart (a
    contiguous cache, or a block of its kv heads from ``narrow``), the
    layout the kernel reads; None for any other."""
    b, h, s_len, hd = cache.shape
    st = cache.stride()
    if ((hd > 1 and st[3] != 1) or (s_len > 1 and st[2] != hd)
            or (h > 1 and st[1] != s_len * hd)):
        return None
    if b == 1:
        return h
    if st[0] % (s_len * hd) or st[0] < h * s_len * hd:
        return None
    return st[0] // (s_len * hd)


def split_length(rows: int, splits: int, tile: int) -> int:
    """Positions per split of a slot with ``rows`` admitted positions, as
    the kernel cuts them: ``ceil(rows / splits)`` rounded up to whole
    tiles, at least :data:`MIN_RUN_TILES` of them (the last split takes
    the rest)."""
    per = -(-rows // splits)
    return max(-(-per // tile), MIN_RUN_TILES) * tile


def _scratch(dev: int, n_ws: int, n_counters: int):
    """The merge's float32 workspace (at least ``n_ws``) and zeroed int32
    counters (at least ``n_counters``) of the current stream; kept across
    calls, so a cost count (:data:`~repro_torch.kernels._build.META`) takes
    none."""
    if dev == _build.META:
        return (torch.empty(0, device="meta"),) * 2
    key = (dev, _build.current_stream(dev))
    ws, counters = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < n_ws or counters.numel() < n_counters:
        n_ws = max(n_ws, 0 if ws is None else ws.numel())
        n_counters = max(n_counters, 0 if ws is None else counters.numel())
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
        counters = torch.zeros(n_counters, dtype=torch.int32, device=dev)
        _SCRATCH[key] = ws, counters
    return ws, counters


def _checked(name, q, cache_k, cache_v, valid_len, window):
    """The checked inputs of one launch: ``(device, valid_len [B] int32,
    cache_k, cache_v, kv_slot)``, the caches contiguous where
    :func:`slot_heads` does not take their layout."""
    b = q.shape[0]
    if not isinstance(valid_len, torch.Tensor) or valid_len.dim() == 0:
        valid_len = torch.full((b,), int(valid_len), dtype=torch.int32,
                               device=q.device)
    dev = check_cuda(("q", "valid_len"), q, valid_len)
    if check_cuda(("cache_k", "cache_v"), cache_k, cache_v,
                  contiguous=False) != dev:
        raise ValueError(f"{name}: the cache is on {cache_k.device}, q on "
                         f"{q.device}")
    if q.dim() != 3 or cache_k.dim() != 4:
        raise ValueError(f"{name}: need q [B,Hq,hd] and cache [B,Hkv,S,hd], "
                         f"got {tuple(q.shape)} and {tuple(cache_k.shape)}")
    check_attention_inputs(name, q, cache_k, cache_v)
    hq = q.shape[1]
    _, hkv, s_len, _ = cache_k.shape
    if cache_k.shape[0] != b or hkv == 0 or hq % hkv or s_len == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit the "
                         f"cache {tuple(cache_k.shape)}")
    if valid_len.dtype != torch.int32 or valid_len.shape != (b,):
        raise ValueError(f"{name}: valid_len must be int32 [{b}], got "
                         f"{valid_len.dtype} {tuple(valid_len.shape)}")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    if b > 65535 or hkv * chunks(hq, hkv, route(q.dtype, q.shape[2],
                                                hq // hkv)) > 65535:
        raise ValueError(f"{name}: batch and kv heads times chunks must be "
                         f"< 65536")
    kv_slot = slot_heads(cache_k)
    if kv_slot is None or cache_k.stride() != cache_v.stride():
        cache_k, cache_v = cache_k.contiguous(), cache_v.contiguous()
        kv_slot = hkv
    return dev, valid_len, cache_k, cache_v, kv_slot


def _grid(dev, q, cache_k):
    """(splits, workspace, counters) of a launch over ``cache_k``; the mma
    route merges its splits in the cluster and takes no workspace."""
    b, hq, hd = q.shape
    _, hkv, s_len, _ = cache_k.shape
    kind = route(q.dtype, hd, hq // hkv)
    blocks = hkv * chunks(hq, hkv, kind)   # per slot and split
    splits = num_splits(b, blocks, s_len, hd, q.element_size(), kind)
    if kind == "mma":
        return splits, *_scratch(dev, 0, 0)
    ws, counters = _scratch(dev, b * hq * splits * (hd + 2), b * blocks)
    return splits, ws, counters


def decode_attention(q, cache_k, cache_v, valid_len, *, softcap: float = 0.0,
                     window: int = 0) -> torch.Tensor:
    """q ``[B, Hq, hd]``; cache ``[B, Hkv, S, hd]`` (k and v in one layout
    that :func:`slot_heads` takes, else copied); ``valid_len`` int32
    ``[B]`` (or a scalar) -> ``[B, Hq, hd]``.

    A row with no admitted position (``valid_len`` 0) gets the mean of V
    over all S rows, as the plain version and the reference give."""
    dev, valid_len, cache_k, cache_v, kv_slot = _checked(
        "decode_attention", q, cache_k, cache_v, valid_len, window)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    b, hq, hd = q.shape
    _, hkv, s_len, _ = cache_k.shape
    splits, ws, counters = _grid(dev, q, cache_k)
    _build.launch("attn_decode", dev, q.data_ptr(), cache_k.data_ptr(),
                  cache_v.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
                  None, ws.data_ptr(), counters.data_ptr(), b, hq, hkv,
                  kv_slot, s_len, 0, hd, DTYPE_CODES[q.dtype], int(window),
                  float(softcap), splits)
    _count("decode_attention", dev, q, s_len, hkv, window, softcap)
    return out


def decode_attention_partial(q, cache_k, cache_v, valid_len, pos0: int, *,
                             softcap: float = 0.0, window: int = 0):
    """The decode over a block of global positions: the cache ``[B, Hkv,
    S, hd]`` holds rows ``[pos0, pos0 + S)`` of the whole cache, and local
    row ``r`` is admitted when ``pos0 + r < valid_len`` (and ``> valid_len
    - window``), ``valid_len`` a global length.  Returns ``(o, lse)``:
    float32 ``[B, Hq, hd]`` (unrounded) and float32 ``[B, Hq]``, the
    log-sum-exp of the block's scaled (soft-capped) scores; a row with no
    admitted position gets ``o = 0`` and ``lse = -inf``."""
    if pos0 < 0:
        raise ValueError(f"decode_attention_partial: pos0 must be >= 0, "
                         f"got {pos0}")
    dev, valid_len, cache_k, cache_v, kv_slot = _checked(
        "decode_attention_partial", q, cache_k, cache_v, valid_len, window)
    b, hq, hd = q.shape
    out = torch.empty((b, hq, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if b == 0:
        return out, lse
    _, hkv, s_len, _ = cache_k.shape
    splits, ws, counters = _grid(dev, q, cache_k)
    _build.launch("attn_decode", dev, q.data_ptr(),
                  cache_k.data_ptr(), cache_v.data_ptr(),
                  valid_len.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  ws.data_ptr(), counters.data_ptr(), b, hq, hkv, kv_slot,
                  s_len, int(pos0), hd, DTYPE_CODES[q.dtype], int(window),
                  float(softcap), splits)
    _count("decode_attention_partial", dev, q, s_len, hkv, window, softcap)
    return out, lse


def _count(entry, dev, q, s_len, hkv, window, softcap):
    """Count the launch (a cost count, which cannot read ``valid_len``,
    takes every slot's whole cache)."""
    b, hq, hd = q.shape
    _build.count(LAUNCHES, entry, dev,
                 lambda: costs.decode_attention_cost(
                     b, hq, hkv, s_len, hd, q.element_size(),
                     b * costs.decode_rows(s_len, window, s_len),
                     softcap=softcap,
                     partial=entry == "decode_attention_partial"),
                 f"{entry}: valid_len is data; costed over every slot's "
                 f"whole cache")
