"""Mamba-2 chunked SSD scan: wrapper around the CUDA kernels.

Port of ``repro/kernels/ssd_scan.py``.  The kernels are
``csrc/ssd_scan.cu``, a chunk-parallel scan in three launches: (a) every
chunk's running decay and state contribution, in parallel over (batch,
chunk, heads), with the score tile ``C B^T`` computed once per (batch,
chunk) when B and C are one group shared by every head, else per head;
(b) the states passed from chunk to chunk, elementwise over the state and
serial only in the chunk; (c) every chunk's output from its scores and the
state it receives.  bfloat16 runs its products on the tensor cores in
chunks of :data:`CHUNK` ``[bfloat16]`` positions, float32 on the CUDA cores
in chunks of ``CHUNK[float32]``.  Any sequence length (the tail chunk is
masked), float32 or bfloat16 x / B / C, float32 dt and A, a state size N
that is a multiple of 4 up to 256.

The inputs are taken as strided views in the reference's public layout
(x ``[B, H, S, P]``, dt ``[B, H, S]``, Bm / Cm ``[B, H, S, N]``): the model
passes its ``[B, S, H, P]`` activations transposed and its one shared B/C
group expanded over the heads (head stride 0), and the kernels read them
in place; that head stride 0 is what selects the shared score tile.  Only
the last axis must be contiguous.  y comes back as a ``[B, H, S, P]`` view
of a ``[B, S, H, P]`` buffer, the model's own layout.  The wrapper takes
CUDA tensors only: it checks them, allocates the workspace of
:func:`workspace_bytes` (the chunk states and score tiles), launches on the
current stream through :func:`repro_torch.kernels._build.launch`, raises
on a refused launch and counts one launch per call in :data:`LAUNCHES`.

The gradient (training) is :func:`ssd_scan_backward`, the kernels of
``csrc/ssd_scan_backward.cu`` (five launches a call, counted as one in
``LAUNCHES["ssd_scan_backward"]``), behind :class:`SsdScanFunction`.  The
forward of the Function keeps its workspace, whose states entering each
chunk (and chunk decays) the backward reads instead of recomputing them:
:func:`workspace_bytes` of the layer (about 100 MB for a Mamba2-780M layer
of 4,096 bf16 tokens), held from the forward to the backward of one layer
under remat.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["CHUNK", "LAUNCHES", "MAX_HEAD_DIM_BACKWARD", "MAX_STATE",
           "SsdScanFunction", "heads_view", "shared_group", "ssd_scan",
           "ssd_scan_backward", "workspace_bytes"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"ssd_scan": 0, "ssd_scan_backward": 0}
#: the largest state size N the kernels' shared memory takes (N must also
#: be a multiple of 4)
MAX_STATE = 256
#: positions per chunk, by dtype (the kernels' own: csrc/ssd_scan.cu Route)
CHUNK = {torch.float32: 64, torch.bfloat16: 128}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head (P) the backward takes (one slice of P; every
#: configuration's head_dim is 64)
MAX_HEAD_DIM_BACKWARD = 64
#: heads per block of the backward's chunk passes (its dB / dC partials are
#: one per group of these heads when B and C are one group)
BACKWARD_HEADS = 4


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def _layout(b, h, s, p, n, dtype, shared):
    """(hprev offset, decay offset, bytes) of the forward's workspace."""
    c = CHUNK[dtype]
    nc = -(-s // c)
    states = b * h * nc * n * p * 4
    hprev_at = _align256(states)
    decay_at = _align256(hprev_at + states)
    scores_at = _align256(decay_at + b * h * nc * 4)
    return hprev_at, decay_at, \
        scores_at + b * (1 if shared else h) * nc * c * c * 4


def workspace_bytes(b: int, h: int, s: int, p: int, n: int, dtype,
                    shared: bool) -> int:
    """Bytes of the kernels' workspace: the float32 chunk states ``[b, h,
    nc, n, p]``, the states passed on (as many bytes), the chunk decays
    ``[b, h, nc]`` and the score tiles ``[b, 1 or h, nc, chunk, chunk]``
    (one per chunk for a shared group, else one per head), each 256-byte
    aligned (csrc/ssd_scan.cu ``workspace``)."""
    return _layout(b, h, s, p, n, dtype, shared)[2]


def shared_group(Bm: torch.Tensor, Cm: torch.Tensor) -> bool:
    """True when B and C are one group read by every head (head stride 0),
    which the kernels take as one score tile per (batch, chunk)."""
    return Bm.stride(1) == 0 and Cm.stride(1) == 0


def _strides(name: str, t: torch.Tensor, dims: int):
    """(batch, head, seq) strides of a ``dims``-axis tensor whose last axis
    (if it has one beyond seq) is contiguous, as a ctypes int64 triple."""
    if dims == 4 and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"ssd_scan: {name} must be contiguous in its last "
                         f"axis, got strides {t.stride()}")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def ssd_scan(x, dt, A, Bm, Cm, *, keep_states: bool = False):
    """x ``[B, H, S, P]``; dt ``[B, H, S]`` float32; A ``[H]`` float32;
    Bm, Cm ``[B, H, S, N]`` of x's dtype -> (y ``[B, H, S, P]`` of x's
    dtype, h ``[B, H, N, P]`` float32), from a zero state; with
    ``keep_states`` also the workspace, which :func:`ssd_scan_backward`
    reads."""
    dev = _build.check_cuda(("x", "dt", "A", "Bm", "Cm"), x, dt, A, Bm, Cm,
                            contiguous=False)
    _check_inputs(x, dt, A, Bm, Cm)
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    A = A.contiguous()
    # y in the model's [B, S, H, P] layout, handed back as a [B, H, S, P] view
    y = torch.empty((b, s, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    h_out = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_bytes(b, h, s, p, n, x.dtype,
                                     shared_group(Bm, Cm)),
                     dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        h_out.zero_()
    else:
        _build.launch("ssd_scan_forward", dev, x.data_ptr(),
                      _strides("x", x, 4), dt.data_ptr(),
                      _strides("dt", dt, 3), A.data_ptr(), Bm.data_ptr(),
                      _strides("Bm", Bm, 4), Cm.data_ptr(),
                      _strides("Cm", Cm, 4), y.data_ptr(),
                      _strides("y", y, 4), h_out.data_ptr(), ws.data_ptr(),
                      ws.numel(), b, h, s, p, n, DTYPE_CODES[x.dtype])
        LAUNCHES["ssd_scan"] += 1
    return (y, h_out, ws) if keep_states else (y, h_out)


def _check_inputs(x, dt, A, Bm, Cm):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: need x [B,H,S,P], dt [B,H,S], A [H], "
                         f"Bm/Cm [B,H,S,N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if tuple(dt.shape) != (b, h, s) or tuple(A.shape) != (h,) \
            or tuple(Bm.shape[:3]) != (b, h, s):
        raise ValueError(f"ssd_scan: shapes do not agree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, Bm, Cm must share float32 or "
                         f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if not 0 < n <= MAX_STATE or n % 4:
        raise ValueError(f"ssd_scan: state size {n} is not a multiple of 4 "
                         f"in [4, {MAX_STATE}]")
    if b > 65535 or h > 65535:
        raise ValueError("ssd_scan: batch and heads must be < 65536")


def heads_view(m: torch.Tensor, heads: int) -> torch.Tensor:
    """B or C ``[B, G, S, N]`` (``G`` 1 or ``heads``) as the ``[B, H, S,
    N]`` view the kernels read: one group expanded with head stride 0."""
    return m.expand(m.shape[0], heads, *m.shape[2:])


def ssd_scan_backward(x, dt, A, Bm, Cm, dy, dh_final=None, *, states):
    """The gradients ``(dx, ddt, dA, dB, dC)`` of :func:`ssd_scan`'s ``(y,
    h)`` for their gradients ``dy`` ``[B, H, S, P]`` (strided, last axis
    contiguous) and ``dh_final`` ``[B, H, N, P]`` (None: zero).  x, dt, A as
    for the forward; Bm, Cm ``[B, G, S, N]``, ``G`` 1 (one group read by
    every head; its gradient sums the heads) or H.  ``states``: the
    workspace of the forward on the same inputs (``keep_states``), whose
    states entering each chunk and chunk decays it reads.  dx ``[B, H, S,
    P]`` (a view of a ``[B, S, H, P]`` buffer) and dB, dC ``[B, G, S, N]``
    of x's dtype; ddt ``[B, H, S]`` (a view of ``[B, S, H]``) and dA
    ``[H]`` float32.  Five kernels a call, counted as one launch; no
    atomics, so a second call gives the same bits."""
    b, h, s, p = x.shape
    if Bm.dim() != 4 or Bm.shape[1] not in (1, h) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan_backward: B and C must be [B, 1 or H, "
                         f"S, N], got {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    groups, n = Bm.shape[1], Bm.shape[-1]
    Bh, Ch = heads_view(Bm, h), heads_view(Cm, h)
    dev = _build.check_cuda(("x", "dt", "A", "Bm", "Cm", "dy"), x, dt, A, Bh,
                            Ch, dy, contiguous=False)
    _check_inputs(x, dt, A, Bh, Ch)
    if p > MAX_HEAD_DIM_BACKWARD:
        raise ValueError(f"ssd_scan_backward: head dim {p} exceeds "
                         f"{MAX_HEAD_DIM_BACKWARD}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_backward: dy must be like x "
                         f"{tuple(x.shape)} {x.dtype}, got {tuple(dy.shape)} "
                         f"{dy.dtype}")
    if dh_final is not None:
        dh_final = dh_final.to(torch.float32).contiguous()
        if dh_final.shape != (b, h, n, p) or dh_final.get_device() != dev:
            raise ValueError(f"ssd_scan_backward: dh_final must be [{b}, {h},"
                             f" {n}, {p}] on the card")
    hprev_at, decay_at, nbytes = _layout(b, h, s, p, n, x.dtype,
                                         shared_group(Bh, Ch))
    if states.numel() != nbytes:
        raise ValueError("ssd_scan_backward: states are not the forward's "
                         "workspace for these inputs")
    A = A.contiguous()
    dx = torch.empty((b, s, h, p), dtype=x.dtype,
                     device=x.device).transpose(1, 2)
    ddt = torch.empty((b, s, h), dtype=torch.float32,
                      device=x.device).transpose(1, 2)
    dA = torch.empty((h,), dtype=torch.float32, device=x.device)
    dB = torch.empty((b, groups, s, n), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    if x.numel() == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_()
    nc = -(-s // CHUNK[x.dtype])
    planes = -(-h // BACKWARD_HEADS) if groups == 1 else h
    f32 = dict(dtype=torch.float32, device=x.device)
    gstate = torch.empty((b, h, nc, n, p), **f32)
    dB_part = torch.empty((b, planes, s, n), **f32)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((b, h, nc), **f32)
    base = states.data_ptr()
    _build.launch("ssd_scan_backward", dev, x.data_ptr(),
                  _strides("x", x, 4), dt.data_ptr(), _strides("dt", dt, 3),
                  A.data_ptr(), Bh.data_ptr(), _strides("Bm", Bh, 4),
                  Ch.data_ptr(), _strides("Cm", Ch, 4), dy.data_ptr(),
                  _strides("dy", dy, 4),
                  None if dh_final is None else dh_final.data_ptr(),
                  base + hprev_at, base + decay_at, dx.data_ptr(),
                  _strides("dx", dx, 4), ddt.data_ptr(),
                  _strides("ddt", ddt, 3), dA.data_ptr(), dB.data_ptr(),
                  dC.data_ptr(), gstate.data_ptr(), dB_part.data_ptr(),
                  dC_part.data_ptr(), dA_part.data_ptr(), b, h, s, p, n,
                  groups, DTYPE_CODES[x.dtype])
    LAUNCHES["ssd_scan_backward"] += 1
    return dx, ddt, dA, dB, dC


class SsdScanFunction(torch.autograd.Function):
    """:func:`ssd_scan` with its gradient from :func:`ssd_scan_backward`
    (CUDA tensors), or :func:`~repro_torch.kernels.ref.ssd_scan_ref` with
    :func:`~repro_torch.kernels.ref.ssd_scan_backward_ref` (CPU tensors).
    ``apply(x, dt, A, Bm, Cm)`` with B and C in their group layout ``[B, G,
    S, N]`` (``G`` 1 or H): the Function expands them itself, so a shared
    group's gradient comes back summed over the heads by the kernel, with
    no ``[B, H, S, N]`` buffer.  Returns ``(y, h)``; the forward keeps its
    workspace (the states entering each chunk) for the backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        from repro_torch.kernels import ref

        heads = x.shape[1]
        ctx.set_materialize_grads(False)
        if x.is_cuda:
            y, h, ws = ssd_scan(x, dt, A, heads_view(Bm, heads),
                                heads_view(Cm, heads), keep_states=True)
        else:
            y, h = ref.ssd_scan_ref(x, dt, A, heads_view(Bm, heads),
                                    heads_view(Cm, heads))
            ws = None
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.states = ws
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        from repro_torch.kernels import ref

        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.is_cuda:
            if dy.stride(-1) != 1:
                dy = dy.contiguous()
            grads = ssd_scan_backward(x, dt, A, Bm, Cm, dy.to(x.dtype), dh,
                                      states=ctx.states)
        else:
            grads = ref.ssd_scan_backward_ref(x, dt, A, Bm, Cm, dy, dh)
        ctx.states = None
        return grads
