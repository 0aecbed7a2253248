"""Shared layer primitives: RMSNorm, embedding, RoPE, the gated MLP, the
cross-entropy loss.

Port of ``repro/models/layers.py``.  Weights keep the reference's layouts
(``wi_gate [d, ff]``, embedding table ``[vocab, d]``) so parameters carry
over leaf for leaf (:mod:`repro_torch.interop`); the modules hold them as
``nn.Parameter`` and the functions below take them as tensors.  The
numerics follow the reference where they are easy to get wrong:

* RMSNorm scales by ``1 + scale`` (zero init) and computes in float32;
* the embedding scale is ``sqrt(d_model)`` rounded to the compute dtype
  before the multiply (68.0 in bfloat16 for d_model 4,608, not 67.88);
* RoPE rotates the two HALVES of the head dimension, not interleaved pairs;
* ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import constrain, tp_group


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: Optional[torch.Generator] = None,
                      chunk_elems: int = 1 << 26) -> torch.Tensor:
    """Fill ``t`` in place with a normal truncated to [-2, 2], times
    ``stddev`` (the reference's ``truncated_normal``).  Drawn in float32,
    chunk by chunk along the first dimension so a large bfloat16 table
    needs no float32 copy of its own size."""
    flat = t.view(t.shape[0], -1) if t.dim() > 1 else t.view(-1, 1)
    rows = max(1, chunk_elems // max(1, flat.shape[1]))
    for i in range(0, flat.shape[0], rows):
        block = flat[i: i + rows]
        tmp = torch.empty(block.shape, dtype=torch.float32, device=t.device)
        nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
        block.copy_(tmp.mul_(stddev))
    return t


def zeros_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            tp=None) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` over the last dimension.  With ``tp``
    (a :class:`~repro_torch.launch.sharding.TPGroup`) ``x`` and ``scale``
    are this rank's block of a width split evenly over the model axis, and
    the sum of squares is all-reduced over it."""
    dt = x.dtype
    xf = x.float()
    if tp is None:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        var = mesh_lib.all_reduce((xf * xf).sum(dim=-1, keepdim=True),
                                  tp.live, tp.axis) / (x.shape[-1] * tp.size)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dt)


class RMSNorm(nn.Module):
    """Gemma-style RMSNorm: ``x / rms(x) * (1 + scale)``, scale zero-init."""

    def __init__(self, d: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = zeros_param((d,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor, *, scale: bool,
          d_model: int, compute_dtype: torch.dtype,
          offset: Optional[int] = None) -> torch.Tensor:
    """The rows of ``tokens``; with an ``offset``, ``table`` is the block of
    the vocabulary starting there and a token outside it reads zeros (the
    rank's part of a vocab-parallel lookup, summed over the model axis
    after)."""
    if offset is not None:
        local = tokens - offset
        inside = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)] * inside[..., None]
        x = x.to(compute_dtype)
    else:
        x = table[tokens].to(compute_dtype)
    if scale:
        root = torch.tensor(math.sqrt(d_model), dtype=torch.float32)
        x = x * root.to(compute_dtype).to(x.device)
    return x


def unembed(x: torch.Tensor, table: torch.Tensor, *,
            softcap: float = 0.0) -> torch.Tensor:
    """Logits in float32: the product in the activations' dtype (as the
    reference's einsum), then the final softcap."""
    logits = (x @ table.to(x.dtype).t()).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[..., seq, heads, head_dim]``; positions ``[..., seq]`` int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs   # [..., seq, half]
    angles = angles[..., None, :]                   # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (GeGLU / SwiGLU)
# ---------------------------------------------------------------------------

def activation(name: str):
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


class MLP(nn.Module):
    """``wo(act(x wi_gate) * (x wi_up))`` with the reference's layouts.
    Under sharding rules whose model axis shards ``ff`` (the weights hold
    ``ff / n`` columns), each rank computes its columns and the partial
    sums are all-reduced (:meth:`partial` leaves them unreduced)."""

    def __init__(self, d: int, ff: int, act: str, *, dtype, device):
        super().__init__()
        self.ff = ff
        self.act = activation(act)
        self.wi_gate = zeros_param((d, ff), dtype, device)
        self.wi_up = zeros_param((d, ff), dtype, device)
        self.wo = zeros_param((ff, d), dtype, device)

    def init_weights(self, generator) -> None:
        d, ff = self.wi_gate.shape
        truncated_normal_(self.wi_gate.data, d ** -0.5, generator)
        truncated_normal_(self.wi_up.data, d ** -0.5, generator)
        truncated_normal_(self.wo.data, ff ** -0.5, generator)

    def sharded(self) -> bool:
        """Whether this rank holds a block of the ``ff`` columns."""
        return self.wi_gate.shape[1] != self.ff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = tp_group() if self.sharded() else None
        if tp is None:
            return self.partial(x)
        out = self.partial(mesh_lib.copy_in(x, tp.live, tp.axis))
        return constrain(out, "batch", None, None, partial="tp")

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The product over this rank's ``ff`` columns (the whole MLP
        unsharded); ``x`` as the rank uses it."""
        dt = x.dtype
        gate = self.act(x @ self.wi_gate.to(dt))
        up = x @ self.wi_up.to(dt)
        return (gate * up) @ self.wo.to(dt)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in float32 over the labels that are not
    ``ignore_id`` (0 when every label is ignored): the reference's
    ``cross_entropy_loss``, step for step."""
    logits = logits.float()
    mask = labels != ignore_id
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, offset: int,
                       tp, *, ignore_id: int = -1):
    """Per-token NLL ``[...]`` (0 at ignored labels) from this rank's block
    of the vocabulary, ``logits [..., V_l]`` starting at ``offset``: the
    maximum, the sum of exponentials and the target's logit each reduced
    over the model axis (``tp`` from :func:`~repro_torch.launch.sharding.
    tp_group`).  Every rank gets the same result; the gradient reaches each
    rank's block of the logits."""
    live, axis = tp.live, tp.axis
    logits = logits.float()
    mask = labels != ignore_id
    m = mesh_lib.all_reduce(logits.detach().amax(dim=-1), live, axis,
                            op="max")
    sumexp = mesh_lib.reduce_out(torch.exp(logits - m[..., None]).sum(-1),
                                 live, axis)
    local = labels.long() - offset
    inside = mask & (local >= 0) & (local < logits.shape[-1])
    gold = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])
    gold = mesh_lib.reduce_out(torch.where(inside, gold[..., 0], 0.0), live,
                               axis)
    return (m + torch.log(sumexp) - gold) * mask
