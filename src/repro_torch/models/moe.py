"""Mixture-of-Experts FFN: per-sequence sort-based capacity dispatch, the
gather through the ``moe_gather`` kernel, a fixed-order float32 combine.

Port of ``repro/models/moe.py`` (the paper's fully-partitioned pattern
inside the model: the router hashes each token to expert slots).  For each
sequence:

1. :func:`route`: float32 router logits (plus ``router_bias`` for the
   aux-loss-free configurations), top-k experts, their softmax weights
   renormalized;
2. :func:`dispatch_indices`: a stable sort of the ``S * k`` picks by
   expert, each pick's position within its expert's run, picks beyond the
   capacity dropped (redirected out of range); the result is a buffer of
   ``E * cap`` rows naming a source token each (``S`` = none);
3. the gather ``buf = x[buf_token]`` through ``ops.moe_gather`` (one launch
   for the whole batch), the experts' gated MLPs as batched products, and
   the weighted combine back to the tokens through ``ops.moe_combine``.

Gradients under grad on the card: the gather's is the backward kernel's
(``moe_gather_backward``, through ``MoeGatherFunction``: each token's at
most ``k`` rows summed in buffer order); the combine's, the router's and
the experts' are autograd's of plain PyTorch.

What differs from the reference: the combine accumulates in float32, each
token summing its at most ``k`` rows in buffer order, and rounds once; the
reference scatter-adds in the activations' dtype, which on the card in
bfloat16 would add in the atomics' order.  The all-to-all expert-parallel
path (``moe_ffn_a2a``) is not ported (it needs the mesh of ``launch/``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import MoEConfig


class MoE(nn.Module):
    """``router [d, E]`` (float32), ``router_bias [E]`` (float32, when the
    configuration has one), ``w_gate``, ``w_up [E, d, ff]``, ``w_down [E,
    ff, d]`` and the shared experts as one gated MLP of width ``ff *
    num_shared``."""

    def __init__(self, d: int, moe: MoEConfig, act: str, *, dtype, device):
        super().__init__()
        e, ff = moe.num_experts, moe.d_ff_expert
        self.act = layers.activation(act)
        self.router = layers.zeros_param((d, e), torch.float32, device)
        self.router_bias = (layers.zeros_param((e,), torch.float32, device)
                            if moe.router_bias else None)
        self.w_gate = layers.zeros_param((e, d, ff), dtype, device)
        self.w_up = layers.zeros_param((e, d, ff), dtype, device)
        self.w_down = layers.zeros_param((e, ff, d), dtype, device)
        self.shared = (layers.MLP(d, ff * moe.num_shared, act, dtype=dtype,
                                  device=device)
                       if moe.num_shared else None)

    def init_weights(self, generator) -> None:
        d, ff = self.w_gate.shape[1], self.w_gate.shape[2]
        for w, std in ((self.router, d ** -0.5), (self.w_gate, d ** -0.5),
                       (self.w_up, d ** -0.5), (self.w_down, ff ** -0.5)):
            layers.truncated_normal_(w.data, std, generator)
        if self.shared is not None:
            self.shared.init_weights(generator)


def capacity(seq_len: int, moe: MoEConfig) -> int:
    c = int(math.ceil(seq_len * moe.top_k * moe.capacity_factor
                      / moe.num_experts))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def route(x, params: MoE, moe: MoEConfig):
    """x ``[B, S, d]`` -> (expert_ids ``[B, S, k]`` int64, weights ``[B, S,
    k]`` float32, aux load-balance loss).  The order of the k picks may
    differ from ``lax.top_k``'s on ties; only the selected set matters."""
    logits = x.float() @ params.router
    probs = torch.softmax(logits, dim=-1)
    select_from = logits if params.router_bias is None \
        else logits + params.router_bias
    expert_ids = torch.topk(select_from, moe.top_k, dim=-1).indices
    weights = probs.gather(-1, expert_ids)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    e = moe.num_experts
    onehot = torch.nn.functional.one_hot(expert_ids, e).float()
    frac_tokens = onehot.sum(dim=2).mean(dim=1)              # [B, E]
    aux = e * (frac_tokens * probs.mean(dim=1)).sum(-1).mean()
    return expert_ids, weights, aux


def dispatch_indices(expert_ids, weights, moe: MoEConfig, cap: int):
    """Per-sequence sort-based capacity packing (the reference's, step for
    step).  expert_ids, weights ``[B, S, k]`` -> (buf_token ``[B, E cap]``
    int32, the source token of each buffer row or ``S`` for none;
    buf_weight ``[B, E cap]`` float32, 0 for none)."""
    b, s, k = expert_ids.shape
    e = moe.num_experts
    dev = expert_ids.device
    flat_e = expert_ids.reshape(b, s * k)
    flat_w = weights.reshape(b, s * k).float()
    flat_tok = torch.arange(s, dtype=torch.int32, device=dev) \
        .repeat_interleave(k).expand(b, s * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    e_sorted = flat_e.gather(-1, order)
    w_sorted = flat_w.gather(-1, order)
    t_sorted = flat_tok.gather(-1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev) \
        .scatter_add_(1, e_sorted, torch.ones_like(e_sorted))
    run_start = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = torch.arange(s * k, device=dev)[None, :] \
        - run_start.gather(-1, e_sorted)
    keep = pos_in_e < cap
    slot = e_sorted * cap + torch.where(keep, pos_in_e, 0)
    # picks beyond capacity go to the spare column e * cap, which is cut
    slot_or_oob = torch.where(keep, slot, e * cap)
    buf_token = torch.full((b, e * cap + 1), s, dtype=torch.int32,
                           device=dev).scatter_(1, slot_or_oob, t_sorted)
    buf_weight = torch.zeros((b, e * cap + 1), dtype=torch.float32,
                             device=dev).scatter_(1, slot_or_oob, w_sorted)
    return buf_token[:, :e * cap], buf_weight[:, :e * cap]


def moe_ffn(x, params: MoE, moe: MoEConfig) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """x ``[B, S, d]`` -> (out ``[B, S, d]`` of x's dtype, aux loss)."""
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    cap = capacity(s, moe)
    expert_ids, weights, aux = route(x, params, moe)
    buf_token, buf_weight = dispatch_indices(expert_ids, weights, moe, cap)

    # one gather for the batch: sequence b's token t is row b * S + t of
    # the flattened x, and every "none" row points past its end
    base = torch.arange(b, dtype=torch.int32, device=x.device)[:, None] * s
    rows = torch.where(buf_token < s, buf_token + base, b * s).reshape(-1)
    buf = ops.moe_gather(x.reshape(b * s, d), rows,
                         max_rows_per_token=k).reshape(b, e, cap, d)

    dt = x.dtype
    gate = params.act(torch.einsum("becd,edf->becf", buf,
                                   params.w_gate.to(dt)))
    up = torch.einsum("becd,edf->becf", buf, params.w_up.to(dt))
    out_buf = torch.einsum("becf,efd->becd", gate * up, params.w_down.to(dt))

    out = ops.moe_combine(out_buf.reshape(b * e * cap, d), rows,
                          buf_weight.reshape(-1), b * s,
                          max_rows_per_token=k).reshape(b, s, d)
    if params.shared is not None:
        out = out + params.shared(x)
    return out, aux


def moe_ffn_dense_oracle(x, params: MoE, moe: MoEConfig):
    """Every expert on every token, weighted by the router's top-k weights,
    without capacity drops: equals :func:`moe_ffn` when nothing is
    dropped."""
    expert_ids, weights, aux = route(x, params, moe)
    dt = x.dtype
    gate = params.act(torch.einsum("bsd,edf->bsef", x, params.w_gate.to(dt)))
    up = torch.einsum("bsd,edf->bsef", x, params.w_up.to(dt))
    per_expert = torch.einsum("bsef,efd->bsed", gate * up,
                              params.w_down.to(dt))
    w_dense = torch.zeros(weights.shape[:2] + (moe.num_experts,),
                          dtype=torch.float32, device=x.device) \
        .scatter_add_(-1, expert_ids, weights)
    out = torch.einsum("bsed,bse->bsd", per_expert, w_dense.to(dt))
    if params.shared is not None:
        out = out + params.shared(x)
    return out, aux
