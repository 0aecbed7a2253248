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
3. the token table (``ops.token_rows_table``: each token's at most ``k``
   buffer rows in buffer order; on the card one kernel call, no sort, no
   host synchronisation), built once and read by both the gather's
   backward and the combine;
4. the gather ``buf = x[buf_token]`` through ``ops.moe_gather`` (one launch
   for the whole batch), the experts' gated MLPs as batched products, and
   the weighted combine back to the tokens through ``ops.moe_combine``.

Gradients under grad on the card: the gather's is the backward kernel's
(``moe_gather_backward``, through ``MoeGatherFunction``, which keeps the
layer's table: each token's at most ``k`` rows summed in buffer order);
the combine's, the router's and the experts' are autograd's of plain
PyTorch.

Under sharding rules with a live mesh (:mod:`repro_torch.launch.sharding`):

* with ``rules.moe_a2a``, :func:`moe_ffn_a2a`, the reference's
  expert-parallel route (the paper's S2 dispatch at production scale):
  each data shard routes its tokens and packs them per destination
  (:func:`_flat_dispatch`), one ``all_to_all`` over ``data`` sends them to
  the experts' owners, each rank runs its ``E / n_ep`` experts with ``ff``
  over the model axis, one ``all_to_all`` brings the rows back, the
  combine, then a single all-reduce of the ``[T, d]`` partial sums over the
  model axis (the shared experts' partial sums added before it);
* otherwise, with the experts split over the model axis, each rank
  gathers and runs the buffer rows of its experts and the partial outputs
  are all-reduced (the reference's GSPMD partial sum).

Both take the load-balance loss averaged over the data-parallel axes, and
both run the gather and the combine through ``ops.token_rows_table``,
``ops.moe_gather`` and ``ops.moe_combine`` on the rank's own table.

What differs from the reference: the combine accumulates in float32, each
token summing its at most ``k`` rows in buffer order, and rounds once; the
reference scatter-adds in the activations' dtype, which on the card in
bfloat16 would add in the atomics' order.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import active_rules, tp_group
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


def _dp_mean(aux, rules):
    """A loss averaged over the data-parallel axes of ``rules``."""
    live = rules.live
    n = live.size(rules.dp_axes)
    return mesh_lib.reduce_out(aux, live, rules.dp_axes) / n


def _with_shared(out, x, xin, params: MoE, tp):
    """The experts' output plus the shared experts', reduced over the model
    axis when either is a partial sum there (``tp``; ``xin`` is ``x``
    through ``copy_in``)."""
    shared = params.shared
    if tp is None:
        return out if shared is None else out + shared(x)
    if shared is not None and shared.sharded():
        out = out + shared.partial(xin)
    out = mesh_lib.reduce_out(out, tp.live, tp.axis)
    if shared is not None and not shared.sharded():
        out = out + shared(x)
    return out


def moe_ffn(x, params: MoE, moe: MoEConfig) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """x ``[B, S, d]`` -> (out ``[B, S, d]`` of x's dtype, aux loss).  Under
    rules with ``moe_a2a`` it is :func:`moe_ffn_a2a`."""
    rules = active_rules()
    if rules is not None and rules.moe_a2a:
        return moe_ffn_a2a(x, params, moe, rules)
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    cap = capacity(s, moe)
    expert_ids, weights, aux = route(x, params, moe)
    buf_token, buf_weight = dispatch_indices(expert_ids, weights, moe, cap)
    tp, xin = None, x
    if rules is not None:
        aux = _dp_mean(aux, rules)
        if params.w_gate.shape[0] != e:       # this rank's experts
            tp = tp_group()
            e = params.w_gate.shape[0]
            lo = tp.index * e * cap
            # the tokens and the routing weights enter the rank's own part
            buf_weight = mesh_lib.copy_in(buf_weight, tp.live, tp.axis)
            buf_token = buf_token[:, lo:lo + e * cap]
            buf_weight = buf_weight[:, lo:lo + e * cap]
            xin = mesh_lib.copy_in(x, tp.live, tp.axis)

    # one gather for the batch: sequence b's token t is row b * S + t of
    # the flattened x, and every "none" row points past its end
    base = torch.arange(b, dtype=torch.int32, device=x.device)[:, None] * s
    rows = torch.where(buf_token < s, buf_token + base, b * s).reshape(-1)
    table = ops.token_rows_table(rows, b * s, k)
    buf = ops.moe_gather(xin.reshape(b * s, d), rows, max_rows_per_token=k,
                         table=table).reshape(b, e, cap, d)

    dt = x.dtype
    gate = params.act(torch.einsum("becd,edf->becf", buf,
                                   params.w_gate.to(dt)))
    up = torch.einsum("becd,edf->becf", buf, params.w_up.to(dt))
    out_buf = torch.einsum("becf,efd->becd", gate * up, params.w_down.to(dt))

    out = ops.moe_combine(out_buf.reshape(b * e * cap, d), rows,
                          buf_weight.reshape(-1), b * s,
                          max_rows_per_token=k, table=table).reshape(b, s, d)
    return _with_shared(out, x, xin, params, tp), aux


def _flat_dispatch(flat_e, flat_w, e: int, cap: int, k: int = 1):
    """The reference's 1-D sort-based capacity packing: the picks ``[T
    k]`` (token ``i // k``) -> (buf_token ``[E cap]`` int32, the source
    token of each row or ``T`` for none; buf_weight ``[E cap]`` float32),
    :func:`dispatch_indices` on one sequence of ``T`` tokens."""
    ids = flat_e.reshape(1, -1, k)
    w = flat_w.reshape(1, -1, k)
    buf_token, buf_weight = dispatch_indices(
        ids, w, MoEConfig(num_experts=e, top_k=k), cap)
    return buf_token[0], buf_weight[0]


def moe_ffn_a2a(x, params: MoE, moe: MoEConfig, rules) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with all-to-all token routing, the reference's
    ``moe_ffn_a2a``: this rank's tokens ``x [B_l, S, d]`` (its data shard)
    -> (out ``[B_l, S, d]``, aux averaged over the data-parallel axes).

    The experts are split over ``data`` (the partition owners: ``w_gate``,
    ``w_up [E / n_ep, d, ff / tp]``, ``w_down [E / n_ep, ff / tp, d]``) and
    replicated over ``pod``; the router is whole.  The shard's ``T = B_l
    S`` tokens are routed and packed per destination into ``[n_ep, E_l
    cap, d]`` rows (capacity ``cap`` over the shard's tokens), one
    ``all_to_all`` over ``data`` each way carries them to the owners and
    back, and the combine's partial sums (the expert FFN's ``ff`` is over
    the model axis) are all-reduced once over the model axis."""
    live = rules.live
    ep, tp = "data", tp_group()
    n_ep = live.size(ep)
    e, k = moe.num_experts, moe.top_k
    e_l = e // n_ep
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    # the shard's tokens routed as one sequence (the reference's body)
    ids, w, aux = route(xf[None], params, moe)
    aux = _dp_mean(aux, rules)

    cap = max(4, -(-int(t * k * moe.capacity_factor / e) // 4) * 4)
    buf_token, buf_w = _flat_dispatch(ids.reshape(t * k), w.reshape(t * k),
                                      e, cap, k)
    xin = xf
    if tp is not None:
        # the combine weights partial rows of ff: the tokens and the routing
        # weights enter the rank's own part
        xin = mesh_lib.copy_in(xf, tp.live, tp.axis)
        buf_w = mesh_lib.copy_in(buf_w, tp.live, tp.axis)
    table = ops.token_rows_table(buf_token, t, k)
    send = ops.moe_gather(xin, buf_token, max_rows_per_token=k, table=table)
    recv = mesh_lib.all_to_all(send.reshape(n_ep, e_l * cap, d), live, ep)
    # [n_ep (source), E_l cap, d] -> [E_l, n_ep cap, d]
    recv = recv.reshape(n_ep, e_l, cap, d).transpose(0, 1).reshape(
        e_l, n_ep * cap, d)
    dt = x.dtype
    gate = params.act(torch.einsum("erd,edf->erf", recv,
                                   params.w_gate.to(dt)))
    up = torch.einsum("erd,edf->erf", recv, params.w_up.to(dt))
    out = torch.einsum("erf,efd->erd", gate * up, params.w_down.to(dt))
    back = out.reshape(e_l, n_ep, cap, d).transpose(0, 1).reshape(
        n_ep, e_l * cap, d)
    rows = mesh_lib.all_to_all(back, live, ep).reshape(e * cap, d)
    y = ops.moe_combine(rows, buf_token, buf_w, t, max_rows_per_token=k,
                        table=table)
    y = _with_shared(y, xf, xin, params, tp)
    return y.reshape(b, s, d), aux


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
