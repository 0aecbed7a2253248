"""MLP kind ``moe``, after RMSNorm ``ln2``: a float32 top-k router whose
weights are the softmax's picks (renormalised where ``norm_topk_prob``),
each expert taking at most its capacity of a sequence's picks in token
order, SiLU-gated experts, and shared experts beside them."""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bench import model as bm
from bench.reference import transformer as R
from bench.reference.mlp import dense



def leaves(cfg: dict, p: str, dt):
    dense.silu_only(cfg)
    d, m = cfg["d_model"], cfg["moe"]
    e, ff = m["num_experts"], m["d_ff_expert"]
    share = m["top_k"] / e
    out = [bm.norm(f"{p}.ln2.scale", d, dt),
           bm.Leaf(f"{p}.mlp.router", (d, e), torch.float32, d ** -0.5),
           bm.Leaf(f"{p}.mlp.w_gate", (e, d, ff), dt, d ** -0.5, share),
           bm.Leaf(f"{p}.mlp.w_up", (e, d, ff), dt, d ** -0.5, share),
           bm.Leaf(f"{p}.mlp.w_down", (e, ff, d), dt, ff ** -0.5, share)]
    if m.get("num_shared"):
        out += dense.gated(cfg, f"{p}.mlp.shared", ff * m["num_shared"], dt)
    return out


def capacity(n_tokens: int, moe: dict) -> int:
    """Picks an expert takes from a sequence of ``n_tokens``: the
    configuration's ``capacity_factor`` times the even share, rounded up
    to a multiple of 4, at least 4."""
    c = math.ceil(n_tokens * moe["top_k"] * moe["capacity_factor"]
                  / moe["num_experts"])
    return max(4, -(-c // 4) * 4)


def branch(x, w, p: str, cfg: dict, pr: R.Products,
           routed: Optional[int] = None):
    """The routed and shared experts over one sequence ``x [S, d]`` ->
    (out, load-balance loss).  The first ``routed`` tokens are one routed
    sequence under its capacity; every later token is routed alone (a
    decode step: at most one pick per expert, never dropped)."""
    x = R.rmsnorm(x, w[f"{p}.ln2.scale"], cfg["norm_eps"])
    prefix, m = f"{p}.mlp", cfg["moe"]
    e, k = m["num_experts"], m["top_k"]
    logits = pr.mm(x, w[f"{prefix}.router"])
    probs = torch.softmax(logits, dim=-1)
    ids = torch.topk(logits, k, dim=-1).indices                    # [S, k]
    wts = probs.gather(-1, ids)
    if cfg.get("norm_topk_prob", True):
        wts = wts / wts.sum(-1, keepdim=True).clamp_min(1e-9)
    picked = torch.zeros_like(probs).scatter_(-1, ids, 1.0)        # [S, E]
    aux = e * (picked.mean(0) * probs.mean(0)).sum()
    keep = torch.ones_like(picked, dtype=torch.bool)
    if routed:
        head = picked[:routed]
        rank = torch.cumsum(head, dim=0) - 1                 # token order
        keep[:routed] = rank < capacity(routed, m)
    gate_w = torch.zeros_like(probs).scatter_(-1, ids, wts) \
        * (picked * keep)                                          # [S, E]
    out = torch.zeros_like(x)
    for j in range(e):
        rows = torch.nonzero(gate_w[:, j], as_tuple=True)[0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(pr.mm(xe, w[f"{prefix}.w_gate"][j])) \
            * pr.mm(xe, w[f"{prefix}.w_up"][j])
        out = out.index_add(0, rows, gate_w[rows, j, None]
                            * pr.mm(h, w[f"{prefix}.w_down"][j]))
    if m.get("num_shared"):
        out = out + dense.mlp(x, w, f"{prefix}.shared", pr)
    return out, aux
