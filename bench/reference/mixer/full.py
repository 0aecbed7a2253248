"""Mixer kind ``full``: causal softmax attention with grouped kv heads and
rotary embeddings on the two halves of each head, after RMSNorm ``ln1``."""

import math

import torch

from bench import model as bm
from bench.reference import transformer as R


def leaves(cfg: dict, p: str, dt):
    d, hq, hkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = bm.head_dim(cfg)
    m = f"{p}.mixer"
    return [bm.norm(f"{p}.ln1.scale", d, dt),
            bm.Leaf(f"{m}.wq", (d, hq, hd), dt, d ** -0.5),
            bm.Leaf(f"{m}.wk", (d, hkv, hd), dt, d ** -0.5),
            bm.Leaf(f"{m}.wv", (d, hkv, hd), dt, d ** -0.5),
            bm.Leaf(f"{m}.wo", (hq, hd, d), dt, (hq * hd) ** -0.5)]


def attention_per_context(cfg: dict) -> float:
    """PaLM's ``H Q``: q heads times their width."""
    return cfg["num_heads"] * bm.head_dim(cfg)


def branch(x, w, p: str, cfg: dict, pr: R.Products, routed=None,
           q_block: int = 512):
    """Causal attention of one sequence ``x [S, d]`` from position 0, the
    scores of ``q_block`` queries at a time -> (out, None)."""
    x = R.rmsnorm(x, w[f"{p}.ln1.scale"], cfg["norm_eps"])
    m = f"{p}.mixer"
    s, d = x.shape
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = w[f"{m}.wq"].shape[-1]
    pos = torch.arange(s, device=x.device)
    q = R.rope(pr.mm(x, w[f"{m}.wq"].reshape(d, hq * hd))
               .view(s, hq, hd), pos, cfg["rope_theta"])
    k = R.rope(pr.mm(x, w[f"{m}.wk"].reshape(d, hkv * hd))
               .view(s, hkv, hd), pos, cfg["rope_theta"])
    v = pr.mm(x, w[f"{m}.wv"].reshape(d, hkv * hd)).view(s, hkv, hd)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)       # [hq, S, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    outs = []
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        sc = pr.einsum("hqd,hkd->hqk", q[:, lo:hi], k[:, :hi]) \
            / math.sqrt(hd)
        qi = torch.arange(lo, hi, device=x.device)[:, None]
        ki = torch.arange(hi, device=x.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        outs.append(pr.einsum("hqk,hkd->hqd", torch.softmax(sc, dim=-1),
                              v[:, :hi]))
    o = torch.cat(outs, dim=1).transpose(0, 1).reshape(s, hq * hd)
    return pr.mm(o, w[f"{m}.wo"].reshape(hq * hd, d)), None
