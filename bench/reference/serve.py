"""The reference's logits for served requests, a layer at a time.

Each request is one sequence: its prompt, then the tokens the program
served, but the last (which no step read back).  The prompt is routed as
one sequence under the MoE capacity, as a prefill routes it; every later
token alone, as a decode step does.  The logits at the prompt's last
position and at each served token but the last are the ones the served
tokens were taken from.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from bench import model as bm
from bench.reference import transformer as R


@torch.no_grad()
def served_logits(cfg: dict, seed: int, requests: Sequence[Tuple[
        np.ndarray, Sequence[int]]], device, modes=("float32",)) -> List[
        List[torch.Tensor]]:
    """``requests``: (prompt, served tokens).  For each mode of products
    (``R.Products``), for each request, the float32 logits ``[n_served,
    vocab]`` the reference gives where each served token was taken."""
    R.strict_float32()
    groups = bm.plan(cfg)
    seqs = [torch.as_tensor(np.concatenate([np.asarray(p, np.int64),
                                            np.asarray(s[:-1], np.int64)]),
                            device=device) for p, s in requests]
    plens = [len(p) for p, _ in requests]
    prs = [R.Products(m) for m in modes]
    w = _f32(bm.group_weights(cfg, seed, 0, device, groups))
    hs = [[R.embed(t, w, cfg) for t in seqs] for _ in prs]
    tables = w
    for i in range(cfg["num_layers"]):
        w = _f32(bm.group_weights(cfg, seed, i + 1, device, groups))
        for h, pr in zip(hs, prs):
            for j, x in enumerate(h):
                h[j], _ = R.layer(x, w, i, cfg, pr, routed=plens[j])
        del w
    final = _f32(bm.group_weights(cfg, seed, len(groups) - 1, device, groups))
    tables.update(final)
    return [[R.logits(x[n - 1:], tables, cfg, pr)
             for x, n in zip(h, plens)] for h, pr in zip(hs, prs)]


def _f32(ws):
    return {k: v.float() for k, v in ws.items()}
