"""MLP kind ``dense``: a SiLU-gated MLP after RMSNorm ``ln2``."""

import torch.nn.functional as F

from bench import model as bm
from bench.reference import transformer as R


def gated(cfg: dict, prefix: str, ff: int, dt):
    """The leaves of a gated MLP of width ``ff`` under ``prefix``."""
    d = cfg["d_model"]
    return [bm.Leaf(f"{prefix}.wi_gate", (d, ff), dt, d ** -0.5),
            bm.Leaf(f"{prefix}.wi_up", (d, ff), dt, d ** -0.5),
            bm.Leaf(f"{prefix}.wo", (ff, d), dt, ff ** -0.5)]


def silu_only(cfg: dict) -> None:
    """Raise where the configuration asks for another activation, which
    is another kind's."""
    if cfg.get("mlp_activation", "silu") != "silu":
        raise ValueError(f"{cfg['name']}: a {cfg['mlp_activation']} MLP is "
                         f"not this kind's")


def leaves(cfg: dict, p: str, dt):
    silu_only(cfg)
    return [bm.norm(f"{p}.ln2.scale", cfg["d_model"], dt)] \
        + gated(cfg, f"{p}.mlp", cfg["d_ff"], dt)


def mlp(x, w, prefix: str, pr: R.Products):
    gate = F.silu(pr.mm(x, w[f"{prefix}.wi_gate"]))
    return pr.mm(gate * pr.mm(x, w[f"{prefix}.wi_up"]), w[f"{prefix}.wo"])


def branch(x, w, p: str, cfg: dict, pr: R.Products, routed=None):
    h = R.rmsnorm(x, w[f"{p}.ln2.scale"], cfg["norm_eps"])
    return mlp(h, w, f"{p}.mlp", pr), None
