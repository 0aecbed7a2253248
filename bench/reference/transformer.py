"""The plain reference model: float32 PyTorch, one operation at a time.

It follows the configuration file (``bench/configs/<name>.json``) and the
equations of the architecture as the configuration states them: RMSNorm
that scales by ``1 + scale`` and adds ``eps`` to the mean square, rotary
embeddings on the two halves of each head, pre-norm residual branches
times ``residual_scale``, each layer's mixer and MLP by the module of its
kind (``bench/reference/mixer/<kind>.py``, ``bench/reference/mlp/<kind>.py``),
embeddings times ``scale_emb``, and float32 logits of the final norm
against the output table over ``logit_scale``.  It imports nothing of the
program and reads no weight the program made: its weights come from
``bench.model``'s seeded groups.

``Products`` says in which precision the products run: ``"float32"`` (the
reference; TF32 is switched off) or ``"fp8"`` (the control: each operand of
every product rounded to float8 e4m3 under a per-tensor scale, the step
below the configuration's bfloat16).
"""

from __future__ import annotations

from typing import Optional

import torch

from bench import model as bm

FP8_MAX = 448.0


def strict_float32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Products:
    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "fp8"):
            raise ValueError(f"products in {mode!r}; known: float32, fp8")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the products see it: itself, or rounded to float8
        e4m3 under its own scale (the gradient passes straight through)."""
        if self.mode == "float32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (r - t).detach()

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, positions, theta):
    """x ``[S, H, hd]``; positions ``[S]``: the two halves rotated."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(x, w, i: int, cfg: dict, pr: Products,
          routed: Optional[int] = None):
    """Decoder layer ``i`` over one sequence -> (x, aux or None): the
    branch of its mixer kind, then of its MLP kind
    (``bench/reference/<part>/<kind>.py``), each added to the residual
    times ``residual_scale``; ``routed`` tokens lead as one routed
    sequence."""
    p, rs, aux = f"layers.{i}", cfg["residual_scale"], None
    for module in bm.layer_modules(cfg)[i]:
        out, a = module.branch(x, w, p, cfg, pr, routed)
        x = x + rs * out
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def embed(tokens, w, cfg: dict):
    return w["embed"][tokens] * cfg.get("scale_emb", 1.0)


def logits(x, w, cfg: dict, pr: Products):
    table = w["embed"] if cfg["tie_embeddings"] else w["lm_head"]
    return pr.mm(rmsnorm(x, w["final_norm.scale"], cfg["norm_eps"]),
                 table.t()) / cfg.get("logit_scale", 1.0)


def nll(lg, labels):
    """Mean token NLL of float32 logits against ``labels``."""
    return (torch.logsumexp(lg, dim=-1)
            - lg.gather(-1, labels[:, None])[:, 0]).mean()
