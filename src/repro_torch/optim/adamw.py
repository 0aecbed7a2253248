"""AdamW with global-norm clipping: the training step's state commit.

Port of ``repro/optim/adamw.py``, in the reference's arithmetic: float32
moments ``m`` and ``v``, the global-norm clip, bias correction, ``delta =
mhat / (sqrt(vhat) + eps) + weight_decay * p``, and the parameter updated
in float32 and rounded back to its own dtype (no float32 master copy).
That is not ``torch.optim.AdamW``, which decays before the step and keeps
its moments in the parameter's dtype: another result.

In the paper's terms (section 4.5, separate task and state) the
per-microbatch forward and backward are the task ``f`` and this update is
the state section ``s``; the reference shards it over the mesh, one card
holds it whole here.

Parameters are an ``nn.Module`` (its ``named_parameters()``, so a tied
embedding is one leaf) or a dict ``{name: tensor}``; gradients and the
moments are dicts under the same names.  :func:`apply_updates` updates the
parameters and the moments IN PLACE (the memory of a second copy of each is
what the port saves) and returns them with the new step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Union

import torch
from torch import nn

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "named_params", "schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "wsd"  # wsd | cosine | constant
    warmup_steps: int = 100
    total_steps: int = 1000
    decay_frac: float = 0.1  # WSD: fraction of steps in the final decay


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` of a module or of a dict of tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as a
    float32 0-d tensor: linear warm-up, then constant, cosine, or WSD
    (warmup-stable-decay, MiniCPM's: stable at the peak until the last
    ``decay_frac`` of the steps, then down to 0.1 of it)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.peak_lr * warm
    if cfg.schedule == "cosine":
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        return cfg.peak_lr * warm * 0.5 * (1 + torch.cos(math.pi * t))
    if cfg.schedule != "wsd":
        raise ValueError(f"unknown schedule {cfg.schedule!r}; known: wsd, "
                         f"cosine, constant")
    decay_start = cfg.total_steps * (1 - cfg.decay_frac)
    t = torch.clamp((step - decay_start)
                    / max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
    return cfg.peak_lr * warm * (1.0 - 0.9 * t)


def init_state(params: Params) -> dict:
    """``{"m", "v"}``: float32 zeros leaf for leaf as the parameters, on
    their devices; ``"step"``: an int32 0-d tensor, 0."""
    named = named_params(params)
    dev = next(iter(named.values())).device if named else "cpu"
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in named.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of every leaf's squares)`` in float32, 0-d."""
    total = None
    for g in tree.values():
        sq = (g.float() ** 2).sum()
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Params, grads: Mapping[str, torch.Tensor],
                  state: dict, cfg: AdamWConfig, *, grad_norm=None):
    """One AdamW step -> ``(params, new_state, {"grad_norm", "lr"})``.

    ``grads`` has a leaf for every parameter (any float dtype).  The
    parameters, ``state["m"]`` and ``state["v"]`` are updated in place and
    returned; ``new_state["step"]`` is ``state["step"] + 1``.  ``grad_norm``
    is the clip's global norm when the caller computes it (a sharded step,
    whose leaves are shards); by default :func:`global_norm` of
    ``grads``."""
    named = named_params(params)
    step = state["step"] + 1
    lr = schedule(cfg, step).to(step.device)
    gnorm = (global_norm(grads) if grad_norm is None
             else grad_norm).to(step.device)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, step_f)
    c2 = 1.0 - torch.pow(b2, step_f)
    for name, p in named.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale.to(m.device)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = (m / c1.to(m.device)).div_(
            (v / c2.to(m.device)).sqrt_().add_(cfg.eps))
        pf = p.float()
        delta.add_(cfg.weight_decay * pf)
        p.copy_(pf - lr.to(m.device) * delta)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
