"""The reference's first training steps: float32 forward and backward, a
layer recomputed at a time, and AdamW.

The configuration keeps its parameters in their own dtype between steps
(bfloat16: the update is computed in float32 and rounded back, with no
float32 copy), so the reference holds each parameter as float32 values
rounded to that dtype after every update.  Everything else is float32.
AdamW follows the configuration's optimizer: the gradient clipped by its
global norm, moments in float32, bias correction, ``delta = mhat /
(sqrt(vhat) + eps) + weight_decay * p``, the learning rate of the WSD
schedule with linear warm-up.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from bench import model as bm
from bench.reference import transformer as R


def learning_rate(opt: dict, step: int) -> float:
    """The WSD schedule: linear warm-up, flat, then a linear decay to a
    tenth over the last ``decay_frac`` of ``total_steps``."""
    if opt["schedule"] != "wsd":
        raise ValueError(f"schedule {opt['schedule']!r}: the reference "
                         f"follows only wsd")
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    decay_start = opt["total_steps"] * (1 - opt["decay_frac"])
    t = min(max((step - decay_start)
                / max(opt["total_steps"] - decay_start, 1), 0.0), 1.0)
    return opt["peak_lr"] * warm * (1.0 - 0.9 * t)


def loss_of_row(params: Dict[str, torch.Tensor], tokens, labels, cfg: dict,
                pr: R.Products, aux_weight: float):
    """One row's loss: mean NLL plus ``aux_weight`` times the MoE layers'
    load-balance losses, each layer recomputed in the backward."""
    x = R.embed(tokens, params, cfg)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["num_layers"]):
        def run(x, i=i):
            y, a = R.layer(x, params, i, cfg, pr, routed=x.shape[0])
            return y, (a if a is not None else torch.zeros((),
                                                           device=x.device))
        x, a = checkpoint(run, x, use_reentrant=False)
        aux = aux + a
    return R.nll(R.logits(x, params, cfg, pr), labels) + aux_weight * aux


def reference_steps(cfg: dict, seed: int, batches: List[Dict[str,
                    torch.Tensor]], opt: dict, device, products="float32",
                    aux_weight: float = 0.01) -> dict:
    """The first ``len(batches)`` steps from the seeded weights.  Each
    batch has ``tokens`` and ``labels`` ``[k, mb, S]``.  Returns the
    steps' losses, each leaf's norm of the first clipped gradient, and
    each leaf's norm of the change after the last step."""
    R.strict_float32()
    pr = R.Products(products)
    groups = bm.plan(cfg)
    dtypes = {leaf.name: leaf.dtype for g in groups for leaf in g}
    params = {}
    for gi in range(len(groups)):
        for name, t in bm.group_weights(cfg, seed, gi, device,
                                        groups).items():
            params[name] = t.float().requires_grad_(True)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first_grad = [], {}
    for step, batch in enumerate(batches, start=1):
        k, mb = batch["tokens"].shape[:2]
        total = 0.0
        for i in range(k):
            for r in range(mb):
                loss = loss_of_row(params, batch["tokens"][i, r],
                                   batch["labels"][i, r], cfg, pr,
                                   aux_weight) / (k * mb)
                loss.backward()
                total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {n: p.grad for n, p in params.items()}
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = min(opt["clip_norm"] / max(float(gnorm), 1e-9), 1.0)
            lr = learning_rate(opt, step)
            c1 = 1.0 - opt["b1"] ** step
            c2 = 1.0 - opt["b2"] ** step
            for n, p in params.items():
                g = grads[n] * scale
                if step == 1:
                    first_grad[n] = float(g.norm())
                m[n].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v[n].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                delta = (m[n] / c1) / ((v[n] / c2).sqrt() + opt["eps"]) \
                    + opt["weight_decay"] * p
                p.copy_((p - lr * delta).to(dtypes[n]).float())
                p.grad = None
    del m, v
    change = {}
    with torch.no_grad():
        for gi in range(len(groups)):
            for name, t in bm.group_weights(cfg, seed, gi, device,
                                            groups).items():
                change[name] = float((params[name] - t.float()).norm())
    return {"losses": losses, "first_grad": first_grad, "change": change}
