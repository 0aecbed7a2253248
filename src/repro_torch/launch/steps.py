"""The training step: microbatch gradients accumulated, then AdamW.

Port of ``build_train_step`` (``repro/launch/steps.py``) without the
sharding rules: one card.  The step is the paper's S3 and S5 at the
training level: the ``k`` microbatches' gradients are summed locally in
``grad_accum_dtype`` (an accumulator whose flush period is ``k``), and the
optimizer's update commits them (the separate state section).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.launch.cells import CellKnobs
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.optim import adamw

__all__ = ["accumulate_grads", "build_train_step", "default_opt_config"]


def default_opt_config(cfg: ModelConfig) -> adamw.AdamWConfig:
    """The reference's choice: WSD for MiniCPM-2B, cosine otherwise."""
    return adamw.AdamWConfig(
        schedule="wsd" if cfg.name == "minicpm-2b" else "cosine")


def accumulate_grads(params, batch, run_cfg: ModelConfig,
                     accum_dtype: torch.dtype = torch.float32):
    """The S3 half of the step: ``(mean loss, {name: gradient})``, the
    gradients of the ``k`` microbatches of ``batch`` (leaves ``[k, mb,
    ...]``; ``[mb, S]`` leaves are one microbatch) summed in
    ``accum_dtype`` and divided by ``k``, each microbatch's by autograd
    through ``train_forward(params, mb, run_cfg)``.  Marks the parameters
    as requiring grad."""
    named = adamw.named_params(params)
    leaves = list(named.values())
    for p in leaves:
        p.requires_grad_(True)
    if batch["tokens"].dim() == 2:
        batch = {key: val[None] for key, val in batch.items()}
    k = batch["tokens"].shape[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = None
    for i in range(k):
        mb = {key: val[i] for key, val in batch.items()}
        with torch.enable_grad():
            loss, _ = T.train_forward(params, mb, run_cfg)
            # a leaf outside the graph (a router bias only picks experts)
            # gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if acc is None:
            acc = [g.to(accum_dtype) for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.to(accum_dtype))
        loss_sum = loss_sum + loss.detach()
        del grads, loss
    return loss_sum / k, {name: a.div_(k) for name, a in zip(named, acc)}


def build_train_step(cfg: ModelConfig, knobs: CellKnobs,
                     opt_cfg: Optional[adamw.AdamWConfig] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``.

    ``batch`` leaves have a leading ``[k, mb, ...]`` (``k`` microbatches
    of ``mb`` rows, :class:`~repro_torch.data.pipeline.SyntheticLM` with
    ``microbatches=k``); a batch of ``[mb, S]`` leaves is one microbatch.
    The step takes :func:`accumulate_grads` (``train_forward`` with
    ``knobs.remat``, gradients summed in ``knobs.grad_accum_dtype`` and
    divided by ``k``) and applies
    :func:`~repro_torch.optim.adamw.apply_updates`.  The parameters
    (marked as requiring grad) and the optimizer state are updated in
    place and returned.  ``loss`` is the mean of the microbatches' losses;
    all three metrics are float32 0-d tensors."""
    run_cfg = dataclasses.replace(cfg, remat=knobs.remat)
    accum_dtype = torch_dtype(knobs.grad_accum_dtype)
    if opt_cfg is None:
        opt_cfg = default_opt_config(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(params, batch, run_cfg, accum_dtype)
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step
