"""Fault-tolerant training driver (checkpoint / restart / elastic resize).

Port of ``repro/ft/driver.py``.  Per the paper's farm: the stream
(:mod:`repro_torch.data.pipeline`) feeds the training step, whose state
kinds follow the access patterns:

* S3 accumulator: gradient accumulation inside the train step (flush
  period ``microbatches``) and the loss sums here (local partial sums,
  flushed every ``metric_flush_every`` steps);
* S5 separate task/state: forward and backward, then the AdamW commit;
* S4 successive approximation: :class:`BestTracker`, a monotone best-loss
  register whose non-improving proposals are discarded;
* adaptivity: the degree decision is the runtime's
  :class:`~repro_torch.runtime.autoscaler.Autoscaler`'s, consulted at
  checkpoints; the state transition is :func:`elastic_resize`, a restore of
  the newest checkpoint (on one card the "new shardings" are a device).

A failure (an :class:`InjectedFailure`) falls back to the newest complete
checkpoint: the parameters, the optimizer state and the stream cursor are
restored, the partial loss sums dropped, and the deterministic stream makes
the rerun bit-exact, as in the reference (on the card, under
``torch.use_deterministic_algorithms(True)``).

The checkpoint holds ``(parameters, optimizer state)`` under the
reference's leaf names and shapes (:func:`repro_torch.interop.
params_to_reference` and ``opt_state_to_reference``, parameters in their own
dtype, bfloat16 as the reference writes it), so the two packages read each
other's training directories (:mod:`repro_torch.checkpoint.checkpoint`
says which way bfloat16 goes).  The parameters and the optimizer state are
restored in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import interop
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.data.pipeline import StreamState, SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.metrics import ChunkRecord, MetricsBus

__all__ = ["BestTracker", "InjectedFailure", "TrainLoop", "elastic_resize",
           "state_template"]


class InjectedFailure(RuntimeError):
    """Simulated node failure (tests / chaos drills)."""


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def elastic_resize(ckpt_dir: str, template, device=None):
    """Checkpoint-mediated resize: restore the newest checkpoint of
    ``ckpt_dir`` into ``template``'s structure; with ``device`` every tensor
    leaf is placed there (one card's "new shardings").  Returns ``(state,
    metadata)``; raises ``FileNotFoundError`` when there is no checkpoint:
    a transition without a committed state has nothing to hand off."""
    latest = ckpt_lib.latest_step(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(
            f"elastic resize needs a checkpoint in {ckpt_dir!r}; none found")
    state, meta = ckpt_lib.restore(ckpt_dir, latest, template)
    if device is not None:
        state = _map_tensors(state, lambda t: t.to(device))
    return state, meta


def state_template(params, cfg: ModelConfig):
    """The restore template of a training checkpoint: the reference's
    ``(params, {"m", "v", "step"})`` structure with placeholder CPU tensors
    as leaves (a restore reads every leaf to the CPU)."""
    empty = torch.empty(0)
    tree = interop.reference_tree(params, cfg, lambda n: empty,
                                  lambda leaves: empty)
    return tree, {"m": tree, "v": tree, "step": empty}


@dataclasses.dataclass
class BestTracker:
    """S4 successive-approximation state: monotone min-loss register."""

    best: float = float("inf")
    step: int = -1

    def propose(self, value: float, step: int) -> bool:
        if value < self.best:  # monotone accept; else discard (collector rule)
            self.best, self.step = float(value), step
            return True
        return False


@dataclasses.dataclass
class TrainLoop:
    train_step: Callable          # (params, opt_state, batch) -> (p, o, metrics)
    data: SyntheticLM
    ckpt_dir: str
    cfg: ModelConfig              # names the checkpoint's leaves
    ckpt_every: int = 10
    metric_flush_every: int = 5   # S3 flush period for host metrics
    fail_at: Optional[int] = None  # inject a failure BEFORE this step once
    # -- elastic path: degree decisions delegated to the runtime autoscaler --
    autoscaler: Optional[object] = None   # runtime.autoscaler.Autoscaler
    degree: int = 1                        # current data-parallel degree
    on_resize: Optional[Callable[[int], None]] = None  # rebuilds the step
    metrics_bus: Optional[MetricsBus] = None

    def _maybe_autoscale(self, step: int, log) -> None:
        """Consulted at checkpoint boundaries (the loop's quiescent points,
        where `elastic_resize` has a fresh state to hand off)."""
        if self.autoscaler is None or self.metrics_bus is None:
            return
        target = self.autoscaler.propose(self.metrics_bus, self.degree)
        self.autoscaler.tick()
        if target is None:
            return
        log(f"[elastic] step {step}: autoscaler proposes degree "
            f"{self.degree} -> {target}")
        if self.on_resize is not None:
            self.on_resize(target)  # caller runs elastic_resize + rebuild
        self.degree = target
        self.autoscaler.notify_resized()

    def _save(self, step, params, opt_state, stream, best) -> None:
        tree = (interop.params_to_reference(params, self.cfg,
                                            keep_dtype=True),
                interop.opt_state_to_reference(opt_state, params, self.cfg,
                                               keep_dtype=True))
        ckpt_lib.save(self.ckpt_dir, step, tree,
                      metadata={"stream": stream.to_dict(), "best": best.best})

    def _restore(self, step, params, opt_state):
        """Load checkpoint ``step`` into ``params`` and ``opt_state`` in
        place; returns the stream cursor."""
        (p_tree, o_tree), meta = ckpt_lib.restore(
            self.ckpt_dir, step, state_template(params, self.cfg))
        interop.load_reference_(params, p_tree, self.cfg)
        interop.load_opt_state_(opt_state, o_tree, params, self.cfg)
        return StreamState.from_dict(meta["stream"])

    def run(self, params, opt_state, num_steps: int, *, log=print):
        stream = StreamState(0)
        start = 0
        latest = ckpt_lib.latest_step(self.ckpt_dir)
        if latest is not None:
            stream = self._restore(latest, params, opt_state)
            start = latest
            log(f"[ft] restored step {latest}")

        best = BestTracker()
        loss_acc, acc_n = 0.0, 0
        failed_once = False
        step = start
        while step < num_steps:
            try:
                if (self.fail_at is not None and step == self.fail_at
                        and not failed_once):
                    failed_once = True
                    raise InjectedFailure(f"injected failure at step {step}")
                batch = self.data.batch_at(stream.position)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
                t1 = time.perf_counter()
                if self.metrics_bus is not None:
                    self.metrics_bus.record_chunk(ChunkRecord(
                        t_start=t0, t_end=t1, m=1, n_workers=self.degree,
                        queue_depth=0))
                stream = StreamState(stream.position + 1)
                step += 1
                # S3: accumulate locally, flush periodically
                loss_acc += float(metrics["loss"])
                acc_n += 1
                if step % self.metric_flush_every == 0:
                    mean = loss_acc / acc_n
                    improved = best.propose(mean, step)
                    log(f"[train] step {step} loss {mean:.4f}"
                        + (" (best)" if improved else ""))
                    loss_acc, acc_n = 0.0, 0
                if step % self.ckpt_every == 0:
                    self._save(step, params, opt_state, stream, best)
                    self._maybe_autoscale(step, log)
            except InjectedFailure as e:
                log(f"[ft] {e}; restarting from checkpoint")
                latest = ckpt_lib.latest_step(self.ckpt_dir)
                loss_acc, acc_n = 0.0, 0  # discard pre-failure partials
                if latest is None:
                    stream = StreamState(0)
                    step = 0
                    continue
                stream = self._restore(latest, params, opt_state)
                step = latest
        return params, opt_state, best
