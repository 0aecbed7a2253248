"""Training steps of ``launch.steps.build_train_step``, back to back.

Set-up builds the model from the seeded weights, the step and AdamW's
state, and drives the first ``compared_steps`` steps through the window's
own call and feed (which warms every shape the window uses); the program's
losses, first gradient (from AdamW's first moment after one step) and
change of every leaf are read there.  The window then runs steps until
``--seconds`` have passed, each ending in a host read of its loss.  A
traced run calls ``accumulate_grads`` and then ``apply_updates``, as the
step does, with CUDA events around the update, and profiles the window's
last ``trace_seconds`` (``bench.trace.Profiler``).  After the window the
program's state is freed and the reference runs the compared steps.
"""

from __future__ import annotations

import dataclasses
import math
import types

import torch

from bench import compare, model as bm, window, workload
from bench.drivers import Context, Outcome, now, peak_bytes, release, \
    reset_peak, sync
from bench.reference.train import reference_steps
from bench.trace import Profiler


def timing_events(device):
    """A recorded CUDA start event and its end event, on the card."""
    if device.type != "cuda":
        return None
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    return e0, e1


def leaf_norms(tensors) -> dict:
    names = list(tensors)
    vals = torch.stack([tensors[n].float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


@torch.no_grad()
def change_norms(model, cfg: dict, seed: int) -> dict:
    """Each leaf's norm of its change from the seeded weights."""
    params = dict(model.named_parameters())
    groups = bm.plan(cfg)
    diffs = {}
    for gi in range(len(groups)):
        for name, t in bm.group_weights(cfg, seed, gi, params["embed"].device,
                                        groups).items():
            diffs[name] = (params[name].float() - t.float()).norm()
    names = list(diffs)
    return dict(zip(names, torch.stack([diffs[n] for n in names]).tolist()))


def run(ctx: Context) -> Outcome:
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import CellKnobs
    from repro_torch.models import transformer as T
    from repro_torch.models.config import torch_dtype
    from repro_torch.optim import adamw

    tr, dev, cfg = ctx.traffic, ctx.device, ctx.cfg
    mcfg = bm.port_config(cfg)
    model = T.Transformer(mcfg, device=dev)
    bm.load_into(model, cfg, ctx.seed)
    knobs = CellKnobs(microbatches=tr["microbatches"], remat=tr["remat"],
                      grad_accum_dtype=tr["grad_accum_dtype"])
    opt_cfg = adamw.AdamWConfig(**tr["optimizer"])
    opt = adamw.init_state(model)
    prof = Profiler(ctx.trace, dev, tr["trace_seconds"])
    update_events = []

    if ctx.trace:
        run_cfg = dataclasses.replace(mcfg, remat=knobs.remat)
        accum = torch_dtype(knobs.grad_accum_dtype)

        def call(params, state, batch):
            with prof.range("grads"):
                loss, grads = S.accumulate_grads(params, batch, run_cfg,
                                                 accum)
            events = timing_events(dev)
            with prof.range("adamw"):
                params, state, om = adamw.apply_updates(params, grads, state,
                                                        opt_cfg)
            if events:
                events[1].record()
                update_events.append(events)
            return params, state, {"loss": loss, **om}
    else:
        call = S.build_train_step(mcfg, knobs, opt_cfg)

    vocab = cfg["vocab_size"]

    def batch(i):
        return workload.train_batch(tr, ctx.seed, i, vocab, dev)

    n_cmp = tr["compared_steps"]
    prog = {"losses": []}
    for i in range(n_cmp):
        model, opt, m = call(model, opt, batch(i))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            b1 = 1.0 - opt_cfg.b1
            prog["first_grad"] = {n: v / b1
                                  for n, v in leaf_norms(opt["m"]).items()}
    prog["change"] = change_norms(model, cfg, ctx.seed)
    update_events.clear()
    sync(dev)

    t0 = now()
    setup_s = t0 - ctx.t_start
    reset_peak(dev)
    ends, failed, i = [], 0, n_cmp
    while True:
        prof.maybe_start(now(), t0, ctx.seconds)
        with prof.range("step"):
            model, opt, m = call(model, opt, batch(i))
            failed += not math.isfinite(float(m["loss"]))
        t = now()
        ends.append(t)
        prof.tick(t)
        i += 1
        if t - t0 >= ctx.seconds and prof.complete():
            break
    prof.stop(now())
    peak = peak_bytes(dev)
    tokens = tr["microbatches"] * tr["rows"] * tr["seq_len"]
    nums = window.train_numbers(ends, tokens, t0)
    adamw_ms = [a.elapsed_time(b) for a, b in update_events]
    trace = prof.result()

    del model, opt, m, call
    release(dev)
    batches = [batch(j) for j in range(n_cmp)]
    t_ref = now()
    ref = reference_steps(cfg, ctx.seed, batches, tr["optimizer"], dev)
    notes = {"reference_s": now() - t_ref}
    checks = compare.train_checks(prog, ref)
    if ctx.control:
        low = reference_steps(cfg, ctx.seed, batches, tr["optimizer"], dev,
                              products="fp8")
        notes["control"] = compare.train_checks(low, ref)
        # step 3's fault, planted in the reference: half of each batch left
        # out, the mean taken over the rest
        half = [{n: v[:v.shape[0] // 2] for n, v in b.items()}
                for b in batches]
        notes["half_batch"] = compare.train_checks(
            reference_steps(cfg, ctx.seed, half, tr["optimizer"], dev), ref)
    untraced_end = prof.started or ends[-1]
    record = types.SimpleNamespace(
        cfg=cfg, traffic=tr, trace=trace, steps_profiled=prof.counted,
        tokens_per_step=tokens, adamw_ms=adamw_ms,
        untraced=(t0, untraced_end, sum(e <= untraced_end for e in ends)))
    if trace is not None:
        notes["traced"] = {"steps": prof.counted,
                           "by_class": trace.by_class(),
                           "range_device_s": trace.range_device_s}
    return Outcome(
        numbers={"train_tokens_per_s": nums["train_tokens_per_s"],
                 "setup_s": setup_s},
        attempted=nums["attempted"], failed=failed, memory_peak_bytes=peak,
        checks=checks, record=record,
        notes={**notes, "steps_in_window": len(ends),
               "step_s": [b - a for a, b in zip([t0] + ends, ends)],
               "window_s": ends[-1] - t0,
               "losses": prog["losses"], "reference_losses": ref["losses"]})
