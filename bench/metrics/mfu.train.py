"""The training steps' model FLOPs (PaLM's count) as a share of the card's
bf16 peak, over the window's steps before the profiler starts (which it
does not slow; the traced steps where there are none)."""

from bench import readings
from bench.costs import model as M


def read(rec):
    t0, t1, steps = rec.untraced
    if steps < 1:
        if rec.trace is None or not rec.steps_profiled:
            return None
        t0, t1, steps = 0.0, rec.trace.window_s, rec.steps_profiled
    flops = M.train_flops(rec.cfg, steps * rec.tokens_per_step,
                          rec.traffic["seq_len"])
    return readings.mfu(flops, t1 - t0)
