"""The decode steps' model FLOPs (PaLM's count, one token for each active
slot attending its cache) over their spans' time, as a share of the bf16
peak, in the part of the window before the profiler starts."""

from bench import readings


def read(rec):
    steps = readings.decodes(rec, rec.untraced)
    return readings.mfu(readings.decode_flops(rec, steps),
                        sum(s.t1 - s.t0 for s, _, _ in steps))
