"""The prefills' model FLOPs (PaLM's count, each prompt attending its own
length) over their spans' time, as a share of the bf16 peak, in the part
of the window before the profiler starts."""

from bench import readings


def read(rec):
    spans = readings.prefills(rec, rec.untraced)
    return readings.mfu(readings.prefill_flops(rec, spans),
                        sum(s.t1 - s.t0 for s in spans))
