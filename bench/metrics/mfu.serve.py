"""The model FLOPs of the prefills and decode steps over the time they
span, as a share of the bf16 peak, in the part of the window before the
profiler starts (each counted where its span lies inside it)."""

from bench import readings


def read(rec):
    lo, hi = rec.untraced
    flops = readings.prefill_flops(rec, readings.prefills(rec, (lo, hi))) \
        + readings.decode_flops(rec, readings.decodes(rec, (lo, hi)))
    return readings.mfu(flops, hi - lo) if flops else None
