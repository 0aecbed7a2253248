"""Device ms a training step spends in kernels that are neither products,
the port's kernels nor AdamW's (those launched inside the update's
``bench.adamw`` range): autograd's eager rest."""

from bench import readings


def read(rec):
    tr = rec.trace
    if tr is None or not rec.steps_profiled:
        return None
    other = readings.class_seconds(tr, "other")
    update = tr.range_device_s.get("bench.adamw", 0.0)
    return 1e3 * (other - update) / rec.steps_profiled
