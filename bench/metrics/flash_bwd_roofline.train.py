"""The flash backward's least time (frozen closed form at the traced
steps' shapes: every layer's call of every microbatch) over the device
time of its kernels, in percent."""

from bench import readings
from bench.costs import kernels as K


def read(rec):
    tr = rec.trace
    if tr is None or not rec.steps_profiled:
        return None
    t, cfg = rec.traffic, rec.cfg
    hq, hkv, hd = readings.heads(cfg)
    call = K.least_s(K.flash_attention_backward_cost(
        t["rows"], hq, hkv, t["seq_len"], t["seq_len"], hd, readings.ELEM))
    calls = cfg["num_layers"] * t["microbatches"] * rec.steps_profiled
    return readings.share(call * calls,
                          readings.class_seconds(tr, "flash backward"))
