"""The flash forward's least time (frozen closed form: every layer's
causal call over each traced prompt) over the device time of its kernels,
in percent."""

from bench import readings
from bench.costs import kernels as K


def read(rec):
    if rec.trace is None:
        return None
    hq, hkv, hd = readings.heads(rec.cfg)
    total = sum(K.least_s(K.flash_attention_cost(
        1, hq, hkv, s.args["plen"], s.args["plen"], hd, readings.ELEM))
        for s in readings.prefills(rec))
    return readings.share(rec.cfg["num_layers"] * total,
                          readings.class_seconds(rec.trace, "flash forward"))
