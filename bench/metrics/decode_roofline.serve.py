"""The decode kernel's least time (frozen closed form: every layer's call
over every slot's admitted cache rows, by the kernel's own rule) over the
device time of its kernels, in percent."""

from bench import readings
from bench.costs import kernels as K


def read(rec):
    if rec.trace is None:
        return None
    hq, hkv, hd = readings.heads(rec.cfg)
    s_max = rec.traffic["s_max"]
    total = sum(K.least_s(K.decode_attention_cost(
        len(lengths), hq, hkv, hd, readings.ELEM,
        K.decode_rows(lengths + 1, 0, s_max)))
        for _, lengths, _ in readings.decodes(rec))
    return readings.share(rec.cfg["num_layers"] * total,
                          readings.class_seconds(rec.trace, "decode"))
