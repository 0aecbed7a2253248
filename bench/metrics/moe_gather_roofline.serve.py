"""The MoE gather's least time over the device time of its kernels, in
percent.  Every MoE layer of each traced prefill and decode step makes one
gather (frozen closed form): a prefill routes one sequence of ``plen``
tokens, a decode step one of a token for each slot, and the gather writes
every expert's capacity of each sequence as buffer rows and reads each
token once."""

from bench import model as bm, readings
from bench.costs import kernels as K


def read(rec):
    if rec.trace is None:
        return None
    moe = rec.cfg["moe"]
    capacity = bm.kind(rec.cfg, "mlp", "moe").capacity
    e = moe["num_experts"]
    calls = [(e * capacity(s.args["plen"], moe), s.args["plen"])
             for s in readings.prefills(rec)]
    calls += [(len(lengths) * e * capacity(1, moe), len(lengths))
              for _, lengths, _ in readings.decodes(rec)]
    if not calls:
        return None
    layers = sum(mlp == "moe" for _, mlp in bm.layer_kinds(rec.cfg))
    least = layers * sum(K.least_s(K.moe_gather_cost(
        rows, rec.cfg["d_model"], readings.ELEM, tokens))
        for rows, tokens in calls)
    return readings.share(least,
                          readings.class_seconds(rec.trace, "gather forward"))
