"""What the per-layer readers (``bench/metrics/<metric>.py``) share: the
launches a traced stretch made, worked out from the records of the run,
and the shares they turn into.

A serving run's record holds the engine's spans (``prefill`` with its
``rid`` and ``plen``, ``decode``), its ``serving.load`` counter, each decode
step's slot lengths and active slots, and the clients' request logs; the
profiled stretch is ``record.profiled`` and the window ``record.window``,
both on the host's clock.  Kernel times come from the profiled stretch;
shares of the peak over host time from ``record.untraced``, the part of
the window before the profiler started (the whole window when it never
did), which carries no profiler's cost on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from bench import model as bm
from bench.costs import kernels as K
from bench.costs import model as M
from bench.trace import kernel_class

ELEM = 2    # bfloat16 activations and caches


def share(least_s: float, measured_s: float) -> Optional[float]:
    """A least time as a percentage of a measured one; None where nothing
    was measured."""
    return 100.0 * least_s / measured_s if measured_s > 0 else None


def class_seconds(trace, label: str) -> float:
    return trace.seconds_by(lambda n: kernel_class(n) == label)[0]


def idle_share(rec) -> Optional[float]:
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def _within(span, lo, hi) -> bool:
    return lo is not None and lo <= span.t0 and span.t1 <= hi


def prefills(rec, stretch=None) -> List:
    """The ``prefill`` spans inside ``stretch`` (default: the profiled
    stretch)."""
    lo, hi = stretch or rec.profiled
    return [s for s in rec.spans if s.name == "prefill"
            and _within(s, lo, hi)]


def decodes(rec, stretch=None) -> List[Tuple]:
    """(span, every slot's cache length, active slots) of each decode step
    inside ``stretch`` (default: the profiled stretch)."""
    lo, hi = stretch or rec.profiled
    spans = [s for s in rec.spans if s.name == "decode"]
    return [(s, lengths, active) for s, (lengths, active)
            in zip(spans, rec.decodes) if _within(s, lo, hi)]


def prefill_flops(rec, spans) -> float:
    flops = M.forward_counter(rec.cfg)
    return sum(flops(s.args["plen"], s.args["plen"]) for s in spans)


def decode_flops(rec, steps) -> float:
    flops = M.forward_counter(rec.cfg)
    return sum(flops(1, int(lengths[a]) + 1)
               for _, lengths, active in steps for a in active)


def heads(cfg: dict):
    return cfg["num_heads"], cfg["num_kv_heads"], bm.head_dim(cfg)


def mfu(flops: float, seconds: float) -> Optional[float]:
    return share(flops / K.PEAK_BF16_S, seconds)
