"""Analytic performance models from the paper (§2, §4, §5).

Used by the benchmark harness to overlay "ideal" curves (the paper plots
measured-vs-ideal) and by the runtime to choose flush periods.
"""

from __future__ import annotations

import dataclasses


def service_time(t_a: float, t_f: float, n_w: int) -> float:
    """Paper §2: ``T_s(n_w) = max(t_a, t_f / n_w)``."""
    return max(t_a, t_f / n_w)


def completion_time(m: int, t_a: float, t_f: float, n_w: int) -> float:
    """Paper §2: ``T_c(n_w, m) = m * T_s(n_w)``."""
    return m * service_time(t_a, t_f, n_w)


def ideal_completion(m: int, t_f: float, t_s: float, n_w: int) -> float:
    """Paper eq. (2): ``m (t_f + t_s) / n_w`` (accumulator ideal)."""
    return m * (t_f + t_s) / n_w


def separate_speedup(n_w: int, t_f: float, t_s: float) -> float:
    """Paper §4.5: measured-model speedup ``n_w (t_f+t_s) / (n_w t_s + t_f)``."""
    return n_w * (t_f + t_s) / (n_w * t_s + t_f)


def separate_speedup_bound(t_f: float, t_s: float) -> float:
    """Paper eq. (1): ``lim speedup = t_f / t_s + 1``."""
    return t_f / t_s + 1.0


def paper_flush_threshold(t_f: float, t_acc: float, n_w: int) -> float:
    """Paper §5 (Fig. 4 discussion), verbatim: the update period should exceed
    ``t_f * n_w / t_acc`` "such that when a new update comes to the collector
    the old ones have already been accumulated"."""
    return t_f * n_w / t_acc


def stable_flush_period(t_f: float, t_acc: float, n_w: int) -> float:
    """Queueing-stability derivation of the same rule.

    The collector serves one update in ``t_acc``; each of the ``n_w`` workers
    emits one update every ``k * t_f`` seconds.  Stability of the collector
    queue requires  ``n_w / (k t_f) < 1 / t_acc``  i.e. ``k > n_w t_acc / t_f``.

    Note: this differs from :func:`paper_flush_threshold` by the ratio
    ``(t_f/t_acc)^2`` — the two coincide when ``t_f ~= t_acc`` (the regime of
    the paper's Fig. 4, where ``t_f = 2 t_acc``).  The queueing form is the
    one :func:`repro_torch.core.simulator.simulate_accumulator` reproduces;
    the farm it models runs as :class:`repro_torch.core.patterns.AccumulatorState`.
    """
    return n_w * t_acc / t_f


def accumulator_completion(
    m: int, t_f: float, t_acc: float, n_w: int, flush_every: int
) -> float:
    """Completion-time model with an explicit collector term.

    Workers: ``m/n_w`` tasks of ``t_f`` each plus one local fold ``t_acc`` per
    task; collector: ``m/flush_every`` updates of ``t_acc`` each, serialized.
    The farm finishes when the slower of the two pipelines drains.
    """
    worker_time = (m / n_w) * (t_f + t_acc)
    collector_time = (m / flush_every) * t_acc
    return max(worker_time, collector_time)


def partitioned_completion(
    m: int, t_f: float, t_s: float, load_fractions
) -> float:
    """§4.2: completion = the most loaded worker; ``load_fractions[w]`` is the
    fraction of the stream hashed to worker ``w`` (sums to 1)."""
    return m * max(load_fractions) * (t_f + t_s)


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term roofline for one step on ``chips`` cards.

    Times in seconds.  The defaults are NVIDIA's published H100 SXM peaks
    (dense, at the full 700 W power limit): bf16 tensor-core rate, HBM3
    bandwidth, and NVLink bandwidth each way per card.
    """

    flops: float              # operations of the whole step
    hbm_bytes: float          # device-memory bytes moved
    collective_bytes: float   # summed collective operand bytes
    chips: int
    peak_flops: float = 989e12   # H100 SXM bf16 dense, per card
    hbm_bw: float = 3.35e12      # bytes/s per card
    link_bw: float = 450e9       # NVLink bytes/s each way per card

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * self.link_bw)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time: the max term (perfect overlap of the rest)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def mfu_upper_bound(self, model_flops: float) -> float:
        """Achievable MFU if the step ran at the roofline bound."""
        return model_flops / (self.chips * self.peak_flops * self.step_time)
