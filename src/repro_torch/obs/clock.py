"""Pluggable clocks shared by the tracer and the metrics bus.

One implementation serves real runs and discrete-event simulations: the
:class:`WallClock` reads ``time.perf_counter`` and the :class:`LogicalClock`
advances only when told — a trace or metrics report produced under a logical
clock is bit-deterministic, which is how the elastic-runtime benchmark and
the obs tests pin exact timelines.

(The classes used to live in :mod:`repro_torch.runtime.metrics`; that module
re-exports them, so existing imports keep working.)
"""

from __future__ import annotations

import time


class WallClock:
    def now(self) -> float:
        return time.perf_counter()


class LogicalClock:
    """Deterministic clock for simulated runs: advances only via `advance`."""

    def __init__(self, t0: float = 0.0):
        self._t = t0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("time cannot go backwards")
        self._t += dt
        return self._t
