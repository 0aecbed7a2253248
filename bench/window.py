"""A window's end-to-end numbers from its records, on the host's clock.

A window runs from ``t0`` to ``t_end``, the end of the first step or tick
that finishes at least ``--seconds`` after ``t0``: every step or tick in
it is counted whole, and every second of it is counted.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


def p95(values: Sequence[float]) -> float:
    """The 95th percentile; NaN of no values (a reader then reports
    nothing)."""
    if not len(values):
        return float("nan")
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


@dataclasses.dataclass
class RequestLog:
    """One client request: when it was issued, its prompt's length, and
    when each of its tokens reached the host."""
    rid: int
    issue: float
    prompt_len: int
    max_new: int
    token_times: List[float] = dataclasses.field(default_factory=list)
    failed: bool = False

    @property
    def done(self) -> bool:
        return len(self.token_times) >= self.max_new


def serve_numbers(logs: Sequence[RequestLog], t0: float,
                  t_end: float) -> dict:
    """``serve_tokens_per_s``: prompt tokens prefilled (a prompt counts
    when its first token arrives) and tokens generated inside the window,
    over the window.  ``ttft_p95_ms``: over every request issued in the
    window, from its issue to its first token; one still unanswered at the
    window's end counts its wait so far, a failed one counts as missing
    (infinite).  ``itl_p95_ms``: over every gap between two consecutive
    tokens of a request that ends inside the window."""
    span = t_end - t0
    tokens, ttft, gaps, attempted, failed = 0, [], [], 0, 0
    for r in logs:
        inside = [t for t in r.token_times if t0 < t <= t_end]
        tokens += len(inside)
        if r.token_times and t0 < r.token_times[0] <= t_end:
            tokens += r.prompt_len
        if t0 <= r.issue <= t_end:
            attempted += 1
            if r.failed:
                failed += 1
                ttft.append(float("inf"))
            elif r.token_times and r.token_times[0] <= t_end:
                ttft.append(r.token_times[0] - r.issue)
            else:
                ttft.append(t_end - r.issue)
        gaps += [b - a for a, b in zip(r.token_times, r.token_times[1:])
                 if t0 < b <= t_end]
    return {"serve_tokens_per_s": tokens / span,
            "ttft_p95_ms": p95(ttft) * 1e3,
            "itl_p95_ms": p95(gaps) * 1e3,
            "attempted": attempted, "failed": failed,
            "requests_in_window": len(ttft), "gaps_in_window": len(gaps)}


def train_numbers(step_ends: Sequence[float], tokens_per_step: int,
                  t0: float) -> dict:
    """``train_tokens_per_s``: the tokens of every step of the window over
    the window, which ends with its last step."""
    return {"train_tokens_per_s":
            tokens_per_step * len(step_ends) / (step_ends[-1] - t0),
            "attempted": len(step_ends)}
