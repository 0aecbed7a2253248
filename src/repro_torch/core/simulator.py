"""Discrete-event simulator of the stateful task farm (paper §5 methodology).

Port of ``repro/core/simulator.py``: numpy and ``heapq`` only, with the
reference's own random draws (``np.random.default_rng(seed)``), so every
``SimResult`` equals the reference's for the same arguments.

The paper's experiments run *synthetic* applications: dummy computations that
spend calibrated amounts of time (t_f, t_s, t_c, ...) inside the FastFlow farm
implementation schemas of §4.  This module is a deterministic discrete-event
model of emitter / workers / collector (+ feedback channel) that reproduces
the paper's Figs. 3-9; the analytic models it is checked against are
:mod:`repro_torch.core.analytics`, and the farm it models runs as
:mod:`repro_torch.core.patterns`.

Scheduling is on-demand (earliest-free worker pulls the next task), matching
FastFlow's default farm; communication latency defaults to the paper's quoted
10-40 cycle lock-free queues (negligible at the simulated time scales but kept
explicit).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class SimResult:
    completion_time: float
    m: int
    n_workers: int
    worker_busy_frac: float      # mean busy fraction over workers
    collector_busy_frac: float   # collector busy fraction (0 if no collector)
    state_updates_sent: int = 0
    state_updates_discarded: int = 0  # §4.4 non-monotone proposals

    @property
    def throughput(self) -> float:
        return self.m / self.completion_time


def _arrivals(m: int, t_a: float) -> np.ndarray:
    return np.arange(m) * t_a


# ---------------------------------------------------------------------------
# §4.1 Serial
# ---------------------------------------------------------------------------

def simulate_serial(m: int, t_f: float, t_s: float, t_a: float = 0.0) -> SimResult:
    t = 0.0
    for a in _arrivals(m, t_a):
        t = max(t, a) + t_f + t_s
    busy = m * (t_f + t_s) / t if t > 0 else 1.0
    return SimResult(t, m, 1, busy, 0.0)


# ---------------------------------------------------------------------------
# §4.2 Fully partitioned
# ---------------------------------------------------------------------------

def simulate_partitioned(
    m: int,
    n_w: int,
    t_f: float,
    t_s: float,
    *,
    t_a: float = 0.0,
    skew: float = 0.0,
    seed: int = 0,
) -> SimResult:
    """Tasks are pre-routed by the hash: worker w receives a fixed fraction.

    ``skew=0`` is a perfectly fair hash; ``skew>0`` draws worker loads from a
    Zipf-like distribution with exponent ``skew`` (paper: an unfair ``h``
    impairs speedup by a proportional factor).
    """
    rng = np.random.default_rng(seed)
    if skew == 0.0:
        counts = np.full(n_w, m // n_w)
        counts[: m % n_w] += 1
    else:
        weights = (1.0 / np.arange(1, n_w + 1) ** skew)
        weights /= weights.sum()
        counts = rng.multinomial(m, weights)
    per_task = t_f + t_s
    finish = counts * per_task
    # arrivals: worker w's last task arrives ~ at its stream position; for
    # t_a ~ 0 the max-load term dominates (paper's model).
    completion = max(finish.max(), (m - 1) * t_a + per_task)
    busy = float(finish.sum() / (n_w * completion)) if completion else 1.0
    return SimResult(float(completion), m, n_w, busy, 0.0)


# ---------------------------------------------------------------------------
# §4.3 Accumulator
# ---------------------------------------------------------------------------

def simulate_accumulator(
    m: int,
    n_w: int,
    t_f: float,
    t_acc: float,
    *,
    flush_every: int = 1,
    t_a: float = 0.0,
    t_comm: float = 0.0,
) -> SimResult:
    """Workers fold locally (t_acc per task) and flush an update message to the
    collector every ``flush_every`` tasks; the collector folds each incoming
    update in ``t_acc`` (FIFO).  Reproduces Figs. 3/4/8/9.
    """
    arrivals = _arrivals(m, t_a)
    workers = [(0.0, w) for w in range(n_w)]
    heapq.heapify(workers)
    tasks_since_flush = np.zeros(n_w, dtype=np.int64)
    collector_free = 0.0
    collector_busy = 0.0
    updates = 0
    worker_busy = 0.0
    last_finish = 0.0

    for i in range(m):
        free_at, w = heapq.heappop(workers)
        start = max(free_at, arrivals[i])
        done = start + t_f + t_acc
        worker_busy += t_f + t_acc
        tasks_since_flush[w] += 1
        if tasks_since_flush[w] >= flush_every:
            tasks_since_flush[w] = 0
            updates += 1
            send = done + t_comm
            begin = max(send, collector_free)
            collector_free = begin + t_acc
            collector_busy += t_acc
        last_finish = max(last_finish, done)
        heapq.heappush(workers, (done, w))

    # final flush of any residual local accumulators (paper: on termination)
    for w in range(n_w):
        if tasks_since_flush[w] > 0:
            updates += 1
            begin = max(last_finish + t_comm, collector_free)
            collector_free = begin + t_acc
            collector_busy += t_acc

    completion = max(last_finish, collector_free)
    return SimResult(
        completion,
        m,
        n_w,
        worker_busy / (n_w * completion) if completion else 1.0,
        collector_busy / completion if completion else 0.0,
        state_updates_sent=updates,
    )


# ---------------------------------------------------------------------------
# §4.4 Successive approximation
# ---------------------------------------------------------------------------

def simulate_successive_approximation(
    m: int,
    n_w: int,
    t_c: float,
    t_s: float,
    *,
    t_a: float = 0.0,
    feedback_latency: float = 0.0,
    seed: int = 0,
) -> SimResult:
    """Search for the minimum of ``m`` random fitness values.

    Every task costs ``t_c`` (evaluate the condition against the *local* state
    copy); an apparent improvement costs an extra ``t_s`` (compute s') and
    sends an update.  The collector keeps the monotone global best and
    broadcasts accepted values, which reach workers after
    ``feedback_latency``.  Stale copies cause extra (discarded) updates — the
    paper's third overhead source.
    """
    rng = np.random.default_rng(seed)
    fitness = rng.random(m)
    arrivals = _arrivals(m, t_a)

    workers = [(0.0, w) for w in range(n_w)]
    heapq.heapify(workers)
    commits: List[tuple] = [(-np.inf, np.inf)]  # (commit_time, value)
    sent = 0
    discarded = 0
    worker_busy = 0.0
    completion = 0.0

    def local_view(t: float) -> float:
        best = np.inf
        for ct, v in commits:
            if ct + feedback_latency <= t:
                best = min(best, v)
        return best

    for i in range(m):
        free_at, w = heapq.heappop(workers)
        start = max(free_at, arrivals[i])
        cost = t_c
        ls = local_view(start)
        if fitness[i] < ls:  # condition c(x, local state) holds
            cost += t_s
            sent += 1
            done = start + cost
            global_best = min(v for _, v in commits)
            if fitness[i] < global_best:  # monotone accept
                commits.append((done, float(fitness[i])))
            else:
                discarded += 1
        else:
            done = start + cost
        worker_busy += cost
        completion = max(completion, done)
        heapq.heappush(workers, (done, w))

    return SimResult(
        completion,
        m,
        n_w,
        worker_busy / (n_w * completion) if completion else 1.0,
        0.0,
        state_updates_sent=sent,
        state_updates_discarded=discarded,
    )


# ---------------------------------------------------------------------------
# §4.5 Separate task/state function
# ---------------------------------------------------------------------------

def simulate_separate_task_state(
    m: int,
    n_w: int,
    t_f: float,
    t_s: float,
    *,
    t_a: float = 0.0,
    t_comm: float = 0.0,
) -> SimResult:
    """f in parallel, then a mutually-exclusive state section of ``t_s``.

    The single lock is the serial fraction: speedup saturates at eq. (1)
    ``t_f/t_s + 1``.
    """
    arrivals = _arrivals(m, t_a)
    workers = [(0.0, w) for w in range(n_w)]
    heapq.heapify(workers)
    lock_free = 0.0
    worker_busy = 0.0
    completion = 0.0

    for i in range(m):
        free_at, w = heapq.heappop(workers)
        start = max(free_at, arrivals[i])
        f_done = start + t_f
        lock_start = max(f_done + t_comm, lock_free)
        release = lock_start + t_s
        lock_free = release
        worker_busy += t_f + t_s
        completion = max(completion, release)
        heapq.heappush(workers, (release, w))

    return SimResult(
        completion,
        m,
        n_w,
        worker_busy / (n_w * completion) if completion else 1.0,
        collector_busy_frac=(m * t_s) / completion if completion else 0.0,
        state_updates_sent=m,
    )
