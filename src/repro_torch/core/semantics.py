"""Formal semantics of the five state access patterns (paper §4).

Port of ``repro/core/semantics.py``: the *definitions* from the paper as
folds over a finite stream prefix, the oracles every parallel
implementation in :mod:`repro_torch.core.patterns` is held to.  Each
``lax.scan`` is a host loop (:func:`repro_torch.core.tree.scan`) over
tensors on whatever device the caller's tensors lie; nothing is read back
to the host inside a loop.

Stream convention: the paper writes streams right-to-left (``... x_2 x_1
x_0``); here a stream prefix is a tensor (or pytree of tensors) whose
*leading* axis is stream order, i.e. ``xs[0] == x_0``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import vmap

from repro_torch.core.tree import scan, tree_map

Tensor = torch.Tensor


def take(tree, index: Tensor):
    """Row ``index`` (a 0-d integer tensor) of every leaf, as a copy.  A
    0-d tensor used as an index is read back to the host; a one-element
    ``index_select`` is not."""
    idx = index.reshape(1).long()
    return tree_map(lambda leaf: leaf.index_select(0, idx).squeeze(0), tree)


def put_(tree, index: Tensor, value) -> None:
    """Write ``value``'s leaves into row ``index`` of ``tree``'s, in place
    (cast to each leaf's dtype, as ``.at[p].set`` does)."""
    idx = index.reshape(1).long()
    tree_map(lambda leaf, v: leaf.index_copy_(
        0, idx, v.to(leaf.dtype).unsqueeze(0)), tree, value)


def select(cond: Tensor, a, b):
    """``a`` where ``cond`` else ``b``, leaf by leaf, in ``b``'s dtypes;
    ``cond`` broadcasts over each leaf's trailing dims (``lax.cond``'s
    counterpart: both branches are computed, so they must be pure)."""
    def pick(x, y):
        c = cond.reshape(cond.shape + (1,) * (y.dim() - cond.dim()))
        return torch.where(c, x, y).to(y.dtype)

    return tree_map(pick, a, b)


# ---------------------------------------------------------------------------
# §4.1 Serial state access pattern
# ---------------------------------------------------------------------------

def serial(
    f: Callable,  # f : alpha x gamma -> beta
    ns: Callable,  # ns : alpha x gamma -> gamma   (new state)
    xs,            # stream prefix, leading axis = stream order
    s0,            # initial state s_0 : gamma
) -> Tuple[Tensor, object]:
    """``..., f(x_1, ns(x_0, s_0)), f(x_0, s_0)`` — the sequential fold.

    Returns ``(ys, s_final)`` where ``ys[i] = f(x_i, s_{i-1})`` and
    ``s_final = ns(x_{m-1}, s_{m-2})``.
    """

    def step(s, x):
        y = f(x, s)
        return ns(x, s), y

    s_final, ys = scan(step, s0, xs)
    return ys, s_final


# ---------------------------------------------------------------------------
# §4.2 Fully partitioned state access pattern
# ---------------------------------------------------------------------------

def partitioned(
    f: Callable,   # f : alpha x gamma -> beta
    ns: Callable,  # ns : alpha x gamma -> gamma
    h: Callable,   # h : alpha -> [0, N)
    xs,
    v0,            # state vector, v0[p] : gamma
) -> Tuple[Tensor, object]:
    """Each task touches only ``v[h(x_i)]``; per-partition order is stream
    order.  ``v0`` is not modified (the fold writes into a copy)."""

    def step(v, x):
        p = h(x)
        sp = take(v, p)
        y = f(x, sp)
        put_(v, p, ns(x, sp))
        return v, y

    v_final, ys = scan(step, tree_map(torch.clone, v0), xs)
    return ys, v_final


# ---------------------------------------------------------------------------
# §4.3 Accumulator state access pattern
# ---------------------------------------------------------------------------

def accumulator(
    f: Callable,        # f : alpha x gamma -> beta   (reads current state view)
    g: Callable,        # g : alpha -> gamma
    combine: Callable,  # (+) : gamma x gamma -> gamma, associative + commutative
    xs,
    s_zero,             # identity of (+)
) -> Tuple[Tensor, object]:
    """``s_i = g(x_i) (+) s_{i-1}`` — the serial reference for the accumulator.

    ``ys[i] = f(x_i, s_{i-1})`` matches the serial execution; parallel
    implementations are only required to match ``s_final`` (associativity and
    commutativity of ``(+)`` make the final state schedule-independent) while
    their per-item ``ys`` may read stale views.
    """

    def step(s, x):
        y = f(x, s)
        return combine(g(x), s), y

    s_final, ys = scan(step, s_zero, xs)
    return ys, s_final


# ---------------------------------------------------------------------------
# §4.4 Successive approximation state access pattern
# ---------------------------------------------------------------------------

def successive_approximation(
    c: Callable,        # c : alpha x gamma -> bool  (update condition)
    s_prime: Callable,  # s' : alpha x gamma -> gamma, monotone: s'(x, s) <= s
    xs,
    s_init,
) -> Tuple[Tensor, object]:
    """Monotone best-so-far fold.

    Returns ``(trace, s_final)`` with ``trace[i]`` the state value after task
    ``x_i`` (the paper's pattern outputs every accepted approximation; here the
    trace carries the state after each task so accepted updates are visible as
    changes in the trace).
    """

    def step(s, x):
        s_new = select(c(x, s), s_prime(x, s), s)
        return s_new, s_new

    s_final, trace = scan(step, s_init, xs)
    return trace, s_final


# ---------------------------------------------------------------------------
# Keyed windowed aggregation, layered on §4.2 (pure Python, the reference's
# own text)
# ---------------------------------------------------------------------------

def keyed_windows(
    kind: str,            # "tumbling" | "sliding" | "session"
    items,                # iterable of (key, value, ts) — stream order
    *,
    size: int = 0,        # tumbling/sliding window length
    slide: int = 0,       # sliding hop
    gap: int = 0,         # session inactivity gap
    watermark_every: int = 1,
    lateness: int = 0,    # bounded out-of-orderness: wm = max_ts - lateness
    late_policy: str = "drop",  # "drop" | "side"
    early_every: int = 0,  # emit provisional panes every N watermark ticks
):
    """Serial oracle for keyed windowed aggregation (sum + count per window).

    The keyed-window semantics layered on §4.2: each item ``(key, value,
    ts)`` updates the windows it falls in for its key; per-key update order
    is stream order.  A bounded-out-of-orderness **watermark** ``wm =
    max(ts seen) - lateness`` advances after every ``watermark_every`` items
    (and once more at end-of-stream if a partial group remains) — parallel
    implementations advance it at chunk boundaries, so set
    ``watermark_every`` to the chunk size when comparing.  At each advance,
    every window with ``end <= wm`` fires, emitted in ``(end, start, key)``
    order and removed from the store.

    An item assignment whose window has already fired (``end <= wm`` at
    processing time) is **late**: it never reaches the store, and is
    recorded as ``(key, value, ts, start)`` — returned to the caller under
    both policies (``"drop"`` merely means parallel engines do not ship the
    records downstream; the oracle always accounts for them).  For sliding
    windows lateness is per-assignment: one item can be late for an expired
    pane yet live for a newer one.  A session item is late iff even a
    singleton session at its timestamp would already have fired
    (``ts + gap <= wm``); otherwise it merges into (possibly several)
    existing sessions by interval overlap within ``gap``.

    **Early firing** (``early_every > 0``): every ``early_every``-th
    watermark tick (a tick is one watermark advance — every
    ``watermark_every`` items, plus the trailing partial group) each
    still-open window additionally emits a **provisional** pane result —
    its running ``(key, start, end, value_sum, count)`` — in the same
    ``(end, start, key)`` order final emissions fire in.  Provisional
    results never close or reset a window; the final emission at
    watermark-close is unchanged.

    Returns ``(emissions, open_windows, late)`` where ``emissions`` is a
    list of ``(key, start, end, value_sum, count)`` in emission order,
    ``open_windows`` the same 5-tuples for still-open windows (sorted by
    ``(key, start)``), and ``late`` the late-assignment records in stream
    order.  With ``early_every > 0`` a fourth element is appended: the
    provisional ``early`` rows in firing order.  Everything is integer
    arithmetic — parallel engines must match bit-exactly.
    """
    if kind not in ("tumbling", "sliding", "session"):
        raise ValueError(f"unknown window kind {kind!r}")
    if late_policy not in ("drop", "side"):
        raise ValueError(f"unknown late policy {late_policy!r}")
    if early_every < 0:
        raise ValueError(f"early_every must be >= 0, got {early_every}")
    open_wins = {}   # key -> list of [start, end, value, count]
    emissions, late, early = [], [], []
    wm = None
    max_ts = None
    ticks = 0

    def assignments(ts):
        if kind == "tumbling":
            start = (ts // size) * size
            return [(start, start + size)]
        hi = (ts // slide) * slide
        starts = []
        s = hi
        while s > ts - size:
            starts.append(s)
            s -= slide
        return [(s, s + size) for s in starts]

    def fire(watermark):
        due = []
        for key, wins in open_wins.items():
            for w in wins:
                if w[1] <= watermark:
                    due.append((w[1], w[0], key, w))
        due.sort(key=lambda r: r[:3])
        for end, start, key, w in due:
            emissions.append((key, start, end, w[2], w[3]))
            open_wins[key].remove(w)
            if not open_wins[key]:
                del open_wins[key]

    def early_fire():
        rows = sorted(
            (w[1], w[0], key, w[2], w[3])
            for key, wins in open_wins.items()
            for w in wins
        )
        early.extend((key, start, end, v, c) for end, start, key, v, c in rows)

    def tick():
        nonlocal wm, ticks
        wm = max_ts - lateness if wm is None else max(wm, max_ts - lateness)
        fire(wm)
        ticks += 1
        if early_every and ticks % early_every == 0:
            early_fire()

    count = 0
    for key, value, ts in items:
        key, value, ts = int(key), int(value), int(ts)
        max_ts = ts if max_ts is None else max(max_ts, ts)
        if kind == "session":
            if wm is not None and ts + gap <= wm:
                late.append((key, value, ts, ts))
            else:
                lo, hi = ts, ts + gap
                merged = [lo, hi, value, 1]
                keep = []
                for w in open_wins.get(key, []):
                    # strict overlap of half-open [start, end) intervals:
                    # an item exactly `gap` after a session opens a new one
                    if w[0] < hi and lo < w[1]:
                        merged[0] = min(merged[0], w[0])
                        merged[1] = max(merged[1], w[1])
                        merged[2] += w[2]
                        merged[3] += w[3]
                    else:
                        keep.append(w)
                keep.append(merged)
                keep.sort(key=lambda w: w[0])
                open_wins[key] = keep
        else:
            for start, end in assignments(ts):
                if wm is not None and end <= wm:
                    late.append((key, value, ts, start))
                    continue
                wins = open_wins.setdefault(key, [])
                for w in wins:
                    if w[0] == start:
                        w[2] += value
                        w[3] += 1
                        break
                else:
                    wins.append([start, end, value, 1])
                    wins.sort(key=lambda w: w[0])
        count += 1
        if count % watermark_every == 0:
            tick()
    if count % watermark_every and max_ts is not None:
        tick()

    open_out = sorted(
        (key, w[0], w[1], w[2], w[3])
        for key, wins in open_wins.items()
        for w in wins
    )
    if early_every:
        return emissions, open_out, late, early
    return emissions, open_out, late


# ---------------------------------------------------------------------------
# §4.5 Separate task/state function state access pattern
# ---------------------------------------------------------------------------

def separate_task_state(
    f: Callable,  # f : alpha -> beta           (state-independent)
    s: Callable,  # s : beta x gamma -> gamma   (serialized state update)
    xs,
    s0,
) -> Tuple[Tensor, Tensor, object]:
    """``y_i = f(x_i)`` then ``s_i = s(y_i, s_{i-1})`` under mutual exclusion.

    The commit order is arbitrary in the parallel pattern; the canonical
    reference commits in stream order.  Returns ``(ys, state_trace, s_final)``
    — the pattern's output stream is the trace of state modifications.
    """

    ys = vmap(f)(xs)  # embarrassingly parallel part

    def step(st, y):
        st_new = s(y, st)
        return st_new, st_new

    s_final, trace = scan(step, s0, ys)
    return ys, trace, s_final
