"""Trace report renderer: per-stage time breakdown + latency percentiles.

Reads a Chrome trace-event JSON written by :func:`repro_torch.obs.export.
write_trace` and renders markdown: a per-stage table (count, total, mean,
p50/p95/p99, share of the top-level ``chunk`` time and of the trace wall
span), the instant-event timeline (resizes, failures, checkpoints), and —
when a metrics registry snapshot rides along under ``otherData.metrics`` —
the flat counter/gauge tables and the stored histogram percentiles.

Port of ``repro/obs/report.py``: the same markdown for the same document,
so it renders a trace written by either package.

Run:  python -m repro_torch.obs.report results/keyed_fused_trace.json
      python -m repro_torch.obs.report trace.json -o trace_report.md

(The renderer is offline: it may sort raw durations for exact percentiles.
The online path never stores samples — that is what the log-bucket
histograms in :mod:`repro_torch.obs.metrics` are for.)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List


def load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _pct(durs: List[float], q: float) -> float:
    """Exact (nearest-rank, interpolated) percentile of a sorted list."""
    if len(durs) == 1:
        return durs[0]
    pos = q * (len(durs) - 1)
    i = int(pos)
    frac = pos - i
    return durs[i] if i + 1 >= len(durs) else \
        durs[i] * (1 - frac) + durs[i + 1] * frac


def _fmt_us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.3g} s"
    if v >= 1e3:
        return f"{v / 1e3:.3g} ms"
    return f"{v:.3g} us"


def stage_table(doc: Dict, *, anchor: str = "chunk") -> List[str]:
    """Per-span-name breakdown over the trace's ``ph:"X"`` events."""
    spans: Dict[str, List[float]] = {}
    t_lo, t_hi = None, None
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        spans.setdefault(ev["name"], []).append(float(ev.get("dur", 0.0)))
        lo, hi = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
        t_lo = lo if t_lo is None else min(t_lo, lo)
        t_hi = hi if t_hi is None else max(t_hi, hi)
    if not spans:
        return ["(no spans in trace)"]
    wall = (t_hi - t_lo) if t_hi is not None else 0.0
    anchor_total = sum(spans.get(anchor, [])) or None
    lines = []
    if anchor_total is None:
        # serving traces anchor on "tick", partial flight-recorder dumps may
        # hold no anchor at all — report absolute/wall shares, don't divide
        lines += [f"(anchor span {anchor!r} absent — "
                  f"shares of {anchor} unavailable)", ""]
    lines += [
        f"| stage | count | total | mean | p50 | p95 | p99 | "
        f"% of {anchor} | % of wall |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for name, durs in sorted(spans.items(), key=lambda kv: -sum(kv[1])):
        durs.sort()
        total = sum(durs)
        share = f"{100 * total / anchor_total:.1f}%" if anchor_total else "—"
        wall_share = f"{100 * total / wall:.1f}%" if wall > 0 else "—"
        lines.append(
            f"| {name} | {len(durs)} | {_fmt_us(total)} "
            f"| {_fmt_us(total / len(durs))} "
            f"| {_fmt_us(_pct(durs, 0.50))} | {_fmt_us(_pct(durs, 0.95))} "
            f"| {_fmt_us(_pct(durs, 0.99))} | {share} | {wall_share} |"
        )
    return lines


def instant_table(doc: Dict) -> List[str]:
    rows = [ev for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "i"]
    if not rows:
        return []
    lines = ["", "## Events", "", "| t | event | args |", "|---|---|---|"]
    for ev in rows:
        args = ev.get("args") or {}
        rendered = ", ".join(f"{k}={v}" for k, v in args.items())
        lines.append(f"| {_fmt_us(float(ev['ts']))} | {ev['name']} "
                     f"| {rendered} |")
    return lines


def metrics_tables(doc: Dict) -> List[str]:
    snap = (doc.get("otherData") or {}).get("metrics")
    if not snap:
        return []
    lines: List[str] = []
    if snap.get("histograms"):
        lines += ["", "## Latency percentiles (stored histograms)", "",
                  "| histogram | count | mean | p50 | p95 | p99 | max |",
                  "|---|---|---|---|---|---|---|"]
        for name, h in snap["histograms"].items():
            def u(v):
                return "—" if v is None else _fmt_us(float(v) * 1e6)
            lines.append(
                f"| {name} | {h['count']} | {u(h['mean'])} | {u(h['p50'])} "
                f"| {u(h['p95'])} | {u(h['p99'])} | {u(h['max'])} |"
            )
    if snap.get("gauges"):
        lines += ["", "## Gauges", "", "| gauge | value |", "|---|---|"]
        lines += [f"| {k} | {v:.6g} |" for k, v in snap["gauges"].items()]
    if snap.get("counters"):
        lines += ["", "## Counters", "", "| counter | value |", "|---|---|"]
        lines += [f"| {k} | {v} |" for k, v in snap["counters"].items()]
    return lines


def render(doc: Dict, *, title: str = "Trace report",
           anchor: str = "chunk") -> str:
    dropped = (doc.get("otherData") or {}).get("dropped_events", 0)
    lines = [f"# {title}", ""]
    if dropped:
        lines += [f"**WARNING: {dropped} events dropped "
                  f"(tracer buffer full)**", ""]
    lines += ["## Per-stage time breakdown", ""]
    lines += stage_table(doc, anchor=anchor)
    lines += instant_table(doc)
    lines += metrics_tables(doc)
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome trace-event JSON file")
    ap.add_argument("-o", "--out", default=None,
                    help="write markdown here (default: stdout)")
    ap.add_argument("--title", default=None)
    ap.add_argument("--anchor", default="chunk",
                    help="span name shares are computed against "
                         "(default: chunk; serving traces use tick)")
    args = ap.parse_args(argv)
    doc = load(args.trace)
    md = render(doc, title=args.title or f"Trace report — {args.trace}",
                anchor=args.anchor)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"wrote {args.out}")
    else:
        print(md, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
