"""Trace/metrics export: Chrome trace-event JSON (Perfetto-loadable).

Port of ``repro/obs/export.py``; the document is the reference's, key for
key, so a trace of either package loads in the same viewers and renders
the same report.

``chrome_trace`` renders a :class:`~repro_torch.obs.trace.Tracer`'s buffers into
the Chrome trace-event format (the JSON flavor ``chrome://tracing`` and
https://ui.perfetto.dev load directly):

* spans -> ``ph:"X"`` complete events (``ts``/``dur`` in microseconds);
* instants -> ``ph:"i"`` thread-scoped instant events;
* counter samples -> ``ph:"C"`` counter tracks (stacked series in the UI);
* one ``thread_name`` metadata event per track so the executor's main loop
  and the pipeline's prepare worker are labeled.

Timestamps are ``clock.now()`` seconds scaled to integer-ish microseconds;
under a :class:`~repro_torch.obs.clock.LogicalClock` one logical unit = one
second, so simulated traces are deterministic byte-for-byte.

A metrics registry snapshot can ride along under ``otherData`` (a documented
extension point of the format that viewers ignore), so one artifact carries
both the timeline and the flat gauges/counters/percentiles.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

_US = 1e6  # seconds (or logical units) -> microseconds


def _args(d) -> Optional[Dict]:
    if not d:
        return None
    return {k: (v if isinstance(v, (int, float, str, bool)) else repr(v))
            for k, v in d.items()}


def chrome_trace(tracer, *, registry=None, pid: int = 0,
                 process_name: str = "repro",
                 extra: Optional[Dict] = None) -> Dict:
    """Render ``tracer`` (and optionally a metrics registry) to one dict in
    Chrome trace-event JSON object form.  ``tracer`` is duck-typed: anything
    with ``spans`` / ``instants`` / ``counters`` / ``dropped`` works — a
    :class:`~repro_torch.obs.trace.FlightRecorder` dump uses the same path.
    ``extra`` merges additional keys under ``otherData``."""
    events: List[Dict] = []
    tids = set()
    for s in tracer.spans:
        ev = {
            "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
            "ts": s.t0 * _US, "dur": (s.t1 - s.t0) * _US,
        }
        a = _args(s.args)
        if a:
            ev["args"] = a
        events.append(ev)
        tids.add(s.tid)
    for i in tracer.instants:
        ev = {
            "name": i.name, "ph": "i", "s": "t", "pid": pid, "tid": i.tid,
            "ts": i.t * _US,
        }
        a = _args(i.args)
        if a:
            ev["args"] = a
        events.append(ev)
        tids.add(i.tid)
    for c in tracer.counters:
        events.append({
            "name": c.name, "ph": "C", "pid": pid, "tid": 0,
            "ts": c.t * _US, "args": _args(c.values) or {},
        })
    events.sort(key=lambda e: (e["ts"], e["tid"]))
    meta: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    # explicit labels (Tracer.alloc_track — e.g. one track per shard-host
    # process) win over the positional main/worker-N defaults
    track_names = getattr(tracer, "track_names", None) or {}
    for tid in sorted(tids):
        name = track_names.get(
            tid, "main" if tid == 0 else f"worker-{tid}"
        )
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
    out = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": tracer.dropped},
    }
    for kind in ("spans", "instants", "counters"):
        n = getattr(tracer, f"dropped_{kind}", None)
        if n is not None:
            out["otherData"][f"dropped_{kind}"] = n
    if registry is not None:
        # saturation must be visible in the snapshot, not just the trace
        export_drops = getattr(tracer, "export_drops", None)
        if export_drops is not None:
            export_drops(registry)
        out["otherData"]["metrics"] = registry.snapshot()
    if extra:
        out["otherData"].update(extra)
    return out


def write_trace(path: str, tracer, *, registry=None,
                process_name: str = "repro",
                extra: Optional[Dict] = None) -> Dict:
    """Write the Perfetto-loadable trace artifact; returns the dict."""
    doc = chrome_trace(tracer, registry=registry, process_name=process_name,
                       extra=extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def write_metrics(path: str, registry) -> None:
    """Write the flat metrics-snapshot artifact."""
    registry.write(path)
