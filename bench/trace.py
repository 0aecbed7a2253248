"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of the window, reduced to device events and host ranges.

The benchmark's own files mark what the host is doing with
``record_function`` ranges named ``bench.<what>``; every idle gap of the
device is charged to the innermost such range around it.  Kernels are
sorted into classes by name, as ``chip_smoke.py`` sorts them.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

#: the port's kernels by class (checked in order), then products by the
#: names of cuBLAS's and CUTLASS's kernels
KERNEL_CLASSES = (("flash_bwd", "flash backward"),
                  ("flash_forward", "flash forward"),
                  ("decode_split", "decode"), ("decode_mma", "decode"),
                  ("ssdb::", "scan backward"), ("ssd::", "scan forward"),
                  ("gather_rows_backward", "gather backward"),
                  ("gather_rows", "gather forward"),
                  ("token_table", "token table"))
PRODUCT_KEYS = ("gemm", "xmma", "cutlass", "nvjet", "matmul", "sm90_")
#: the CUDA runtime's and driver's calls on the host, whose records share a
#: correlation id with the device work they launched
RUNTIME_CALLS = "cu"


def kernel_class(name: str) -> str:
    for key, label in KERNEL_CLASSES:
        if key in name:
            return label
    if any(s in name for s in PRODUCT_KEYS):
        return "products"
    return "other"


class DeviceEvent(NamedTuple):
    name: str
    t0: float     # seconds on the profiler's clock
    t1: float
    launch: int = 0   # the correlation id of the call that launched it


class Trace(NamedTuple):
    device: List[DeviceEvent]
    #: host ranges ``bench.*``: (name, t0, t1), on the same clock
    ranges: List[Tuple[str, float, float]]
    #: device seconds of the kernels launched inside each ``bench.*`` range
    #: name, summed
    range_device_s: Dict[str, float]
    window_s: float

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, float("-inf")
        for e in sorted(self.device, key=lambda e: e.t0):
            if e.t1 <= end:
                continue
            busy += e.t1 - max(e.t0, end)
            end = e.t1
        return busy

    def seconds_by(self, pred) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name passes."""
        ev = [e for e in self.device if pred(e.name)]
        return sum(e.t1 - e.t0 for e in ev), len(ev)

    def by_class(self) -> Dict[str, List[float]]:
        """[device seconds, launches] by kernel class."""
        out: Dict[str, List[float]] = {}
        for e in self.device:
            c = out.setdefault(kernel_class(e.name), [0.0, 0])
            c[0] += e.t1 - e.t0
            c[1] += 1
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time by the innermost host range around each gap."""
        ops: Dict[str, float] = {}
        for e in self.device:
            ops[e.name] = ops.get(e.name, 0.0) + (e.t1 - e.t0)
        return {"device_ops": sorted(([k[:120], v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in
                                     self.idle_by_range().items()),
                                    key=lambda kv: -kv[1])[:top]}

    def idle_by_range(self) -> Dict[str, float]:
        segs = _innermost(self.ranges)
        starts = [s[0] for s in segs]
        out: Dict[str, float] = {}
        end = None
        for e in sorted(self.device, key=lambda e: e.t0):
            if end is not None and e.t0 > end:
                mid = 0.5 * (end + e.t0)
                i = bisect.bisect_right(starts, mid) - 1
                label = (segs[i][2] if i >= 0 and segs[i][1] > mid
                         else "outside bench ranges")
                out[label] = out.get(label, 0.0) + (e.t0 - end)
            end = e.t1 if end is None else max(end, e.t1)
        return out


def _innermost(ranges):
    """Non-overlapping (t0, t1, name) segments: at each time the innermost
    (latest started) open range."""
    points = sorted({t for _, a, b in ranges for t in (a, b)})
    segs = []
    for a, b in zip(points, points[1:]):
        mid = 0.5 * (a + b)
        inner = None
        for name, r0, r1 in ranges:
            if r0 <= mid < r1 and (inner is None or r0 >= inner[1]):
                inner = (name, r0)
        if inner is not None:
            segs.append((a, b, inner[0]))
    return segs


class Profiler:
    """``torch.profiler`` over the last ``seconds`` of a window (the mix's
    ``trace_seconds``).  Nothing profiles before it: once started, the
    profiler slows the host for the rest of the process, so the part of
    the window before it is the untraced stretch that host-clock readers
    use.  The first step or tick under the profiler pays its start-up and
    is left out: the traced stretch runs from that step's end to the
    window's.  The driver calls :meth:`maybe_start` and :meth:`tick` after
    every step or tick, wraps each in :meth:`range` ``("step")``, and
    calls :meth:`stop` once the window is over."""

    def __init__(self, enabled: bool, device: torch.device,
                 seconds: float):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.seconds = seconds
        self._prof = None
        self.ticks: List[float] = []
        self.started: Optional[float] = None
        self.t1: Optional[float] = None

    def maybe_start(self, now: float, t0: float, window_s: float) -> None:
        """Start once the window has ``seconds`` (and a step) left."""
        if (self.enabled and self._prof is None
                and now - t0 >= window_s - self.seconds):
            from torch.profiler import ProfilerActivity, profile

            self._sync()
            self._prof = profile(activities=[ProfilerActivity.CPU]
                                 + [ProfilerActivity.CUDA] * self.cuda)
            self._prof.start()
            self.started = now

    def tick(self, now: float) -> None:
        """A step or tick ended at ``now`` (host clock)."""
        if self.active():
            self.ticks.append(now)

    def stop(self, now: float) -> None:
        if self.active():
            self._sync()
            self._prof.stop()
            self.t1 = now

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def active(self) -> bool:
        return self._prof is not None and self.t1 is None

    @property
    def stretch(self) -> Tuple[Optional[float], Optional[float]]:
        """The traced stretch on the host clock: from the end of the first
        profiled step to the end of the last; (None, None) if none."""
        if len(self.ticks) < 2:
            return None, None
        return self.ticks[0], self.ticks[-1]

    def complete(self) -> bool:
        """Whether a traced run has a step in its traced stretch (an
        untraced run always has)."""
        return not self.enabled or self.counted >= 1

    @property
    def counted(self) -> int:
        """Steps or ticks inside the traced stretch."""
        return max(len(self.ticks) - 1, 0)

    def range(self, name: str):
        """A ``bench.<name>`` host range while profiling, else nothing."""
        if not self.active():
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def result(self) -> Optional[Trace]:
        """The traced stretch (:func:`reduce`); None without one."""
        if self._prof is None or self.counted < 1:
            return None
        return reduce(self._prof.profiler.kineto_results.events())


def reduce(raw) -> Trace:
    """The traced stretch of the profiler's raw records: the events after
    the first profiled step's ``bench.step`` range, which carries the
    start-up.  Raw records, because the profiler's per-event Python objects
    take some 50 us an event to build, minutes for a traced stretch.  A
    kernel counts in a range when the host's call that launched it (the
    runtime's record of the same correlation id) started inside the range,
    on any thread: the backward's launches too."""
    cuda = torch.autograd.DeviceType.CUDA
    base = min(e.start_ns() for e in raw)
    device, host, launched = [], [], {}
    for e in raw:
        name = e.name()
        t0 = (e.start_ns() - base) * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        if e.device_type() == cuda:
            if not name.startswith("bench."):   # not a range's mirror
                device.append(DeviceEvent(name, t0, t1, e.correlation_id()))
        elif name.startswith("bench."):
            host.append((name, t0, t1))
        elif name.startswith(RUNTIME_CALLS):
            launched[e.correlation_id()] = t0
    steps = sorted(t1 for name, _, t1 in host if name == "bench.step")
    cut, end = steps[0], steps[-1]
    device = [d for d in device if d.t0 >= cut]
    ranges = [r for r in host if r[1] >= cut]
    at = sorted((launched[d.launch], d.t1 - d.t0) for d in device
                if d.launch in launched)
    times = [t for t, _ in at]
    total = list(itertools.accumulate((s for _, s in at), initial=0.0))
    in_range: Dict[str, float] = {}
    for name, t0, t1 in ranges:
        i = bisect.bisect_left(times, t0)
        j = bisect.bisect_right(times, t1)
        in_range[name] = in_range.get(name, 0.0) + total[j] - total[i]
    return Trace(device, ranges, in_range, end - cut)
