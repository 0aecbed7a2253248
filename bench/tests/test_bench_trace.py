"""The reduction of the profiler's raw records to a traced stretch, on
synthetic records: the first step is cut, a range's device mirror is no
device work, and a kernel counts in the range where its launch started,
whatever thread launched it."""

from typing import NamedTuple

import pytest
import torch

from bench.trace import reduce

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Record(NamedTuple):
    """The accessors of a raw record that the reduction reads; times in
    microseconds."""
    n: str
    dev: object
    t0: float
    t1: float
    cid: int = 0

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def start_ns(self):
        return int(self.t0 * 1000)

    def duration_ns(self):
        return int((self.t1 - self.t0) * 1000)

    def correlation_id(self):
        return self.cid


def launch(cid, at, k0, k1, name="void kernel"):
    """A launch on the host at ``at`` and its kernel from ``k0`` to
    ``k1``."""
    return [Record("cudaLaunchKernel", CPU, at, at + 2, cid),
            Record(name, CUDA, k0, k1, cid)]


def records():
    """Three steps of 100 us; the first pays the start-up.  In step 2 a
    ``bench.grads`` range launches one kernel from its own thread and one
    from another (a backward's), then ``bench.adamw`` launches one; step 3
    launches one kernel outside any inner range."""
    rs = [Record("bench.step", CPU, 0, 100), Record("bench.step", CPU, 100,
                                                     200),
          Record("bench.step", CPU, 200, 300),
          Record("bench.grads", CPU, 110, 150),
          Record("bench.adamw", CPU, 150, 190),
          Record("bench.grads", CUDA, 120, 160),    # the range's mirror
          Record("aten::mm", CPU, 112, 118, 99)]
    rs += launch(1, 50, 60, 95)                     # in the first step
    rs += launch(2, 115, 120, 130, "nvjet_gemm")
    rs += launch(3, 140, 140, 160)                  # another thread's
    rs += launch(4, 160, 165, 185)
    rs += launch(5, 210, 220, 250)
    return rs


def test_the_stretch_starts_after_the_first_step():
    tr = reduce(records())
    assert tr.window_s == pytest.approx(200e-6)
    assert len(tr.device) == 4
    assert min(d.t0 for d in tr.device) == pytest.approx(120e-6)


def test_a_ranges_mirror_is_no_device_work():
    tr = reduce(records())
    assert tr.busy_s() == pytest.approx((10 + 20 + 20 + 30) * 1e-6)
    assert tr.by_class()["products"] == [pytest.approx(10e-6), 1]


def test_kernels_count_where_their_launch_started():
    got = reduce(records()).range_device_s
    assert got["bench.grads"] == pytest.approx(30e-6)
    assert got["bench.adamw"] == pytest.approx(20e-6)
    assert got["bench.step"] == pytest.approx(80e-6)
