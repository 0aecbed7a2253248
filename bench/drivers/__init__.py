"""Drivers: the code that runs one kind of traffic mix against the program.

A mix's ``driver`` key names a module here; its ``run(ctx)`` sets the cell
up, runs the window, checks the outputs against the reference and returns
an :class:`Outcome`.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import types
from typing import Dict

import torch


@dataclasses.dataclass
class Context:
    cfg: dict            # the configuration file, with its ``name``
    traffic: dict        # the mix's parameters, with its ``name``
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float       # the process's start on the host clock
    #: also read the control (the reference in the precision below the
    #: configuration's) into ``Outcome.notes["control"]``
    control: bool = False


@dataclasses.dataclass
class Outcome:
    numbers: Dict[str, float]     # end-to-end values by metric name
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, float]      # compared numbers by name
    record: types.SimpleNamespace  # what the per-layer readers read
    notes: Dict[str, object]      # printed to standard error


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device) -> None:
    """Give the freed program state back before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
