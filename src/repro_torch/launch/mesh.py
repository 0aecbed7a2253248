"""Mesh layouts: axis names and sizes, touching no device.

Port of ``repro/launch/mesh.py``'s intent.  The reference builds a
``jax.sharding.Mesh`` over placeholder devices; here a layout is data, the
axes the sharding rules (:mod:`repro_torch.launch.sharding`) map leaves
onto and the dry-run divides bytes and FLOPs by.  Single pod: ``(16, 16)``
= 256 chips, axes ``("data", "model")``; multi-pod: ``(2, 16, 16)`` = 512
chips, ``("pod", "data", "model")``, the pod axis pure data parallelism.
Building a live ``torch.distributed`` ``DeviceMesh`` from a layout comes
with the execution half of the sharding (ROADMAP): one card runs the
one-rank layout of :func:`make_host_mesh`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

__all__ = ["MeshLayout", "dp_axes", "make_host_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A logical mesh: ``axis_names`` with their ``sizes``."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(
                n < 1 for n in self.sizes):
            raise ValueError(f"a layout needs one positive size per axis, "
                             f"got {self.axis_names} x {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as a jax mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of chips."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_host_mesh(tp: int = 1) -> MeshLayout:
    """``(ranks // tp, tp)`` over ``("data", "model")``, the ranks being
    ``torch.distributed``'s world size, or 1 when it is not initialised
    (one card)."""
    dist = torch.distributed
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if tp < 1 or n % tp:
        raise ValueError(f"tp {tp} does not divide {n} ranks")
    return MeshLayout(("data", "model"), (n // tp, tp))


def dp_axes(layout: MeshLayout) -> Tuple[str, ...]:
    """The data-parallel axes: ``("pod", "data")`` or ``("data",)``."""
    return ("pod", "data") if "pod" in layout.axis_names else ("data",)
