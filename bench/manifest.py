"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; everything else is looked up from those names:

* ``bench/configs/<config>.json`` -- the model's sizes (the ``file`` of its
  ``configs`` entry), whose layer kinds name ``bench/reference/mixer/<kind>.py``
  and ``bench/reference/mlp/<kind>.py``;
* ``bench/traffic/<traffic>.json`` -- the mix's parameters, whose
  ``driver`` names ``bench/drivers/<driver>.py``;
* ``bench/limits/<cell>.json`` -- the limits of the cell's correctness
  comparison;
* ``bench/metrics/<metric>.py`` -- one per-layer metric's reader.

Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock",)
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class Manifest:
    """The parsed ``BENCHMARK.json`` under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        try:
            return self.cells[name]
        except KeyError:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(self.cells)}") from None

    def config(self, cell: dict) -> dict:
        """The configuration file of ``cell`` with its name and the folder
        of its layer kinds (``bench.model.kind``)."""
        entry = self.configs[cell["config"]]
        cfg = json.loads((self.root / entry["file"]).read_text())
        return {**cfg, "name": entry["name"],
                "kinds": str(self.root / "bench" / "reference")}

    def traffic(self, cell: dict) -> dict:
        path = self.root / "bench" / "traffic" / f"{cell['traffic']}.json"
        return {**json.loads(path.read_text()), "name": cell["traffic"]}

    def limits(self, cell: dict) -> Dict[str, float]:
        path = self.root / "bench" / "limits" / f"{cell['name']}.json"
        return json.loads(path.read_text())["limits"]

    def end_to_end(self, cell: dict) -> List[dict]:
        """The end-to-end metrics ``cell`` reports (a ``--trace 0`` run)."""
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> List[dict]:
        """The per-layer metrics that list ``cell`` (a ``--trace 1``
        run)."""
        return [m for m in self.data["per_layer"]
                if cell["name"] in m["workloads"]]

    def reader(self, metric: str):
        """The ``read(record)`` function of ``bench/metrics/<metric>.py``."""
        path = self.root / "bench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + re.sub(r"\W", "_", metric), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load_driver(name: str):
    """The module ``bench.drivers.<name>``: the code that runs a traffic
    mix whose ``driver`` is ``name``."""
    return importlib.import_module(f"bench.drivers.{name}")
