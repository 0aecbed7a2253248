"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
import subprocess
import sys

from bench import manifest
from bench.run import BANNED, banned_modules
from bench.tests.tiny import ROOT

M = manifest.Manifest(ROOT)
DATA = M.data
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                   r"projection|d_model|d_ff|head|expansion|top_k|"
                   r"experts_per_tok)")


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(DATA["command"]) <= 32
    for path in DATA["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path)
        assert not path.endswith("_torch") and path != "benchmarks"
    assert isinstance(DATA["run_seconds"], int)
    assert 1 <= DATA["run_seconds"] <= 51
    cells = len(DATA["workloads"])
    runs = 2 + 14 * cells
    assert runs * (DATA["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    full = 2 + 14 * 24
    assert full * (DATA["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/configs/")
        assert len(c["reduced"]) <= 16
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert manifest.NAME.match(key) and key in cfg
            assert not WIDTH.search(key), key
        names.append(c["name"])
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound",
                                          "source", "layer", "moves"}
        assert manifest.UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        assert m["source"] in manifest.SOURCES
        names.append(m["name"])
    for name in names:
        assert manifest.NAME.match(name), name
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        listed = [x["name"] for x in DATA[key]]
        assert len(listed) == len(set(listed))
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in DATA["end_to_end"]:
        assert m["source"] in manifest.SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in DATA["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"] for m in DATA["end_to_end"]}
    for w in DATA["workloads"]:
        cell = M.cell(w["name"])
        reported = {m["name"] for m in M.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert M.per_layer(cell)
        for m in M.per_layer(cell):
            assert m["moves"] in reported
    for m in DATA["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]
        assert m["moves"] in e2e and m["workloads"]
        assert set(m["workloads"]) <= set(M.cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_named_file_is_there():
    for w in DATA["workloads"]:
        cell = M.cell(w["name"])
        assert M.config(cell)["name"] == w["config"]
        traffic = M.traffic(cell)
        assert (ROOT / "bench" / "drivers" / f"{traffic['driver']}.py") \
            .exists()
        assert M.limits(cell)
    for m in DATA["per_layer"]:
        assert callable(M.reader(m["name"]))


def test_banned_names_are_compared_whole():
    assert banned_modules(["repro_torch", "repro_torch.models"]) == []
    assert banned_modules(["repro.core.farm", "torch"]) == ["repro"]
    assert banned_modules(["jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib"]


def test_nothing_the_harness_imports_is_jax_or_the_jax_package():
    code = (
        "import json, sys\n"
        "import bench.run, bench.control, bench.readings\n"
        "import bench.drivers.train, bench.drivers.closed_loop\n"
        "import repro_torch.launch.steps, repro_torch.launch.cells\n"
        "import repro_torch.serving.engine, repro_torch.obs.trace\n"
        "import repro_torch.models.transformer, repro_torch.optim.adamw\n"
        "from bench.manifest import Manifest\n"
        "m = Manifest()\n"
        "[m.reader(x['name']) for x in m.data['per_layer']]\n"
        "from bench import model as bm\n"
        "[bm.plan(m.config(c)) for c in m.cells.values()]\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & set(BANNED)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)\b"
                         r"(?!_)", re.M)
    for path in (ROOT / "bench").rglob("*.py"):
        assert not pattern.search(path.read_text()), path
