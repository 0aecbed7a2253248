"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also end standard
error.  Exits non-zero, printing no result, without a CUDA card, or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None):
    """The banned top-level names among ``modules`` (default: loaded),
    compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def fixed_caches(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             control: bool = False) -> dict:
    """One run of ``workload``; returns the result object."""
    import torch

    from bench.drivers import Context
    from bench.manifest import Manifest, load_driver

    man = Manifest(root)
    cell = man.cell(workload)
    traffic = man.traffic(cell)
    limits = man.limits(cell)
    ctx = Context(cfg=man.config(cell), traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=torch.device(device),
                  t_start=t_start, control=control)
    out = load_driver(traffic["driver"]).run(ctx)

    metrics = {}
    if not trace:
        for m in man.end_to_end(cell):
            metrics[m["name"]] = {"value": out.numbers[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in man.per_layer(cell):
            value = man.reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": out.checks[name], "limit": limit}
              for name, limit in limits.items()}
    correct = out.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    dev = ctx.device
    result = {
        "correct": correct, "attempted": out.attempted, "failed": out.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else dev.type),
                   "count": 1,
                   "memory_peak_bytes": out.memory_peak_bytes}}
    tr = out.record.trace
    if trace and tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["notes"] = out.notes
    result["checks"] = {k: _json_number(v) for k, v in checks.items()}
    return result


def _json_number(check: dict) -> dict:
    v = check["value"]
    return {"value": v if math.isfinite(v) else str(v),
            "limit": check["limit"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    fixed_caches(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench.manifest import Manifest

    chips = Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = banned_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
