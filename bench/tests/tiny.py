"""A temporary copy of the benchmark at a size the CPU runs in seconds:
the same drivers, readers and references, with each configuration and
traffic mix cut down in the copy."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

TRAIN = "minicpm-2b.train-4k"
SERVE = "deepseek-moe-16b.serve-longprompt"
#: limits for the tiny sizes, between what sound runs read there (at most
#: about 5e-5, 1.5e-3, 2.5e-2 and 3.6e-3 on a dozen seeds) and what the
#: control (1.4e-4-7e-4 and 0.020-0.024 for the first two, 0.0084-0.033 for
#: the last) and the planted faults read
LIMITS = {TRAIN: {"loss_gap": 1e-4, "grad_norm_gap": 0.006,
                  "change_norm_gap": 0.25},
          SERVE: {"logit_gap_mean": 0.006}}
SEED = 2 ** 31 + 11


def copy_bench(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` (without its tests) under
    ``dest``."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data))


def tiny_root(dest: Path) -> Path:
    """A copy whose cells run at tiny widths on the CPU."""
    root = copy_bench(dest)
    b = root / "bench"
    small = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                 d_ff=128, vocab_size=512)
    _edit(b / "configs" / "minicpm-2b.json", num_layers=2, **small)
    _edit(b / "configs" / "deepseek-moe-16b.json", num_layers=3, **small,
          moe=dict(num_experts=8, top_k=2, num_shared=1, d_ff_expert=32))
    _edit(b / "traffic" / "train-4k.json", seq_len=64)
    _edit(b / "traffic" / "serve-longprompt.json", clients=4, slots=4,
          s_max=96, prompt_len=[16, 48], output_len=[4, 12], strata=4,
          sample_requests=4)
    for cell, limits in LIMITS.items():
        (b / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))
    return root


def run(root: Path, cell: str, trace: bool = False, seconds: float = 1.0,
        control: bool = False, seed: int = SEED) -> dict:
    from bench.run import run_cell

    return run_cell(root, cell, seed, seconds, trace, "cpu",
                    time.perf_counter(), control=control)
