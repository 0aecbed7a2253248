"""The program's compared numbers and its control's, seed after seed in one
process, to set a cell's limits from (``bench/limits/<cell>.json``).

    python -m bench.control --workload <name> --seeds 1,2,3 --seconds 8

The control is the reference with its products in float8 e4m3, the
precision below the configuration's bfloat16: for training its first steps
against the float32 reference's (and, beside it, the reference's steps with
half of each batch left out, a fault the comparison must catch); for
serving, at each position of the served requests, the float32 reference's
gap of the token that the float8 run puts first.  Prints one JSON line a
seed.  The benchmark's own runs do not run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from bench.run import ROOT, banned_modules, fixed_caches, run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    fixed_caches(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("bench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(ROOT, args.workload, seed, args.seconds, False, "cuda",
                     time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": r["checks"],
                          "control": r["notes"].get("control"),
                          "half_batch": r["notes"].get("half_batch"),
                          "notes": r["notes"]}), flush=True)
    bad = banned_modules()
    if bad:
        print(f"bench.control: the run loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
