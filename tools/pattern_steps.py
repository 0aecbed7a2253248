"""Phase 13 of a checkout's ``chip_smoke.py`` (S1-S5 on one card) alone,
in a fresh process: the microseconds a scan step of each run, to compare
two commits on one card.

    python3 tools/pattern_steps.py [--tree DIR] [--ranks-first] [--seed N]

``--tree`` is the checkout whose ``chip_smoke.py`` and ``src/`` run
(default: this one); an unpacked older commit works the same way, as long
as its ``chip_smoke.py`` has ``phase_patterns(torch, seed, smi)``.  Run
the two trees in turns (parent, change, change, parent) and compare within
one machine.  ``--ranks-first`` runs phase 20 (the patterns over ranks;
its one-card runs, one NCCL rank, two gloo ranks) before phase 13 in the
same process, to see whether a phase's place in a long process moves its
host times.  Needs a CUDA card; prints the phases' JSON lines
(``[patterns] {..., "step_us": ...}``) and exits non-zero if a check of
theirs fails.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=here)
    parser.add_argument("--ranks-first", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    print(f"tree {tree} ({smi})", flush=True)
    try:
        if args.ranks_first:
            cs.phase_ranks(torch, args.seed, smi)
        cs.phase_patterns(torch, args.seed, smi)
    except cs.SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
