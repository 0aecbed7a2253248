"""The numbers that decide ``correct``: the program's outputs against the
reference's, each a gap that a limit in ``bench/limits/<cell>.json``
bounds.

Training: each of the first steps' loss, and per leaf the norm of the
first clipped gradient and the norm of the change after the compared
steps, each taken by its worst leaf: the gap between the program's norm
and the reference's over the reference's norm of that leaf or of the median
leaf, whichever is larger.  A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone under AdamW and
is left out of the change.

Serving: by how much a served token's reference logit lies below the
reference's best at that position (0 where the program served the
reference's own choice), as the mean over every checked token; the widest
gap and the share of tokens off the reference's choice are reported beside
it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

#: a leaf whose first reference gradient is under this share of the
#: median leaf's is left out of the change
QUIET_LEAF = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves=None) -> float:
    names = list(ref) if leaves is None else list(leaves)
    median = float(np.median([ref[n] for n in names]))
    return _finite(max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
                       for n in names))


def train_checks(prog: dict, ref: dict) -> Dict[str, float]:
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    g = ref["first_grad"]
    median = float(np.median(list(g.values())))
    moved = [n for n in g if g[n] >= QUIET_LEAF * median]
    return {"loss_gap": _finite(loss),
            "grad_norm_gap": worst_leaf(prog["first_grad"], g),
            "change_norm_gap": worst_leaf(prog["change"], ref["change"],
                                          moved)}


def served_gaps(served: Sequence[Sequence[int]],
                logits: Sequence[torch.Tensor]) -> List[List[float]]:
    """Per request, each served token's gap below the reference's best."""
    out = []
    for toks, lg in zip(served, logits):
        t = torch.as_tensor(list(toks), device=lg.device)
        gap = lg.max(dim=-1).values - lg.gather(-1, t[:, None])[:, 0]
        out.append([_finite(g) for g in gap.tolist()])
    return out


def lower_precision_gaps(logits: Sequence[torch.Tensor],
                         low: Sequence[torch.Tensor]) -> List[List[float]]:
    """The control's gaps: at each position, the gap of the token that the
    lower precision puts first."""
    return served_gaps([lo.argmax(dim=-1).tolist() for lo in low], logits)


def serve_checks(gaps: List[List[float]]) -> Dict[str, float]:
    flat = [g for per in gaps for g in per]
    if not flat:
        return {"logit_gap_mean": float("inf"), "logit_gap_max":
                float("inf"), "off_choice_share": 1.0}
    return {"logit_gap_mean": float(np.mean(flat)),
            "logit_gap_max": max(flat),
            "off_choice_share": float(np.mean([g > 0 for g in flat]))}
