"""State carry-over between the JAX reference and the port.

The keyed plane's data is made from a seed, so what carries over between
the two packages is the STATE: the canonical snapshot that
``StreamExecutor.state`` returns (a dict of host numpy arrays, the same
layout in both packages).  :func:`state_from_reference` takes the
reference's snapshot and returns the port's state; a port executor given it
(``executor.state = ...``) continues the stream exactly where the reference
would.  :func:`state_to_reference` goes the other way.  Neither needs the
other package: both sides are plain numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: row columns of the canonical snapshot, all int64 and of one length
ROW_COLUMNS = ("w_key", "w_start", "w_end", "w_value", "w_count")
#: placement columns (absent from host-only snapshots: zeros)
PLACEMENT_COLUMNS = ("w_resident", "w_touch")
#: required int64 scalars
SCALARS = ("n_workers", "wm", "wm_valid", "max_ts", "max_ts_valid",
           "late_count")
#: optional int64 scalars (placement counters and the early-firing clock)
OPTIONAL_SCALARS = ("wm_ticks", "t_inserted", "t_hits", "t_spilled",
                    "t_evicted")


def _canonical(snapshot) -> Dict[str, np.ndarray]:
    missing = [k for k in ("slot_table", "worker_items", *ROW_COLUMNS,
                           *SCALARS) if k not in snapshot]
    if missing:
        raise KeyError(f"snapshot lacks {missing}")
    n = len(np.asarray(snapshot["w_key"]))
    out: Dict[str, np.ndarray] = {
        "slot_table": np.asarray(snapshot["slot_table"], np.int32).copy(),
        "worker_items": np.asarray(snapshot["worker_items"], np.int64).copy(),
    }
    for k in ROW_COLUMNS + PLACEMENT_COLUMNS:
        col = np.asarray(snapshot.get(k, np.zeros(n, np.int64)), np.int64)
        if col.shape != (n,):
            raise ValueError(f"{k} has shape {col.shape}, expected ({n},)")
        out[k] = col.copy()
    for k in SCALARS + OPTIONAL_SCALARS:
        out[k] = np.int64(snapshot.get(k, 0))
    if len(out["worker_items"]) != int(out["n_workers"]):
        raise ValueError("worker_items does not match n_workers")
    return out


def state_from_reference(snapshot) -> Dict[str, np.ndarray]:
    """The JAX package's canonical keyed snapshot -> the port's state."""
    return _canonical(snapshot)


def state_to_reference(state) -> Dict[str, np.ndarray]:
    """The port's canonical keyed state -> the JAX package's snapshot."""
    return _canonical(state)
