"""Atomic, async-capable checkpointing.

Port of ``repro/checkpoint/checkpoint.py``.  Layout: ``<dir>/step_<n>/``
with one ``.npy`` per leaf (copied to the host) plus ``manifest.json``
(step, user metadata, each leaf's shape and dtype).  Writes go to
``step_<n>.tmp`` and are renamed only after the manifest is fsynced, so a
crash mid-write never corrupts the newest complete step, which
:func:`latest_step` finds.

The directory format is the reference's, file for file: the same leaf
names and the same ``manifest.json``, so a directory written by either
package restores in the other.  Where the reference flattens with
``jax.tree_util``, :func:`_flatten` walks the containers the port's states
are made of:

* a ``dict`` contributes its values in sorted key order (as
  ``jax.tree_util`` does), a ``list`` or ``tuple`` its items in order, and
  ``None`` nothing;
* anything else is a leaf: a torch tensor, a numpy array or scalar, or a
  Python number;
* a leaf's name joins the dict keys and sequence indices on its path with
  ``__``.

On :func:`restore`, a tensor leaf of the template becomes a tensor on that
leaf's device (the port's counterpart of the reference's
``sharding_tree``) in the saved dtype; every other leaf comes back as the
saved numpy array, in its saved dtype.  bfloat16 tensors have no numpy
dtype and are refused (training checkpoints, ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_FLAT_SEP = "__"


def _items(node):
    """The children of a container as ``(name, child)``, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        if hasattr(node, "_fields"):
            raise TypeError("named tuples are not supported in a checkpoint")
        return [(str(i), x) for i, x in enumerate(node)]
    if node is None:
        return []
    return None


def _join(prefix: str, name: str) -> str:
    return f"{prefix}{_FLAT_SEP}{name}" if prefix else name


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{leaf name: leaf}`` in ``jax.tree_util``'s leaf order."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for name, child in items:
        flat.update(_flatten(child, _join(prefix, name)))
    return flat


def _unflatten(template, loaded: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf replaced from ``loaded``."""
    items = _items(template)
    if items is None:
        return loaded[prefix]
    kids = [_unflatten(child, loaded, _join(prefix, name))
            for name, child in items]
    if isinstance(template, dict):
        return dict(zip(sorted(template), kids))
    if isinstance(template, (list, tuple)):
        return type(template)(kids)
    return None


def _to_host(name: str, leaf) -> np.ndarray:
    """A copy of ``leaf`` on the host, taken now."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"checkpoint leaf {name!r} is a bfloat16 tensor, which has no "
                f"numpy dtype; bfloat16 checkpoints come with the training "
                f"checkpoints of ROADMAP Queue 1 item 14")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(
    ckpt_dir: str,
    step: int,
    tree,
    *,
    metadata: Optional[dict] = None,
    blocking: bool = True,
) -> Optional[threading.Thread]:
    """Write ``step_<n>`` atomically.  ``blocking=False`` returns the writer
    thread; every leaf is copied to the host before this returns, so the
    caller may change or free its tensors at once."""
    host = {k: _to_host(k, v) for k, v in _flatten(tree).items()}

    def write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
        for k, v in host.items():
            np.save(os.path.join(tmp, k + ".npy"), v)
            manifest["leaves"][k] = {"shape": list(v.shape),
                                     "dtype": str(v.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step in ``ckpt_dir`` (``.tmp`` directories and
    steps without a manifest do not count), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree):
    """Load ``step_<n>`` into the structure of ``target_tree``; returns
    ``(tree, metadata)``.  A tensor leaf of the template is replaced by a
    tensor on its device, any other leaf by the saved numpy array."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {}
    for k, leaf in _flatten(target_tree).items():
        arr = np.load(os.path.join(path, k + ".npy"))
        if isinstance(leaf, torch.Tensor):
            loaded[k] = torch.from_numpy(arr).to(leaf.device)
        else:
            loaded[k] = arr
    return _unflatten(target_tree, loaded), manifest["metadata"]
