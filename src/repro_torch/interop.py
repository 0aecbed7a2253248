"""State and weight carry-over between the JAX reference and the port.

The keyed plane's data is made from a seed, so what carries over between
the two packages is the STATE: the canonical snapshot that
``StreamExecutor.state`` returns (a dict of host numpy arrays, the same
layout in both packages).  :func:`state_from_reference` takes the
reference's snapshot and returns the port's state; a port executor given it
(``executor.state = ...``) continues the stream exactly where the reference
would.  :func:`state_to_reference` goes the other way.  Neither needs the
other package: both sides are plain numpy.

The serving slices carry MODEL WEIGHTS the same way, and the training slice
the AdamW state (:func:`opt_state_to_reference`,
:func:`opt_state_from_reference`: ``m`` and ``v`` leaf for leaf as the
parameters, ``step`` an int), which is how a training checkpoint is
written under the reference's leaf names and shapes:
:func:`params_from_reference` takes the reference's parameter pytree (its
leaves as numpy arrays) and returns the port's
:class:`~repro_torch.models.transformer.Transformer`;
:func:`params_to_reference` goes the other way.  The reference stacks its
layers as ``units[f"l{i}"][leaf][u]`` after the unrolled ``prefix_layers``;
the port's layer ``len(prefix) + u * len(unit) + i`` is that entry.  An
encoder-decoder's encoder is stacked as ``enc_units[leaf][i]``, the port's
``encoder[i]``; ``frontend_proj.w`` and ``enc_final_norm.scale`` are
single leaves.  The leaves of a layer depend on its kind (attention or
Mamba-2 mixer; dense, MoE or no MLP; a cross attention in every decoder
layer of an encoder-decoder); ``put`` casts each to its parameter's dtype,
and the float32 leaves (``A_log``, ``D``, ``dt_bias``, ``router``,
``router_bias``) are float32 parameters in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# model weights
# ---------------------------------------------------------------------------

_ATTENTION_LEAVES = ("wq", "wk", "wv", "wo")
_MAMBA_LEAVES = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B",
                 "conv_C", "A_log", "D", "dt_bias", "norm.scale", "w_out")
_MLP_LEAVES = ("wi_gate", "wi_up", "wo")
_MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _layer_leaves(cfg, spec, cross=False):
    """The leaves of one layer of kind ``spec`` (with a cross attention when
    ``cross``) as port attribute paths (``"mixer.norm.scale"``); the
    reference's path inside its layer dict is the same split at the
    dots."""
    from repro_torch.models.config import DENSE, MAMBA, MOE

    out = ["ln1.scale"]
    mixer = _MAMBA_LEAVES if spec.mixer == MAMBA else _ATTENTION_LEAVES
    out += [f"mixer.{leaf}" for leaf in mixer]
    if cfg.post_norms:
        out.append("post_ln1.scale")
    if cross:
        out.append("ln_cross.scale")
        out += [f"cross.{leaf}" for leaf in _ATTENTION_LEAVES]
    if spec.mlp == DENSE:
        out += [f"mlp.{leaf}" for leaf in _MLP_LEAVES]
    elif spec.mlp == MOE:
        out += [f"mlp.{leaf}" for leaf in _MOE_LEAVES]
        if cfg.moe.router_bias:
            out.append("mlp.router_bias")
        if cfg.moe.num_shared:
            out += [f"mlp.shared.{leaf}" for leaf in _MLP_LEAVES]
    if spec.mlp in (DENSE, MOE):
        out.append("ln2.scale")
        if cfg.post_norms:
            out.append("post_ln2.scale")
    return out


def _walk(tree, attr: str):
    for key in attr.split("."):
        tree = tree[key]
    return tree


def _stacked(sub, u):
    """Entry ``u`` of every leaf of a stacked layer dict (numpy arrays or
    tensors), as a getter."""
    def get(attr):
        leaf = _walk(sub, attr)
        return leaf[u] if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)[u]
    return get


def _reference_layers(tree, cfg):
    """Yield, in the port's layer order, a getter ``attr -> array`` for
    each of the reference's decoder layers."""
    prefix, unit, n_units = cfg.layout()
    for p in tree["prefix_layers"]:
        yield lambda attr, p=p: _walk(p, attr)
    for u in range(n_units):
        for i in range(len(unit)):
            yield _stacked(tree["units"][f"l{i}"], u)


def _single_leaves(model):
    """The port's leaves outside the layers, with the reference's paths."""
    out = {"embed": "embed.table", "final_norm.scale": "final_norm.scale"}
    if model.lm_head is not None:
        out["lm_head"] = "lm_head.table"
    if model.frontend_proj is not None:
        out["frontend_proj.w"] = "frontend_proj.w"
    if model.enc_final_norm is not None:
        out["enc_final_norm.scale"] = "enc_final_norm.scale"
    return out


def _put(dst: torch.Tensor, src) -> None:
    """Copy a reference leaf (a numpy array, or a tensor as the port's
    checkpoint restores it) into the port's tensor ``dst``: a tensor of
    ``dst``'s dtype bit for bit, anything else through float32."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(np.asarray(src).astype(np.float32))
    dst.copy_(src.to(dst.dtype))


def _load_reference(model, tree, cfg, dst) -> None:
    """Copy each leaf of the reference's pytree into ``dst(name)``, the
    tensor of the port's parameter called ``name`` (its name in
    ``model.named_parameters()``), or a tensor kept under that name."""
    encoder = [_stacked(tree["enc_units"], i)
               for i in range(len(model.encoder))]
    names = [f"layers.{i}" for i in range(len(model.layers))] \
        + [f"encoder.{i}" for i in range(len(model.encoder))]
    with torch.no_grad():
        for attr, path in _single_leaves(model).items():
            _put(dst(attr), _walk(tree, path))
        for name, layer, get in zip(names, (*model.layers, *model.encoder),
                                    (*_reference_layers(tree, cfg),
                                     *encoder)):
            for attr in _layer_leaves(cfg, layer.spec,
                                      layer.cross is not None):
                _put(dst(f"{name}.{attr}"), get(attr))


def load_reference_(model, tree, cfg):
    """Copy the reference's parameter pytree into the port's existing
    :class:`~repro_torch.models.transformer.Transformer` ``model`` in place
    (leaves as numpy arrays, or tensors); returns ``model``."""
    _load_reference(model, tree, cfg, model.get_parameter)
    return model


def params_from_reference(tree, cfg, *, device=None):
    """The reference's parameter pytree (numpy leaves) -> the port's
    :class:`~repro_torch.models.transformer.Transformer` on ``device``
    (``None``: the CUDA card)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.device import resolve_device

    return load_reference_(Transformer(cfg, device=resolve_device(device)),
                           tree, cfg)


def reference_tree(model, cfg, leaf, stack):
    """The reference's pytree of the port's leaves: ``leaf(name)`` gives the
    leaf of the parameter called ``name`` in ``model.named_parameters()``,
    ``stack(leaves)`` stacks a unit entry's leaves over the units.  (With
    placeholder leaves it is the template of a training checkpoint's
    restore.)"""
    prefix, unit, n_units = cfg.layout()
    n_pre = len(prefix)

    def layer_dict(names, layer, stacked):
        out: Dict[str, dict] = {}
        for attr in _layer_leaves(cfg, layer.spec, layer.cross is not None):
            *groups, last = attr.split(".")
            node = out
            for g in groups:
                node = node.setdefault(g, {})
            vals = [leaf(f"{n}.{attr}") for n in names]
            node[last] = stack(vals) if stacked else vals[0]
        return out

    layers = model.layers
    units = {f"l{i}": layer_dict(
        [f"layers.{n_pre + u * len(unit) + i}" for u in range(n_units)],
        layers[n_pre + i], True) for i in range(len(unit))}
    tree = {
        "prefix_layers": tuple(layer_dict([f"layers.{j}"], layers[j], False)
                               for j in range(n_pre)),
        "units": units,
    }
    for attr, path in _single_leaves(model).items():
        head, last = path.split(".")
        tree.setdefault(head, {})[last] = leaf(attr)
    if len(model.encoder):
        tree["enc_units"] = layer_dict(
            [f"encoder.{i}" for i in range(len(model.encoder))],
            model.encoder[0], True)
    return tree


class _Stacked(tuple):
    """A stacked reference leaf's port names, one per unit (a marker)."""


def reference_param_paths(model, cfg) -> Dict[str, tuple]:
    """``{port parameter name: (reference leaf path, stacked)}``: the
    reference's path as its tree flattens (``"embed/table"``,
    ``"prefix_layers/0/mixer/wq"``, ``"units/l0/mlp/wo"``), and whether
    that leaf stacks the port's parameter over units (``units``,
    ``enc_units``) with the others of its entry."""
    out: Dict[str, tuple] = {}

    def walk(node, path):
        if isinstance(node, _Stacked):
            for name in node:
                out[name] = (path, True)
        elif isinstance(node, str):
            out[node] = (path, False)
        elif isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, f"{path}/{key}" if path else key)
        else:  # the tuple of prefix layers
            for i, sub in enumerate(node):
                walk(sub, f"{path}/{i}")

    walk(reference_tree(model, cfg, lambda n: n, _Stacked), "")
    return out


def _numpy_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def params_to_reference(params, cfg, *, keep_dtype: bool = False):
    """The port's :class:`~repro_torch.models.transformer.Transformer` ->
    the reference's parameter pytree: leaves as float32 numpy arrays (the
    reference casts them to its own parameter dtype on use), or, with
    ``keep_dtype``, as CPU tensors in the parameters' own dtype (what a
    training checkpoint stores: bfloat16 parameters stay bfloat16)."""
    named = dict(params.named_parameters())
    if keep_dtype:
        return reference_tree(params, cfg, lambda n: _host_tensor(named[n]),
                               torch.stack)
    return reference_tree(params, cfg, lambda n: _numpy_f32(named[n]),
                           np.stack)


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

def opt_state_to_reference(state, params, cfg, *, keep_dtype: bool = False):
    """The port's AdamW state (:mod:`repro_torch.optim.adamw`: ``m``, ``v``
    by parameter name) -> the reference's ``{"m", "v", "step"}``: ``m`` and
    ``v`` leaf for leaf as :func:`params_to_reference`'s tree (float32
    numpy arrays, or CPU float32 tensors with ``keep_dtype``), ``step`` an
    ``np.int32`` (the reference's ``step`` is an int32 scalar)."""
    out = {}
    for key in ("m", "v"):
        leaves = state[key]
        if keep_dtype:
            out[key] = reference_tree(
                params, cfg, lambda n, d=leaves: _host_tensor(d[n]),
                torch.stack)
        else:
            out[key] = reference_tree(
                params, cfg, lambda n, d=leaves: _numpy_f32(d[n]), np.stack)
    out["step"] = np.int32(int(state["step"]))
    return out


def load_opt_state_(state, ref_state, params, cfg):
    """Copy the reference's AdamW state into the port's ``state`` in place
    (``m``, ``v`` by parameter name; ``step`` becomes a new int32 0-d
    tensor on its old device); returns ``state``."""
    for key in ("m", "v"):
        _load_reference(params, ref_state[key], cfg, state[key].__getitem__)
    state["step"] = torch.tensor(int(np.asarray(ref_state["step"])),
                                 dtype=torch.int32, device=state["step"].device)
    return state


def opt_state_from_reference(ref_state, params, cfg, *, device=None):
    """The reference's AdamW state -> the port's: ``m`` and ``v`` as
    float32 tensors by parameter name on ``device`` (None: each
    parameter's own device), ``step`` an int32 0-d tensor."""
    named = dict(params.named_parameters())

    def zeros(p):
        return torch.empty(p.shape, dtype=torch.float32,
                           device=device if device is not None else p.device)

    state = {key: {n: zeros(p) for n, p in named.items()}
             for key in ("m", "v")}
    state["step"] = torch.zeros((), dtype=torch.int32,
                                device=device if device is not None
                                else next(iter(named.values())).device)
    return load_opt_state_(state, ref_state, params, cfg)
