"""A configuration file's model: the port's ``ModelConfig``, the parameter
plan, and the seeded weights that the program and the reference both get.

The plan (:func:`plan`) lists every parameter by the port's name, with its
shape, dtype and the stddev it is drawn at; it is written from the
configuration alone, each layer's part by the modules of its mixer and MLP
kinds (:func:`kind`), so a program that lays its weights out otherwise
fails :func:`load_into` instead of running on other weights.  The weights
are made on the device in groups, one group per layer plus one for the
vocabulary tables: each group is one ``torch.randn`` call of a generator
seeded from ``(seed, group)``, cut into the group's leaves, scaled and cast
to the leaf's dtype.  So a group can be made again, bit for bit, after the
window (:func:`group_weights`), and the reference never holds more than a
layer of them.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import typing
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: where the layer kinds live: ``bench/reference/<part>/<kind>.py``, one
#: module a mixer or MLP kind, holding its leaves, its reference branch and
#: (a mixer) its attention term
KINDS = Path(__file__).resolve().parent / "reference"


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float          # 0: a norm scale, zeros (RMSNorm scales by 1 + s)
    #: the share of the leaf a token passes through in products (0 for a
    #: norm scale, top_k / num_experts for a routed expert's)
    per_token: float = 1.0


def norm(name: str, d: int, dt) -> Leaf:
    return Leaf(name, (d,), dt, 0.0, 0.0)


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def layer_kinds(cfg: dict) -> List[Tuple[str, str]]:
    """(mixer, mlp) of every layer: the prefix, then the unit repeated."""
    prefix = [tuple(s) for s in cfg.get("prefix", [])]
    unit = [tuple(s) for s in cfg["unit"]]
    n = cfg["num_layers"] - len(prefix)
    if n % len(unit):
        raise ValueError(f"{n} layers do not repeat a unit of {len(unit)}")
    return prefix + unit * (n // len(unit))


def kind(cfg: dict, part: str, name: str):
    """The module of a layer kind: ``reference/<part>/<name>.py`` under the
    configuration's ``kinds`` folder (default: this checkout's)."""
    return _load(str(Path(cfg.get("kinds", KINDS)) / part / f"{name}.py"),
                 f"bench_kind_{part}_{name}".replace("-", "_"))


@functools.lru_cache(maxsize=None)
def _load(path: str, module_name: str):
    if not Path(path).exists():
        raise ValueError(f"no layer kind {module_name}: {path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def layer_modules(cfg: dict) -> List[Tuple[object, object]]:
    """(mixer module, MLP module) of every layer."""
    return [(kind(cfg, "mixer", m), kind(cfg, "mlp", f))
            for m, f in layer_kinds(cfg)]


def _as(hint, value):
    """A configuration file's value as the port's field type ``hint``:
    a dataclass from a dict, a tuple of dataclasses from a list of lists,
    anything else as it is."""
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        return hint(**value)
    args = [a for a in typing.get_args(hint) if a is not type(None)]
    if typing.get_origin(hint) is tuple and args \
            and dataclasses.is_dataclass(args[0]):
        return tuple(args[0](*v) for v in value)
    if len(args) == 1 and value is not None:
        return _as(args[0], value)
    return value


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: every key of the
    file that names one of its fields, as that field's type."""
    from repro_torch.models.config import ModelConfig

    hints = typing.get_type_hints(ModelConfig)
    return ModelConfig(**{f.name: _as(hints[f.name], cfg[f.name])
                          for f in dataclasses.fields(ModelConfig)
                          if f.name in cfg})


def plan(cfg: dict) -> List[List[Leaf]]:
    """Groups of leaves: the vocabulary tables, one group per layer (its
    mixer kind's leaves, then its MLP kind's), then the final norm."""
    d, dt = cfg["d_model"], DTYPES[cfg["param_dtype"]]
    vocab = (padded_vocab(cfg), d)
    tables = [Leaf("embed", vocab, dt, 0.02)]
    if not cfg["tie_embeddings"]:
        tables.append(Leaf("lm_head", vocab, dt, 0.02))
    groups = [tables]
    for i, (mixer, mlp) in enumerate(layer_modules(cfg)):
        p = f"layers.{i}"
        groups.append(mixer.leaves(cfg, p, dt) + mlp.leaves(cfg, p, dt))
    groups.append([norm("final_norm.scale", d, dt)])
    return groups


def group_seed(seed: int, group: int) -> int:
    return (seed * 1_000_003 + group * 7_919 + 17) % (2 ** 63)


def group_weights(cfg: dict, seed: int, group: int, device,
                  groups=None) -> Dict[str, torch.Tensor]:
    """The leaves of ``group``, made on ``device`` from ``(seed, group)``:
    one normal draw for the group, cut, scaled, cast."""
    leaves = (groups or plan(cfg))[group]
    n = sum(numel(leaf.shape) for leaf in leaves if leaf.std)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for leaf in leaves:
        if not leaf.std:
            out[leaf.name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                         device=device)
            continue
        k = numel(leaf.shape)
        out[leaf.name] = (flat[at:at + k] * leaf.std).to(leaf.dtype) \
            .view(leaf.shape)
        at += k
    return out


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def load_into(model: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Copy the seeded weights into the program's model, group by group;
    raise where its parameters differ from the plan in name, shape or
    dtype."""
    params = dict(model.named_parameters())
    groups = plan(cfg)
    want = {leaf.name: leaf for g in groups for leaf in g}
    if set(params) != set(want):
        raise ValueError(f"the program's parameters differ from the plan: "
                         f"{sorted(set(params) ^ set(want))[:8]}")
    for gi in range(len(groups)):
        for name, t in group_weights(cfg, seed, gi, params["embed"].device,
                                     groups).items():
            p = params[name]
            if p.shape != t.shape or p.dtype != t.dtype:
                raise ValueError(f"{name}: the program holds {p.dtype} "
                                 f"{tuple(p.shape)}, the plan {t.dtype} "
                                 f"{tuple(t.shape)}")
            p.copy_(t)
