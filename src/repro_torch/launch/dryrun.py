"""Dry-run: every (arch x shape) cell on the production meshes, on the
``meta`` device, with no card and no memory.

Port of ``repro/launch/dryrun.py``'s intent.  The reference lowers and
compiles each cell for 256 or 512 placeholder chips and reads XLA's memory
and cost analyses; eager PyTorch has no lowering, so for each cell that
:func:`~repro_torch.models.config.shape_applicable` admits this builds the
cell (:func:`repro_torch.launch.steps.build_cell`) and records:

* ``meta``: arch, shape, mesh sizes and the knobs (the reference's);
* ``bytes_per_chip``: ``params``, ``opt_state``, ``caches`` and ``batch``,
  each leaf's bytes divided by the product of the mesh sizes of the axes
  its spec names (the reference's ``argument_size_in_bytes``; the
  activations are ``memory_analysis``'s temps, below);
* ``flops``: the step run once on ``meta`` under
  ``torch.utils.flop_counter.FlopCounterMode`` (forward and backward of a
  training cell, remat included): the total and the products alone
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``), per step and per chip.  Eager
  execution counts every loop iteration, which the reference's
  ``hlo_analysis.py`` exists to recover from HLO.  Off the card the kernels'
  plain versions run (``kernels/ops.py``), so attention is counted over
  every (query, key) pair, masked ones too, and the SSD scan in chunks of
  256; the layers run the port's unpadded heads, so the caches of the step
  are the one-rank layout's (the bytes are the padded ones);
* ``model_flops``: ``model_flops_per_token x tokens x mult`` with the
  reference's ``mult`` (1 for training, 1/3 for inference, whose tokens are
  a prefill's prompt or a decode step's one token a row);
* ``costs`` (the reference's ``hlo_costs`` keys): rank 0's own step on
  its layout, the cell built on a :func:`~repro_torch.launch.mesh.
  counting_mesh` at rank 0's coordinates and run once on ``meta`` over the
  rank's shards under :func:`~repro_torch.launch.cost_analysis.
  analyze_step`, every hand kernel charged as its one launch on the card
  (its closed form, ``kernels/costs.py``): ``flops_per_chip``,
  ``dot_flops_per_chip``, ``hbm_bytes_per_chip``,
  ``collective_bytes_per_chip`` and its ``collective_breakdown`` by family
  (the wire bytes of the rank's collectives, the reference's ring
  formulas), ``num_partitions``, ``warnings``, ``peak_bytes_per_chip``
  (the live bytes' high-water mark above the arguments) and
  ``kernel_launches``.  Rank 0 stands for every rank, as one partition
  does in the reference: the rules give every rank the same shapes.  These
  count what a rank runs (padded heads, the ZeRO gathers at use, work
  every rank repeats), which ``flops``, the whole step divided by the
  chips, does not see.  A cell whose inputs the rules cannot split (a
  batch smaller than the data axes), or whose shapes a kernel refuses as
  the card would (a head_dim it is not built for), has ``{"skipped":
  reason}`` here;
* ``memory_analysis`` (the reference's keys): ``argument_size_in_bytes``
  (rank 0's shards), ``output_size_in_bytes`` (the step's results, the
  arguments it updates in place among them), ``temp_size_in_bytes`` (the
  peak above the arguments) and ``generated_code_size_in_bytes`` (None);
* ``timings``: seconds to build the cell, to count the whole step (a
  cell's second layout takes the first one's count: ``flops_counted_for``)
  and to count rank 0's step.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
        --shape prefill_32k [--multipod | --both-meshes] [--knob k=v] \\
        [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

One JSON per cell under ``--out`` (``{arch}_{shape}_{pod1|pod2}.json``),
``status`` ``ok``, ``skip`` (with the reason) or ``error``; exits 1 on any
error.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.launch import cost_analysis, steps
from repro_torch.launch.cost_analysis import PRODUCT_OPS
from repro_torch.launch.mesh import (
    MeshLayout, counting_mesh, make_production_mesh,
)
from repro_torch.launch.sharding import spec_divisor
from repro_torch.models import transformer as T
from repro_torch.models.config import (
    ALL_SHAPES, ModelConfig, ShapeConfig, shape_applicable,
)

__all__ = ["PRODUCT_OPS", "cell_bytes", "count_flops", "main", "model_flops",
           "rank_costs", "run_cell"]

ACTIVATIONS_NOTE = ("the step's arguments, as the reference's "
                    "argument_size_in_bytes; activations are in "
                    "memory_analysis's temp_size_in_bytes")


def _leaf_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree, pspecs, layout: MeshLayout) -> int:
    """Per-chip bytes of matching trees of tensors and specs (dicts,
    lists, or a Transformer with ``{name: spec}``)."""
    if isinstance(tree, torch.nn.Module):
        return sum(_leaf_bytes(p) // spec_divisor(pspecs[name], layout)
                   for name, p in tree.named_parameters())
    if isinstance(tree, torch.Tensor):
        return _leaf_bytes(tree) // spec_divisor(pspecs, layout)
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], pspecs[k], layout) for k in tree)
    return sum(_tree_bytes(t, p, layout) for t, p in zip(tree, pspecs))


def cell_bytes(cell: steps.Cell, layout: MeshLayout) -> Dict[str, int]:
    """``{params, opt_state | caches, batch, total}``: the cell's argument
    bytes per chip of ``layout``."""
    out = {key: _tree_bytes(cell.specs[key], cell.pspecs[key], layout)
           for key in cell.specs}
    out["total"] = sum(out.values())
    return out


def count_flops(cell: steps.Cell, cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, int]:
    """The step run once on ``meta`` under ``FlopCounterMode`` ->
    ``{"total", "products"}`` per step.  A serve cell runs on the one-rank
    layout's caches (the layers' own head counts)."""
    args = dict(cell.specs)
    if "caches" in args:
        args["caches"] = steps.cache_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        cell.step(*args.values())
    per_op = counter.get_flop_counts().get("Global", {})
    products = sum(v for op, v in per_op.items()
                   if getattr(op, "__name__", str(op)).split(".")[0]
                   in PRODUCT_OPS)
    return {"total": int(counter.get_total_flops()),
            "products": int(products)}


def rank_costs(cfg: ModelConfig, shape: ShapeConfig, layout: MeshLayout,
               coords=None, **knob_overrides):
    """(``costs``, ``memory_analysis``) of the rank at ``coords`` (rank 0's
    by default) of ``layout``: its step on a counting mesh, counted by
    :func:`~repro_torch.launch.cost_analysis.count_cell`."""
    cell = steps.build_cell(cfg, shape, layout, device="meta",
                            mesh=counting_mesh(layout, coords),
                            **knob_overrides)
    s = cost_analysis.count_cell(cell)
    costs = {"flops_per_chip": s.flops,
             "dot_flops_per_chip": s.dot_flops,
             "hbm_bytes_per_chip": s.hbm_bytes,
             "collective_bytes_per_chip": s.collective_bytes,
             "collective_breakdown": s.collective_breakdown,
             "num_partitions": s.num_partitions,
             "warnings": s.warnings[:20],
             "peak_bytes_per_chip": s.peak_bytes,
             "kernel_launches": s.kernel_launches,
             "roofline_ms": s.roofline_ms(),
             "counted_on": "meta, rank 0's shards on a counting mesh, hand "
                           "kernels by their closed forms"}
    memory = {"argument_size_in_bytes": s.argument_bytes,
              "output_size_in_bytes": s.output_bytes,
              "temp_size_in_bytes": s.peak_bytes,
              "generated_code_size_in_bytes": None}
    return costs, memory


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """``model_flops_per_token x tokens x mult`` (the reference's)."""
    if shape.kind == "train":
        tokens, mult = shape.global_batch * shape.seq_len, 1.0
    elif shape.kind == "prefill":
        tokens, mult = shape.global_batch * shape.seq_len, 1.0 / 3.0
    else:
        tokens, mult = shape.global_batch, 1.0 / 3.0
    return T.model_flops_per_token(cfg) * tokens * mult


def run_cell(cfg: ModelConfig, shape: ShapeConfig, layout: MeshLayout,
             out_dir: Optional[str], tag: str, *,
             counted: Optional[dict] = None, **knob_overrides) -> dict:
    """One cell's record (written to ``out_dir`` unless None).  The step
    is the same on every layout, so with a ``counted`` dict a count made
    for another layout of the cell is taken from it (the record says
    which)."""
    t0 = time.perf_counter()
    record = {"arch": cfg.name, "shape": shape.name, "tag": tag,
              "status": "ok"}
    try:
        cell = steps.build_cell(cfg, shape, layout, device="meta",
                                **knob_overrides)
        record.update(cell.meta)
        t_build = time.perf_counter() - t0
        record["bytes_per_chip"] = cell_bytes(cell, layout)
        record["bytes_note"] = ACTIVATIONS_NOTE
        key = (cfg.name, shape.name, json.dumps(cell.meta["knobs"]))
        if counted is not None and key in counted:
            flops, t_count, first = counted[key]
            record["flops_counted_for"] = first
        else:
            t1 = time.perf_counter()
            flops = count_flops(cell, cfg, shape)
            t_count = time.perf_counter() - t1
            if counted is not None:
                counted[key] = (flops, t_count, tag)
        chips = layout.size
        record["flops"] = {
            "per_step": flops["total"],
            "products_per_step": flops["products"],
            "per_chip": flops["total"] / chips,
            "products_per_chip": flops["products"] / chips,
            "counted_on": "meta (FlopCounterMode; plain versions)",
        }
        record["model_flops"] = model_flops(cfg, shape)
        t2 = time.perf_counter()
        try:
            record["costs"], record["memory_analysis"] = rank_costs(
                cfg, shape, layout, **knob_overrides)
            c = record["costs"]
            rank = (f"{c['flops_per_chip']:.4g} flops/chip, "
                    f"{c['collective_bytes_per_chip']:.4g} coll B/chip, "
                    f"peak {c['peak_bytes_per_chip']:.4g} B")
        except ValueError as e:   # the rules or a kernel refuse the rank
            record["costs"] = record["memory_analysis"] = {
                "skipped": f"{type(e).__name__}: {e}"}
            rank = f"rank count skipped: {e}"
        t_rank = time.perf_counter() - t2
        record["timings"] = {"build_s": t_build, "count_s": t_count,
                             "rank_count_s": t_rank}
        print(f"[dryrun] {tag} {cfg.name} x {shape.name}: OK "
              f"(build {t_build:.2f}s count {t_count:.2f}s rank "
              f"{t_rank:.2f}s, {record['bytes_per_chip']['total']:.4g} "
              f"B/chip, {rank})", flush=True)
    except Exception as e:  # noqa: BLE001 -- recorded, and the run fails
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=20)
        print(f"[dryrun] {tag} {cfg.name} x {shape.name}: FAIL {e}",
              flush=True)
    if out_dir is not None:
        _write(out_dir, record)
    return record


def _write(out_dir: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['arch']}_{record['shape']}_{record['tag']}.json"
    with open(os.path.join(out_dir, name.replace("/", "_")), "w") as f:
        json.dump(record, f, indent=1, default=str)


def _parse_knobs(pairs):
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        out[k] = {"true": True, "false": False}.get(v.lower(), None)
        if out[k] is None:
            out[k] = int(v) if v.isdigit() else v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multipod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", default="results/dryrun_torch")
    p.add_argument("--knob", action="append", default=[],
                   help="key=value CellKnobs override (e.g. microbatches=8)")
    args = p.parse_args(argv)
    overrides = _parse_knobs(args.knob)

    if args.both_meshes:
        meshes = [("pod1", make_production_mesh(multi_pod=False)),
                  ("pod2", make_production_mesh(multi_pod=True))]
    else:
        tag = "pod2" if args.multipod else "pod1"
        meshes = [(tag, make_production_mesh(multi_pod=args.multipod))]
    arch_names = configs.names() if (args.all or not args.arch) \
        else [args.arch]
    shapes = ALL_SHAPES if (args.all or not args.shape) \
        else [s for s in ALL_SHAPES if s.name == args.shape]
    if not shapes:
        p.error(f"unknown shape {args.shape!r}; known: "
                f"{[s.name for s in ALL_SHAPES]}")

    t0 = time.perf_counter()
    ok = fail = skip = 0
    counted: dict = {}
    for name in arch_names:
        cfg = configs.get(name)
        for shape in shapes:
            applicable, reason = shape_applicable(cfg, shape)
            if not applicable:
                print(f"[dryrun] SKIP {cfg.name} x {shape.name}: {reason}",
                      flush=True)
                for tag, _ in meshes:
                    _write(args.out, {"arch": cfg.name, "shape": shape.name,
                                      "status": "skip", "reason": reason,
                                      "tag": tag})
                    skip += 1
                continue
            for tag, layout in meshes:
                rec = run_cell(cfg, shape, layout, args.out, tag,
                               counted=counted, **overrides)
                ok += rec["status"] == "ok"
                fail += rec["status"] != "ok"
    print(f"[dryrun] DONE ok={ok} fail={fail} skip={skip} "
          f"wall={time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
