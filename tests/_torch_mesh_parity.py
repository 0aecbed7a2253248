"""The runner of the multi-rank parity tests (``test_torch_mesh_*.py``).

One layout runs once: ``run_layout`` starts, side by side, a child that
runs the JAX package's steps under ``make_rules`` on a mesh of as many
placeholder host devices as the layout has ranks (the JAX package's own
``tests/spmd_checks.py`` way), and one process per rank that runs the
port's steps on a live ``torch.distributed`` mesh over gloo, on the CPU.
Both build the same weights (``init_params`` of the port from a seed,
carried to the JAX package by ``params_to_reference``) and tokens (numpy
from a seed; a train batch from each package's ``SyntheticLM``, the port's
cut on each rank by ``mesh``/``pspec``).  The long-context decode checks
(``LONG_MODELS``) serve a batch of 1 from random caches (numpy from a seed)
of ``LONG_S`` rows split over the data ranks, under each package's rules
for the cell (``knobs_for``'s defaults), at ``long_indices(layout)``: in
block 0, on its last row, on the first row of block 1 and on the cache's
last row.  ``run_layout`` then returns ``{check: (passed, detail)}``
for every name of ``checks(layout)``, which the test files parametrise
over.

The dry-run's cost count (``launch/cost_analysis.py``) is held to these
runs too: each rank counts its prefill, serve and train steps on a
counting mesh at its own coordinates (``meta`` inputs of its shards, the
plain versions counted: :func:`plain_count`) and the count's wire bytes
must equal its live gloo run's, family by family, exactly
(``counted/*``); and rank 0's product FLOPs of that prefill count (as
``tests/test_torch_launch.py``'s prefill check counts) are held to the reference's ``hlo_analysis.analyze`` of the
same step compiled by the JAX child, one partition's ``dot_flops``
(``hlo/*``; the two packages' collective bytes go into the detail).

Run by hand: ``python tests/_torch_mesh_parity.py jax dp2 out.npz`` (the
reference side) or ``... rank dp2 <rank> <port> <dir>`` (one rank).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

#: layout key -> (axis names, sizes, knob overrides)
LAYOUTS = {
    "dp2": (("data", "model"), (2, 1), dict(moe_a2a=True, zero1=True)),
    "tp2": (("data", "model"), (1, 2), {}),
    "dp2tp2": (("data", "model"), (2, 2), dict(moe_a2a=True)),
    "pod": (("pod", "data", "model"), (2, 2, 1),
            dict(moe_a2a=True, zero1=True)),
}
#: the reduced models each layout serves; ``-pad`` is MiniCPM with 3 q and
#: 3 kv heads, which a model axis of 2 pads to 4 and 4
MODELS = {
    "dp2": ("deepseek-moe-16b", "gemma2-27b", "mamba2-780m"),
    "tp2": ("gemma2-27b", "mamba2-780m", "minicpm-2b-pad",
            "deepseek-moe-16b"),
    "dp2tp2": ("deepseek-moe-16b", "gemma2-27b", "minicpm-2b-pad",
               "mamba2-780m"),
    "pod": ("deepseek-moe-16b", "minicpm-2b"),
}
#: the reduced models of the long-context decode checks (batch 1, the
#: caches' sequence over the data axes): Jamba (attention, Mamba, MoE),
#: Mamba2 with 16 heads (over every axis) and with 6 (``-h6``: over the
#: model axis only at (2, 2), replicated at (2, 2, 1)), and on dp2 Gemma2
#: (a sliding window across the block boundary, softcap)
LONG_MODELS = {
    "dp2": ("jamba-1.5-large-398b", "mamba2-780m", "mamba2-780m-h6",
            "gemma2-27b"),
    "dp2tp2": ("jamba-1.5-large-398b", "mamba2-780m", "mamba2-780m-h6"),
    "pod": ("jamba-1.5-large-398b", "mamba2-780m", "mamba2-780m-h6"),
}
#: the long-context decode's cache rows (a multiple of every layout's data
#: ranks) and its logits' tolerance (Jamba's, the scan's, 2e-4)
LONG_S = 64
LONG_TOL = {"jamba-1.5-large-398b": 2e-4}
#: the models each layout trains one step
TRAIN = {"dp2": ("deepseek-moe-16b",),
         "tp2": ("gemma2-27b", "mamba2-780m", "deepseek-moe-16b")}
#: the layouts whose rules take the all-to-all MoE route
A2A = tuple(k for k, v in LAYOUTS.items() if v[2].get("moe_a2a"))
#: the layouts that check a dense TP model's wire bytes (Gemma2; no fsdp
#: gathers there: the data axis has one rank)
WIRE_DENSE = ("tp2",)
#: models whose train step runs only for the count's wire bytes
TRAIN_WIRE = {"dp2tp2": ("gemma2-27b",)}
#: rank 0's product FLOPs against the reference's one partition's
#: (tests/test_torch_launch.py's tolerance)
FLOP_RTOL = 1e-6

SEED = 7
BATCH, PROMPT, STEPS = 4, 12, 8
S_MAX = PROMPT + STEPS
MOE_TOKENS = 8           # per sequence of the moe_ffn_a2a check
MOE_CF = 8.0             # a capacity factor that drops nothing
LOGIT_TOL = 1e-4         # the serving parity tests' tolerance
MOE_TOL = 2e-5           # tests/spmd_checks.py's moe_ffn_a2a tolerance
LOSS_RTOL = 1e-5
PARAM_ATOL = 3e-4        # a tenth of OPT's peak learning rate
LOOSE_SHARE = 1e-3       # elements allowed beyond 1e-6 (test_torch_ft)
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=1000)


def placements(spec, device_mesh) -> tuple:
    """The ``DTensor`` placements of a leaf of ``spec`` on ``device_mesh``:
    ``Shard(d)`` on every mesh dimension that dimension ``d``'s entry
    names, ``Replicate()`` on the others (the port's local shards are
    ``DTensor.from_local`` of these)."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes if a is not None]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
        for i in order:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} shards two "
                                 f"dimensions of {spec}")
            out[i] = Shard(d)
    return tuple(out)


def checks(key):
    """The check names of layout ``key``, in a fixed order."""
    out = []
    for name in MODELS[key]:
        out += [f"serve/{name}/tokens", f"serve/{name}/logits",
                f"bytes/{name}/serve", f"placements/{name}"]
    if key in A2A:
        out += ["a2a/vs_reference", "a2a/vs_oracle", "a2a/grad",
                "a2a/wire_bytes"]
    for name in MODELS[key]:
        out += [f"counted/{name}/prefill", f"counted/{name}/serve",
                f"hlo/{name}/products"]
    for name in TRAIN.get(key, ()):
        out += [f"train/{name}/loss", f"train/{name}/params",
                f"bytes/{name}/train"]
    for name in TRAIN.get(key, ()) + TRAIN_WIRE.get(key, ()):
        out.append(f"counted/{name}/train")
    if key in WIRE_DENSE:
        out.append("wire/gemma2-27b/prefill")
    for name in LONG_MODELS.get(key, ()):
        out += [f"long/{name}/{c}" for c in ("tokens", "logits", "caches",
                                              "bytes", "wire")]
    if key in LONG_MODELS:
        out.append("synthetic/shards")
    return out


def configs(name, pkg):
    """The reduced float32 configuration ``name`` of ``pkg`` (either
    package's ``configs`` module); ``-h6`` is Mamba2 with 6 state heads
    (d_model 48, head dim 16)."""
    cfg = pkg.get(name.removesuffix("-pad").removesuffix("-h6")).reduced()
    if name.endswith("-pad"):
        cfg = dataclasses.replace(cfg, name=cfg.name + "-pad", num_heads=3,
                                  num_kv_heads=3)
    if name.endswith("-h6"):
        cfg = dataclasses.replace(cfg, name=cfg.name + "-h6", d_model=48,
                                  ssm=dataclasses.replace(cfg.ssm,
                                                          headdim=16))
    return cfg


def tokens(vocab):
    rng = np.random.default_rng(SEED)
    return rng.integers(0, vocab, (BATCH, PROMPT), dtype=np.int32)


def synthetic(pkg, vocab, **sharded):
    """Each package's ``SyntheticLM`` of the train step's batch (one
    microbatch of ``BATCH`` rows of ``PROMPT`` tokens)."""
    return pkg.SyntheticLM(vocab=vocab, seq_len=PROMPT, batch=BATCH,
                           seed=SEED + 1, **sharded)


def long_shape(pkg):
    """The long-context decode's cell: ``LONG_S`` rows, batch 1."""
    return pkg.ShapeConfig("long-mesh", LONG_S, 1, "decode")


def long_indices(key):
    """The decode positions: in block 0, on its last row, on the first row
    of block 1, on the cache's last row (blocks of ``LONG_S / n_dp``)."""
    names, sizes, _ = LAYOUTS[key]
    shape = dict(zip(names, sizes))
    block = LONG_S // (shape.get("pod", 1) * shape["data"])
    return (block // 3, block - 1, block, LONG_S - 1)


def long_caches(tcfg, tp):
    """Random whole caches in the port's layout (one dict per layer, KV
    leaves ``[1, Hkv, LONG_S, hd]``), numpy float32 from a seed."""
    from repro_torch.launch import steps
    from repro_torch.models import config as tconfig

    rng = np.random.default_rng(SEED + 3)
    return [{k: rng.standard_normal(tuple(t.shape)).astype(np.float32)
             for k, t in layer.items()}
            for layer in steps.cache_specs(tcfg, long_shape(tconfig), tp=tp)]


def long_tokens(vocab):
    return np.random.default_rng(SEED + 4).integers(0, vocab, (1, 1),
                                                    dtype=np.int32)


def moe_input(d):
    rng = np.random.default_rng(SEED + 2)
    return rng.standard_normal((BATCH, MOE_TOKENS, d)).astype(np.float32)


def _path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------

def jax_main(key, out):
    names, sizes, knobs = LAYOUTS[key]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={math.prod(sizes)} "
        + os.environ.get("XLA_FLAGS", ""))
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.data import pipeline as jpipeline
    from jax.sharding import PartitionSpec as P

    from repro.launch import hlo_analysis
    from repro.launch import steps as jsteps
    from repro.launch.cells import CellKnobs as JKnobs
    from repro.launch.sharding import use_rules
    from repro.models import config as jconfig
    from repro.models import moe as jmoe
    from repro.models import transformer as JT
    from repro.optim import adamw as jadamw
    import repro_torch.configs as tconfigs
    from repro_torch.interop import params_to_reference
    from repro_torch.models import transformer as TT

    mesh = jax.make_mesh(sizes, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(sizes))
    res = {}

    def under(rules, fn):
        def run(*args):
            with use_rules(rules):
                return fn(*args)
        return jax.jit(run)

    jax_long(key, mesh, res)
    synth = synthetic(jpipeline, 256, mesh=mesh, pspec=jax.sharding
                      .PartitionSpec(names[:-1] if len(names) > 2
                                     else names[0], None)).batch_at(0)
    for r, d in enumerate(mesh.devices.flat):
        for k, arr in synth.items():
            res[f"synthetic/{r}/{k}"] = np.asarray(next(
                sh.data for sh in arr.addressable_shards if sh.device == d))
    for name in MODELS[key]:
        jcfg, tcfg = configs(name, jconfigs), configs(name, tconfigs)
        tree = params_to_reference(TT.init_params(tcfg, SEED, device="cpu"),
                                   tcfg)
        rules = jsteps.make_rules(mesh, jcfg, JKnobs(**knobs))
        prefill = under(rules, lambda p, c, b: JT.prefill_forward(
            p, b, jcfg, c))
        decode = under(rules, lambda p, c, t, i: JT.decode_forward(
            p, {"tokens": t}, jcfg, c, i))
        caches = JT.init_caches(jcfg, BATCH, S_MAX, tp=rules.tp_size())
        batch = {"tokens": tokens(jcfg.vocab_size)}
        # the step as the reference's dry-run compiles it: every argument
        # placed by its rules' specs
        shape = jconfig.ShapeConfig("mesh", S_MAX, BATCH, "prefill")
        hlo = hlo_analysis.analyze(prefill.lower(
            place(mesh, tree, jsteps.model_specs(jcfg, rules)[1]),
            place(mesh, caches, jsteps.cache_pspecs(jcfg, shape, rules)),
            place(mesh, batch, {"tokens": P(rules.dp, None)}))
            .compile().as_text())
        res[f"{name}/hlo"] = json.dumps(dict(
            dot_flops=hlo.dot_flops, num_partitions=hlo.num_partitions,
            collective_breakdown=hlo.collective_breakdown))
        logits, caches = prefill(tree, caches, batch)
        toks = [np.asarray(jnp.argmax(logits[:, -1], -1), np.int32)]
        for i in range(STEPS):
            logits, caches = decode(tree, caches, toks[-1][:, None],
                                    jnp.int32(PROMPT + i))
            toks.append(np.asarray(jnp.argmax(logits[:, -1], -1), np.int32))
        res[f"{name}/tokens"] = np.stack(toks)
        res[f"{name}/logits"] = np.asarray(logits[:, -1])

        if name == "deepseek-moe-16b" and key in A2A:
            moe = dataclasses.replace(jcfg.moe, capacity_factor=MOE_CF)
            layer = jax.tree.map(lambda a: a[0], tree["units"]["l0"]["mlp"])
            x = jnp.asarray(moe_input(jcfg.d_model))
            act = jcfg.mlp_activation

            def a2a(p):
                return jmoe.moe_ffn_a2a(x, p, moe, activation=act,
                                        rules=rules)
            y, aux = jax.jit(a2a)(layer)
            res["a2a/out"], res["a2a/aux"] = np.asarray(y), np.asarray(aux)
            res["a2a/oracle"] = np.asarray(jax.jit(
                lambda p: jmoe.moe_ffn_dense_oracle(x, p, moe,
                                                    activation=act)[0])(layer))
            grads = jax.jit(jax.grad(
                lambda p: jnp.sum(a2a(p)[0] ** 2)))(layer)
            for kp, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
                res[f"a2a/grad/{_path(kp)}"] = np.asarray(g)

        if name in TRAIN.get(key, ()):
            jk = JKnobs(microbatches=1, remat=False, **knobs)
            trules = jsteps.make_rules(mesh, jcfg, jk)
            step = jax.jit(jsteps.build_train_step(
                jcfg, trules, jk, opt_cfg=jadamw.AdamWConfig(**OPT)))
            batch = {k: np.asarray(v)[None] for k, v in synthetic(
                jpipeline, jcfg.vocab_size).batch_at(0).items()}
            new, _, metrics = step(tree, jadamw.init_state(tree), batch)
            res[f"train/{name}/loss"] = np.asarray(metrics["loss"])
            for kp, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
                res[f"train/{name}/param/{_path(kp)}"] = np.asarray(leaf)
    np.savez(out, **res)


def to_reference_caches(jcfg, tcfg, caches, jinit):
    """Port-layout caches (numpy, one dict per layer) as the reference's
    tree (``jinit``: the reference's ``init_caches`` of the same cell)."""
    import jax

    from repro_torch.launch import steps

    flat = {}
    for (path, stacked), layer in zip(steps.cache_reference_paths(tcfg),
                                      caches):
        for leaf, a in layer.items():
            if leaf in ("k", "v"):
                a = a.transpose(steps.KV_REFERENCE_DIMS)
            flat.setdefault(f"{path}/{leaf}", []).append(a)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jinit)
    out = []
    for kp, init in leaves:
        got = flat[_path(kp)]
        a = np.stack(got) if init.ndim == got[0].ndim + 1 else got[0]
        out.append(a.astype(init.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def from_reference_caches(tcfg, tree):
    """The reference's cache tree -> port-layout numpy, one dict per
    layer."""
    import jax

    from repro_torch.launch import steps

    flat = {_path(kp): np.asarray(a) for kp, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    n_pre, unit = len(tcfg.prefix), len(tcfg.unit)
    out = []
    for j, (path, stacked) in enumerate(steps.cache_reference_paths(tcfg)):
        layer = {}
        for key in flat:
            if key.rsplit("/", 1)[0] != path:
                continue
            a = flat[key][(j - n_pre) // unit] if stacked else flat[key]
            leaf = key.rsplit("/", 1)[1]
            layer[leaf] = (a.transpose(steps.KV_REFERENCE_DIMS)
                           if leaf in ("k", "v") else a)
        out.append(layer)
    return out


def place(mesh, tree, specs):
    """``tree`` placed on ``mesh`` by ``specs``, whose one spec may cover
    a subtree (a KV cache's ``k`` and ``v``)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.tree.map(lambda s, sub: jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, s)), sub),
        specs, tree, is_leaf=lambda s: isinstance(s, P))


def jax_long(key, mesh, res):
    """The reference's long-context decode on ``mesh``: its serve step
    under ``make_rules`` with ``knobs_for``'s knobs, the caches and
    parameters placed by its ``cache_pspecs`` and ``model_specs``, at each
    of ``long_indices``; the last logits of each step from
    ``decode_forward`` under the same rules on the same inputs."""
    import jax

    import repro.configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.launch.cells import knobs_for
    from repro.launch.sharding import use_rules
    from repro.models import config as jconfig
    from repro.models import transformer as JT
    import repro_torch.configs as tconfigs
    from repro_torch.interop import params_to_reference
    from repro_torch.models import transformer as TT

    shape = long_shape(jconfig)
    for name in LONG_MODELS.get(key, ()):
        jcfg, tcfg = configs(name, jconfigs), configs(name, tconfigs)
        rules = jsteps.make_rules(mesh, jcfg, knobs_for(jcfg, shape))
        tree = params_to_reference(TT.init_params(tcfg, SEED, device="cpu"),
                                   tcfg)
        tree = place(mesh, tree, jsteps.model_specs(jcfg, rules)[1])
        jinit = JT.init_caches(jcfg, 1, LONG_S, tp=rules.tp_size())
        caches = place(mesh, to_reference_caches(
            jcfg, tcfg, long_caches(tcfg, rules.tp_size()), jinit),
            jsteps.cache_pspecs(jcfg, shape, rules))
        serve = jax.jit(jsteps.build_serve_step(jcfg, rules))

        def forward(p, c, t, i):
            with use_rules(rules):
                return JT.decode_forward(p, {"tokens": t}, jcfg, c, i)[0]
        forward = jax.jit(forward)
        tok = long_tokens(jcfg.vocab_size)
        toks, logits = [], []
        for index in long_indices(key):
            i = np.int32(index)
            logits.append(np.asarray(forward(tree, caches, tok, i))[:, -1])
            nxt, caches = serve(tree, caches, {"tokens": tok, "index": i})
            tok = np.asarray(nxt, np.int32)[:, None]
            toks.append(tok[:, 0])
        res[f"long/{name}/tokens"] = np.stack(toks)
        res[f"long/{name}/logits"] = np.stack(logits)
        for j, layer in enumerate(from_reference_caches(tcfg, caches)):
            for leaf, a in layer.items():
                res[f"long/{name}/cache/{j}/{leaf}"] = a


# ---------------------------------------------------------------------------
# the port's side: one rank
# ---------------------------------------------------------------------------

def rank_main(key, rank, port, out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import repro_torch.configs as tconfigs
    from repro_torch.data import pipeline
    from repro_torch.interop import params_to_reference
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.cells import CellKnobs
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as TT
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    names, sizes, knobs = LAYOUTS[key]
    layout = mesh_lib.MeshLayout(names, sizes)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=layout.size)
    live = mesh_lib.live_mesh(layout, "cpu")
    res, flags = {}, {}

    def gather_full(t, spec):
        for dim, entry in enumerate(spec):
            t = mesh_lib.all_gather(t, live, entry, dim)
        return t

    def tensors(tree):
        if isinstance(tree, torch.nn.Module):
            return list(tree.parameters())
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in tensors(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in tensors(v)]
        return [tree]

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tensors(tree))

    dp, tp = ("pod", "data") if "pod" in names else ("data",), "model"
    for name in MODELS[key]:
        cfg = configs(name, tconfigs)
        full = TT.init_params(cfg, SEED, device="cpu")
        shape = ShapeConfig("mesh", S_MAX, BATCH, "prefill")
        cell = steps.build_cell(cfg, shape, layout, device="cpu", mesh=live,
                                **knobs)
        rules = cell.rules
        params = sh.distribute_params(full, cell.pspecs["params"], rules)
        flags[f"placements/{name}"] = all(
            torch.equal(DTensor.from_local(
                p, live.device_mesh, placements(p.mesh_spec,
                                                live.device_mesh),
                run_check=False, shape=f.shape, stride=f.stride())
                .full_tensor(), f)
            for p, f in zip(params.parameters(), full.parameters()))
        batch = sh.distribute({"tokens": torch.from_numpy(
            tokens(cfg.vocab_size))}, cell.pspecs["batch"], rules)

        def caches():
            return steps.local_zeros(cell.specs["caches"],
                                     cell.pspecs["caches"], rules, "cpu")

        got = {"params": nbytes(params), "caches": nbytes(caches())}
        want = dryrun.cell_bytes(cell, layout)
        flags[f"bytes/{name}/serve"] = all(got[k] == want[k] for k in got)
        res[f"{name}/bytes"] = json.dumps([got, want])

        # the steps (tokens), then the same run through the forwards (logits)
        mesh_lib.reset_wire_bytes()
        serve = steps.build_serve_step(cfg, rules)
        tok, c = cell.step(params, caches(), batch)
        after = [mesh_lib.wire_bytes()]
        toks = [tok]
        for i in range(STEPS):
            tok, c = serve(params, c, {"tokens": toks[-1][:, None],
                                       "index": PROMPT + i})
            toks.append(tok)
            after.append(mesh_lib.wire_bytes())
        live_wire = {"prefill": after[0],
                     "serve": {k: after[1][k] - after[0][k]
                               for k in after[0]}}
        count = counted_steps(cfg, shape, layout, live.coords, knobs,
                              batch["tokens"])
        for kind in ("prefill", "serve"):
            flags[f"counted/{name}/{kind}"] = \
                count[kind].collective_breakdown == live_wire[kind]
            res[f"counted/{name}/{kind}/rank{rank}"] = json.dumps(
                [count[kind].collective_breakdown, live_wire[kind]])
        if rank == 0:
            plain = count["prefill"]
            res[f"{name}/products_rank0"] = json.dumps(dict(
                dot_flops=plain.dot_flops,
                collective_breakdown=plain.collective_breakdown))
        if name == "gemma2-27b":
            res["wire/prefill"] = json.dumps(mesh_lib.wire_bytes())
        toks = gather_full(torch.stack(toks), (None, dp))
        res[f"{name}/tokens"] = toks.numpy()

        c = caches()
        with sh.use_rules(rules):
            logits, c = TT.prefill_forward(params, batch, cfg, c)
            nxt = steps.next_token(logits, cfg.padded_vocab)
            for i in range(STEPS):
                logits, c = TT.decode_forward(
                    params, {"tokens": nxt[:, None]}, cfg, c,
                    torch.full((nxt.shape[0],), PROMPT + i))
                nxt = steps.next_token(logits, cfg.padded_vocab)
            spec = (dp, None, tp if logits.shape[-1] != cfg.padded_vocab
                    else None)
            res[f"{name}/logits"] = gather_full(logits, spec)[:, -1].numpy()
        res[f"{name}/forward_tokens"] = gather_full(nxt, (dp,)).numpy()

        if name == "deepseek-moe-16b" and key in A2A:
            moe = dataclasses.replace(cfg.moe, capacity_factor=MOE_CF)
            layer = params.layers[1].mlp
            x = sh.distribute(torch.from_numpy(moe_input(cfg.d_model)),
                              (dp, None, None), rules)
            with sh.use_rules(rules):
                names_ = [n for n, _ in layer.named_parameters()]
                leaves = [p for _, p in layer.named_parameters()]
                for p in leaves:
                    p.requires_grad_(True)
                with torch.enable_grad():
                    whole = sh.gather_params_for_compute(layer)
                    mesh_lib.reset_wire_bytes()
                    out, aux = tmoe.moe_ffn_a2a(x, whole, moe, rules)
                    res["a2a/wire"] = json.dumps(mesh_lib.wire_bytes())
                    grads = torch.autograd.grad((out ** 2).sum(), leaves,
                                                allow_unused=True,
                                                materialize_grads=True)
                for p in leaves:
                    p.requires_grad_(False)
            res["a2a/out"] = gather_full(out.detach(), (dp,)).numpy()
            res["a2a/aux"] = aux.detach().numpy()
            for n_, p, g in zip(names_, leaves, grads):
                used = {a for e in p.mesh_spec
                        for a in (e if isinstance(e, tuple) else (e,))}
                g = mesh_lib.all_reduce(g, live, tuple(
                    a for a in dp if a not in used))
                res[f"a2a/grad/{n_}"] = gather_full(g, p.mesh_spec).numpy()
            t_local = x.shape[0] * x.shape[1]
            res["a2a/geometry"] = json.dumps(dict(
                t_local=t_local, d=cfg.d_model, e=moe.num_experts,
                k=moe.top_k, cap=max(4, -(-int(t_local * moe.top_k * MOE_CF
                                                / moe.num_experts) // 4) * 4),
                n_ep=live.size("data"), tp=live.size(tp),
                n_dp=live.size(dp)))

        if name in TRAIN.get(key, ()):
            tshape = ShapeConfig("mesh-train", PROMPT, BATCH, "train")
            tcell = steps.build_cell(cfg, tshape, layout, device="cpu",
                                     mesh=live, microbatches=1, remat=False,
                                     **knobs)
            params = sh.distribute_params(full, tcell.pspecs["params"],
                                          tcell.rules)
            opt = adamw.init_state(params)
            # one microbatch [mb, S]: the batch spec without its k axis
            tb = synthetic(pipeline, cfg.vocab_size, device="cpu", mesh=live,
                           pspec=tcell.pspecs["batch"]["tokens"][1:]
                           ).batch_at(0)
            got = {"params": nbytes(params), "opt_state": nbytes(opt),
                   "batch": nbytes(tb)}
            want = dryrun.cell_bytes(tcell, layout)
            flags[f"bytes/{name}/train"] = all(got[k] == want[k]
                                               for k in got)
            res[f"train/{name}/bytes"] = json.dumps([got, want])
            step = steps.build_train_step(
                cfg, CellKnobs(microbatches=1, remat=False, **knobs),
                adamw.AdamWConfig(**OPT), rules=tcell.rules)
            mesh_lib.reset_wire_bytes()
            params, opt, metrics = step(params, opt, tb)
            counted_train(cfg, tshape, layout, live.coords, knobs,
                          mesh_lib.wire_bytes(), name, rank, flags, res)
            res[f"train/{name}/loss"] = metrics["loss"].detach().numpy()
            whole = TT.init_params(cfg, SEED, device="cpu")
            for (n_, p), w in zip(params.named_parameters(),
                                  whole.parameters()):
                w.data.copy_(gather_full(p.detach(), p.mesh_spec))
            for path, leaf in _flat_tree(params_to_reference(whole, cfg)):
                res[f"train/{name}/param/{path}"] = leaf

    for name in TRAIN_WIRE.get(key, ()):
        cfg = configs(name, tconfigs)
        tshape = ShapeConfig("mesh-train", PROMPT, BATCH, "train")
        tcell = steps.build_cell(cfg, tshape, layout, device="cpu",
                                 mesh=live, microbatches=1, remat=False,
                                 **knobs)
        params = sh.distribute_params(TT.init_params(cfg, SEED, device="cpu"),
                                      tcell.pspecs["params"], tcell.rules)
        tb = synthetic(pipeline, cfg.vocab_size, device="cpu", mesh=live,
                       pspec=tcell.pspecs["batch"]["tokens"][1:]).batch_at(0)
        step = steps.build_train_step(
            cfg, CellKnobs(microbatches=1, remat=False, **knobs),
            adamw.AdamWConfig(**OPT), rules=tcell.rules)
        mesh_lib.reset_wire_bytes()
        step(params, adamw.init_state(params), tb)
        counted_train(cfg, tshape, layout, live.coords, knobs,
                      mesh_lib.wire_bytes(), name, rank, flags, res)

    rank_long(key, live, res, flags, gather_full, nbytes)
    mine = synthetic(pipeline, 256, device="cpu", mesh=live,
                     pspec=(dp, None)).batch_at(0)
    every = [None] * layout.size
    dist.all_gather_object(every, {k: v.numpy() for k, v in mine.items()})
    for r, part in enumerate(every):
        for k, v in part.items():
            res[f"synthetic/{r}/{k}"] = v

    all_flags = [None] * layout.size
    dist.all_gather_object(all_flags, flags)
    if rank == 0:
        merged = {k: all(f[k] for f in all_flags) for k in flags}
        res["flags"] = json.dumps(merged)
        np.savez(os.path.join(out_dir, "port.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def plain_count():
    """Counts with the plain versions, op by op (ops mode ``ref``): the
    reduced configurations' head_dim 16 is no kernel's, and the live ranks
    ran the plain versions too; the collectives are the model's either
    way."""
    from repro_torch.kernels import ops

    ops.use_kernels("ref")
    try:
        yield
    finally:
        ops.use_kernels("auto")


def counted_steps(cfg, shape, layout, coords, knobs, tokens):
    """The dry-run's count (``cost_analysis.analyze_step``, under
    :func:`plain_count`) of the rank at ``coords``: the prefill cell built
    on a counting mesh of ``layout``, its prefill step over ``meta`` tokens
    of ``tokens``' shape and one serve step, on the rank's ``meta`` shards
    -> ``{"prefill", "serve"}`` summaries."""
    import torch

    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import counting_mesh

    cell = steps.build_cell(cfg, shape, layout, device="meta",
                            mesh=counting_mesh(layout, coords), **knobs)
    args = ca.rank_inputs(cell)
    meta = {"tokens": torch.empty(tokens.shape, dtype=tokens.dtype,
                                  device="meta")}
    dec = {"tokens": torch.empty((tokens.shape[0], 1), dtype=tokens.dtype,
                                 device="meta"),
           "index": torch.empty((), dtype=torch.int64, device="meta")}
    with plain_count():
        pre = ca.analyze_step(cell.step,
                              [args["params"], args["caches"], meta],
                              num_partitions=layout.size)
        serve = ca.analyze_step(steps.build_serve_step(cfg, cell.rules),
                                [args["params"], args["caches"], dec],
                                num_partitions=layout.size)
    return {"prefill": pre, "serve": serve}


def counted_train(cfg, tshape, layout, coords, knobs, live_wire, name, rank,
                  flags, res):
    """The count of the rank's train step (one microbatch, no remat, the
    runs' AdamW; under :func:`plain_count`) on a counting mesh at
    ``coords``, held to its live wire bytes (``counted/<name>/train``)."""
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import steps
    from repro_torch.launch.cells import CellKnobs
    from repro_torch.launch.mesh import counting_mesh
    from repro_torch.optim import adamw

    cell = steps.build_cell(cfg, tshape, layout, device="meta",
                            mesh=counting_mesh(layout, coords),
                            microbatches=1, remat=False, **knobs)
    step = steps.build_train_step(
        cfg, CellKnobs(microbatches=1, remat=False, **knobs),
        adamw.AdamWConfig(**OPT), rules=cell.rules)
    with plain_count():
        got = ca.analyze_step(step, list(ca.rank_inputs(cell).values()),
                              num_partitions=layout.size).collective_breakdown
    flags[f"counted/{name}/train"] = got == live_wire
    res[f"counted/{name}/train/rank{rank}"] = json.dumps([got, live_wire])


def long_wire(cfg, rules, spec):
    """The closed forms of one rank's wire bytes of a long-context decode
    step's layer of ``spec`` (batch 1, float32): an attention layer's merge
    all-gathers ``(o, lse)``, ``Hq_r (hd + 1)`` floats from each of the
    other ``n_dp - 1`` data ranks (``Hq_r`` the rank's q heads); a Mamba
    layer whose state's heads lie over every axis sends its owner ``Hl (P
    + 1)`` floats of inputs (from rank ``(k mod n_dp) n_tp + k // n_dp``,
    nothing when that is itself) and gets back ``Hl P`` floats of ``y``
    from each of the ``n_dp`` owners of its TP block but itself."""
    from repro_torch.models import attention as attn
    from repro_torch.models import mamba2
    from repro_torch.models.config import MAMBA

    live = rules.live
    n_dp, n_tp = live.size(rules.dp), live.size(rules.tp_axis)
    if spec.mixer != MAMBA:
        hq = attn.padded_head_counts(cfg.num_heads, cfg.num_kv_heads,
                                     n_tp)[0]
        hq_r = hq // n_tp if hq % n_tp == 0 else cfg.num_heads
        return {"all_gather": (n_dp - 1) * hq_r * (cfg.head_dim_ + 1) * 4.0}
    _, h = mamba2.dims(cfg.d_model, cfg.ssm)
    if not isinstance(mamba2.long_decode_heads(h, rules), tuple):
        return {"all_to_all": 0.0}
    p, hl = cfg.ssm.headdim, h // (n_dp * n_tp)
    j, t = live.index(rules.dp), live.index(rules.tp_axis)
    k = j * n_tp + t
    fwd = 0 if (k % n_dp) * n_tp + k // n_dp == k else hl * (p + 1) * 4
    back = (n_dp - (k // n_dp == t)) * hl * p * 4
    return {"all_to_all": float(fwd + back)}


def rank_long(key, live, res, flags, gather_full, nbytes):
    """The port's long-context decode on this rank: ``build_cell``'s serve
    step on the rank's shards of the random caches (tokens, the final
    caches gathered), the same steps through ``decode_forward`` under the
    cell's rules (each step's last logits), each rank's bytes against the
    dry-run's, and one attention and one Mamba layer's decode alone under
    the rules for their wire bytes (``long_wire``)."""
    import torch

    import repro_torch.configs as tconfigs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn
    from repro_torch.models import config as tconfig
    from repro_torch.models import mamba2
    from repro_torch.models import transformer as TT

    layout = live.layout
    for name in LONG_MODELS.get(key, ()):
        cfg = configs(name, tconfigs)
        cell = steps.build_cell(cfg, long_shape(tconfig), layout,
                                device="cpu", mesh=live)
        rules = cell.rules
        params = sh.distribute_params(TT.init_params(cfg, SEED, device="cpu"),
                                      cell.pspecs["params"], rules)
        whole = [{k: torch.from_numpy(a) for k, a in layer.items()}
                 for layer in long_caches(cfg, rules.tp_size())]

        def caches():
            return sh.distribute(whole, cell.pspecs["caches"], rules)

        got = {"params": nbytes(params), "caches": nbytes(caches())}
        want = dryrun.cell_bytes(cell, layout)
        flags[f"long/{name}/bytes"] = all(got[k] == want[k] for k in got)
        res[f"long/{name}/bytes"] = json.dumps([got, want])

        tok = torch.from_numpy(long_tokens(cfg.vocab_size))
        c_step, c_fwd = caches(), caches()
        toks, fwd_toks, logits = [], [], []
        for index in long_indices(key):
            with sh.use_rules(rules):
                out, c_fwd = TT.decode_forward(
                    params, {"tokens": tok}, cfg, c_fwd,
                    torch.full((1,), index))
                fwd_toks.append(steps.next_token(out, cfg.padded_vocab))
            split = out.shape[-1] != cfg.padded_vocab
            logits.append(gather_full(out, (None, None, "model" if split
                                            else None))[:, -1])
            nxt, c_step = cell.step(params, c_step, {"tokens": tok,
                                                     "index": index})
            toks.append(nxt)
            tok = nxt[:, None]
        res[f"long/{name}/tokens"] = torch.stack(toks).numpy()
        res[f"long/{name}/forward_tokens"] = torch.stack(fwd_toks).numpy()
        res[f"long/{name}/logits"] = torch.stack(logits).numpy()
        for j, (layer, spec) in enumerate(zip(c_step,
                                              cell.pspecs["caches"])):
            for leaf, t in layer.items():
                res[f"long/{name}/cache/{j}/{leaf}"] = gather_full(
                    t, spec[leaf]).numpy()

        # one layer of each mixer alone: its wire bytes
        ok, readings = True, []
        x = torch.from_numpy(np.random.default_rng(SEED + 5)
                             .standard_normal((1, 1, cfg.d_model))
                             .astype(np.float32))
        seen = set()
        for layer, cache in zip(params.layers, caches()):
            if layer.spec.mixer in seen:
                continue
            seen.add(layer.spec.mixer)
            with sh.use_rules(rules):
                g = sh.gather_params_for_compute(layer)
                mesh_lib.reset_wire_bytes()
                if layer.spec.mixer == tconfig.MAMBA:
                    mamba2.mamba_block(x, g.mixer, cfg.ssm,
                                       norm_eps=cfg.norm_eps, state=cache)
                else:
                    attn.attention_block(
                        x, g.mixer, cache=cache,
                        cache_index=torch.full((1,), LONG_S // 2 - 1),
                        mode=(attn.SLIDING if layer.spec.mixer
                              == tconfig.SLIDING else attn.CAUSAL),
                        **layer.attn_kwargs)
            counted = mesh_lib.wire_bytes()
            closed = long_wire(cfg, rules, layer.spec)
            ok &= all(counted[k] == v for k, v in closed.items())
            readings.append((layer.spec.mixer, counted, closed))
        flags[f"long/{name}/wire"] = ok
        res[f"long/{name}/wire"] = json.dumps(readings)


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tree(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_tree(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


# ---------------------------------------------------------------------------
# running a layout
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_layout(key, tmp, timeout=400):
    """Runs layout ``key`` (both sides) in ``tmp`` -> ``{check: (passed,
    detail)}``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    me = os.path.abspath(__file__)
    ref_out = os.path.join(tmp, "jax.npz")
    world = math.prod(LAYOUTS[key][1])
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, me, "jax", key, ref_out],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, me, "rank", key, str(r),
                                str(port), str(tmp)], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tail = "\n".join(logs[i][-3000:] for i in failed)
        raise RuntimeError(f"layout {key}: processes {failed} failed\n{tail}")
    return compare(key, np.load(ref_out), np.load(os.path.join(
        tmp, "port.npz")))


def _close(got, want, tol):
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(want, np.float64))))
    return err <= tol, f"max abs err {err:.3g} (limit {tol:.3g})"


def compare(key, ref, port):
    flags = json.loads(str(port["flags"]))
    out = {}
    for name in MODELS[key]:
        eq = np.array_equal(port[f"{name}/tokens"], ref[f"{name}/tokens"]) \
            and np.array_equal(port[f"{name}/forward_tokens"],
                               ref[f"{name}/tokens"][-1])
        out[f"serve/{name}/tokens"] = (eq, f"port {port[f'{name}/tokens']}"
                                       f" reference {ref[f'{name}/tokens']}")
        out[f"serve/{name}/logits"] = _close(port[f"{name}/logits"],
                                             ref[f"{name}/logits"], LOGIT_TOL)
        out[f"bytes/{name}/serve"] = (flags[f"bytes/{name}/serve"],
                                      str(port[f"{name}/bytes"]))
        out[f"placements/{name}"] = (flags[f"placements/{name}"], name)
    if key in A2A:
        out["a2a/vs_reference"] = _close(port["a2a/out"], ref["a2a/out"],
                                         MOE_TOL)
        ok, msg = _close(port["a2a/out"], ref["a2a/oracle"], MOE_TOL)
        aux_ok, aux_msg = _close(port["a2a/aux"], ref["a2a/aux"], MOE_TOL)
        out["a2a/vs_oracle"] = (ok and aux_ok, f"{msg}; aux {aux_msg}")
        worst, msgs = True, []
        for leaf, port_name in (("router", "router"), ("w_gate", "w_gate"),
                                ("w_up", "w_up"), ("w_down", "w_down"),
                                ("shared/wi_gate", "shared.wi_gate"),
                                ("shared/wi_up", "shared.wi_up"),
                                ("shared/wo", "shared.wo")):
            want = ref[f"a2a/grad/{leaf}"]
            ok, msg = _close(port[f"a2a/grad/{port_name}"], want,
                             MOE_TOL * float(np.max(np.abs(want))))
            worst &= ok
            msgs.append(f"{leaf}: {msg}")
        out["a2a/grad"] = (worst, "; ".join(msgs))
        g = json.loads(str(port["a2a/geometry"]))
        got = json.loads(str(port["a2a/wire"]))
        n_ep, tp, n_dp = g["n_ep"], g["tp"], g["n_dp"]
        want = {"all_to_all": 2 * g["e"] * g["cap"] * g["d"] * 4
                * (n_ep - 1) / n_ep,
                "all_reduce": 2 * g["t_local"] * g["d"] * 4 * (tp - 1) / tp
                + 2 * 4 * (n_dp - 1) / n_dp,
                "all_gather": 0.0, "reduce_scatter": 0.0}
        out["a2a/wire_bytes"] = (got == want, f"counted {got}, closed form "
                                 f"{want}")
    for name in MODELS[key]:
        for kind in ("prefill", "serve"):
            out[f"counted/{name}/{kind}"] = _counted(flags, port, name, kind)
        out[f"hlo/{name}/products"] = _products(port, ref, key, name)
    for name in TRAIN.get(key, ()) + TRAIN_WIRE.get(key, ()):
        out[f"counted/{name}/train"] = _counted(flags, port, name, "train")
    for name in TRAIN.get(key, ()):
        out[f"train/{name}/loss"] = (
            abs(float(port[f"train/{name}/loss"])
                - float(ref[f"train/{name}/loss"]))
            <= LOSS_RTOL * abs(float(ref[f"train/{name}/loss"])),
            f"port {float(port[f'train/{name}/loss'])!r} reference "
            f"{float(ref[f'train/{name}/loss'])!r}")
        prefix = f"train/{name}/param/"
        keys = sorted(k for k in ref.files if k.startswith(prefix))
        missing = [k for k in keys if k not in port.files]
        errs = np.concatenate([np.abs(port[k].astype(np.float64)
                                      - ref[k]).ravel() for k in keys
                               if k not in missing])
        out[f"train/{name}/params"] = (
            not missing and errs.max() <= PARAM_ATOL
            and (errs > 1e-6).mean() <= LOOSE_SHARE,
            f"missing {missing[:3]}, max err {errs.max():.3g}, share beyond "
            f"1e-6 {(errs > 1e-6).mean():.3g}")
        out[f"bytes/{name}/train"] = (flags[f"bytes/{name}/train"],
                                      str(port[f"train/{name}/bytes"]))
    if key in WIRE_DENSE:
        got = json.loads(str(port["wire/prefill"]))
        out["wire/gemma2-27b/prefill"] = _dense_wire(key, got)
    for name in LONG_MODELS.get(key, ()):
        pre = f"long/{name}/"
        want = ref[pre + "tokens"]
        eq = (np.array_equal(port[pre + "tokens"], want)
              and np.array_equal(port[pre + "forward_tokens"], want))
        out[pre + "tokens"] = (eq, f"port {port[pre + 'tokens']} forwards "
                               f"{port[pre + 'forward_tokens']} reference "
                               f"{want}")
        out[pre + "logits"] = _close(port[pre + "logits"], ref[pre + "logits"],
                                     LONG_TOL.get(name, LOGIT_TOL))
        keys = sorted(k for k in ref.files if k.startswith(pre + "cache/"))
        missing = [k for k in keys if k not in port.files]
        worst = max((float(np.max(np.abs(port[k] - ref[k]))) for k in keys
                     if k not in missing), default=np.inf)
        out[pre + "caches"] = (bool(keys) and not missing
                               and worst <= LOGIT_TOL,
                               f"missing {missing[:3]}, max abs err {worst}")
        out[pre + "bytes"] = (flags[pre + "bytes"], str(port[pre + "bytes"]))
        out[pre + "wire"] = (flags[pre + "wire"], str(port[pre + "wire"]))
    if key in LONG_MODELS:
        keys = sorted(k for k in ref.files if k.startswith("synthetic/"))
        bad = [k for k in keys if k not in port.files
               or not np.array_equal(port[k], ref[k])]
        out["synthetic/shards"] = (bool(keys) and not bad,
                                   f"{len(keys)} shards, differing {bad}")
    return out


def _counted(flags, port, name, kind):
    """A ``counted/*`` check: every rank's count equal to its live run's
    wire bytes, with each rank's (count, live) pair as the detail."""
    pre = f"counted/{name}/{kind}/rank"
    detail = {k[len(pre):]: json.loads(str(port[k])) for k in port.files
              if k.startswith(pre)}
    return flags[f"counted/{name}/{kind}"], f"(count, live) by rank {detail}"


def placed_differently(key, name):
    """The products rank 0 of the port runs beyond one partition of the
    reference's compiled prefill (``{what: FLOPs}``), by closed form:

    * padded heads on replicated projections (MiniCPM-pad, 3 q and 3 kv
      heads on a model axis of 2): each port rank projects every real
      head's q, k and v (``T d hd`` multiply-adds a head) and keeps its
      block of the padded heads, where GSPMD pads the weights and projects
      the rank's ``H_pad / n`` heads;
    * Mamba's B and C projections (``w_B``, ``w_C`` ``[d, N]``, stored over
      ``data``) at a data and a model axis both above 1: GSPMD splits each
      product over the model axis, where each port rank gathers the weight
      and projects whole, ``2 x 2 T d N (1 - 1/n)`` a Mamba layer.

    ``T`` is the rank's prompt tokens."""
    import repro_torch.configs as tconfigs
    from repro_torch.models.attention import padded_head_counts
    from repro_torch.models.config import MAMBA

    cfg = configs(name, tconfigs)
    names, sizes, _ = LAYOUTS[key]
    shape = dict(zip(names, sizes))
    n = shape["model"]
    t = BATCH // (math.prod(sizes) // n) * PROMPT
    d, specs = cfg.d_model, cfg.layer_specs()
    out = {}
    if n > 1 and cfg.num_heads and cfg.num_heads % n:
        hq_pad, kv_pad = padded_head_counts(cfg.num_heads, cfg.num_kv_heads,
                                            n)
        kv = cfg.num_kv_heads if cfg.num_kv_heads % n else kv_pad // n
        heads = (cfg.num_heads - hq_pad // n) + 2 * (kv - kv_pad // n)
        out["padded heads' q, k, v projected whole"] = 2 * t * d \
            * cfg.head_dim_ * heads * sum(s.mixer != MAMBA for s in specs)
    if n > 1 and shape["data"] > 1 and cfg.ssm is not None:
        out["Mamba's B and C projections whole on each model rank"] = \
            2 * 2 * t * d * cfg.ssm.d_state * (n - 1) / n \
            * sum(s.mixer == MAMBA for s in specs)
    return out


def _products(port, ref, key, name):
    """An ``hlo/*`` check: rank 0's product FLOPs of the prefill step on
    the counting mesh equal one partition's ``dot_flops`` in the
    reference's compiled HLO plus the products the two place differently
    (:func:`placed_differently`) within ``FLOP_RTOL``; both packages'
    collective bytes by family in the detail."""
    got = json.loads(str(port[f"{name}/products_rank0"]))
    want = json.loads(str(ref[f"{name}/hlo"]))
    extra = placed_differently(key, name)
    rel = abs(got["dot_flops"] - want["dot_flops"] - sum(extra.values())) \
        / max(want["dot_flops"], 1.0)
    return rel <= FLOP_RTOL, (
        f"port rank 0 {got['dot_flops']!r}, reference partition "
        f"{want['dot_flops']!r} of {want['num_partitions']}, placed "
        f"differently {extra} (rel {rel:.3g}); collective bytes port "
        f"{got['collective_breakdown']} reference "
        f"{want['collective_breakdown']}")


def _dense_wire(key, got):
    """The closed form of reduced Gemma2's prefill and serve steps at
    ``key``: per step one all-reduce of the embeddings, and per layer two
    (the attention's and the MLP's row-parallel outputs), each of ``[B_l,
    S, d]`` float32; one all-gather of the argmax's ``[n, B_l, 2]``
    float64 candidates."""
    import repro.configs as jconfigs

    cfg = configs("gemma2-27b", jconfigs)
    names, sizes, _ = LAYOUTS[key]
    shape = dict(zip(names, sizes))
    tp, b_l, d = shape["model"], BATCH // shape["data"], cfg.d_model
    reduce_rows = b_l * PROMPT + STEPS * b_l       # prefill, then 1 a step
    n_reduce = 1 + 2 * cfg.num_layers
    want = {"all_reduce": n_reduce * 2 * reduce_rows * d * 4 * (tp - 1) / tp,
            "all_gather": (1 + STEPS) * tp * b_l * 2 * 8 * (tp - 1) / tp,
            "reduce_scatter": 0.0, "all_to_all": 0.0}
    return got == want, f"counted {got}, closed form {want}"


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(sys.argv[2], sys.argv[3])
    else:
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
