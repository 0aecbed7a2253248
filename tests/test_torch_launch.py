"""The port's ``launch/`` rules half against the JAX package, on the CPU.

* Shapes and knobs: ``ShapeConfig``, ``ALL_SHAPES``, ``shape_applicable``
  and ``knobs_for`` field for field, every name x shape; the TP head
  padding over a grid; the mesh layouts.
* Spec parity: on the production meshes ``(16, 16)`` and ``(2, 16, 16)``
  (the reference's rules built on ``jax.sharding.AbstractMesh``, no
  devices), every cell ``shape_applicable`` admits: each leaf of the port's
  ``model_specs``, ``opt_specs``, ``batch_specs``, ``cache_specs`` and
  ``cache_pspecs``, keyed by the reference's path, has the reference's
  shape, dtype and spec exactly (a stacked reference leaf is the port's
  layers with a leading unit axis replicated; a KV leaf's dims and spec in
  ``KV_REFERENCE_DIMS`` order), and every reference leaf is covered.
* Byte parity: each cell's per-chip argument bytes (the dry-run's) equal
  those of the reference's spec trees, and ``build_cell``'s ``meta`` the
  reference's.
* Step parity: ``build_prefill_step`` then 3 ``build_serve_step`` steps
  on the CPU against the reference's (jitted, rules of a one-device host
  mesh) on reduced MiniCPM-2B, PaliGemma-3B (prefix embeddings) and
  SeamlessM4T (source frames, then ``enc_out``), weights carried by
  ``params_from_reference``: tokens equal, caches within 1e-4.
* Dry-run: reduced cells (dense, MoE, Mamba-2, each kind of shape) on
  ``meta`` write ``ok`` records; a reduced prefill cell's product FLOPs
  equal the reference's ``hlo_analysis`` ``dot_flops`` of the same cell
  lowered on one CPU device (see ``test_prefill_product_flops_match``).
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import hlo_analysis
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import config as jconfig
from repro.models import transformer as JT
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference, reference_param_paths
from repro_torch.launch import dryrun, mesh, steps
from repro_torch.launch.cells import knobs_for
from repro_torch.models import attention as tattn
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as TT

NAMES = jconfigs.names()
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
#: float32 reduced models, as the other parity tests hold them
CACHE_TOL = 1e-4


def _shape_pairs():
    return [(js, ts) for js, ts in zip(jconfig.ALL_SHAPES,
                                       tconfig.ALL_SHAPES)]


def _jstr(dtype) -> str:
    return str(jnp.dtype(dtype))


def _tstr(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def _flat(tree, is_leaf=None):
    return {_path(kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _specs(tree):
    return _flat(tree, is_leaf=lambda s: isinstance(s, jax.sharding
                                                    .PartitionSpec))


def _spec_of(specs, path):
    """The spec of the leaf at ``path``: its own, or that of the subtree
    holding it (a KV cache's one spec covers ``k`` and ``v``)."""
    while path not in specs:
        assert "/" in path, path
        path = path.rsplit("/", 1)[0]
    return specs[path]


# ---------------------------------------------------------------------------
# shapes, knobs, head padding, layouts
# ---------------------------------------------------------------------------

def test_shapes_equal_reference():
    assert [dataclasses.asdict(s) for s in tconfig.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.ALL_SHAPES]
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(tconfig, name)) == \
            dataclasses.asdict(getattr(jconfig, name))


@pytest.mark.parametrize("name", NAMES)
def test_applicable_and_knobs_equal_reference(name):
    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    assert tcfg.is_subquadratic == jcfg.is_subquadratic
    for js, ts in _shape_pairs():
        assert tconfig.shape_applicable(tcfg, ts) == \
            jconfig.shape_applicable(jcfg, js)
        assert dataclasses.asdict(knobs_for(tcfg, ts)) == \
            dataclasses.asdict(jcells.knobs_for(jcfg, js))
        assert dataclasses.asdict(knobs_for(tcfg, ts, zero1=True,
                                            microbatches=3)) == \
            dataclasses.asdict(jcells.knobs_for(jcfg, js, zero1=True,
                                                microbatches=3))


def test_padded_head_counts_equal_reference():
    for hq in (0, 1, 4, 8, 12, 24, 32, 36, 40, 56, 64):
        for g in (1, 2, 4, 8, 12):
            if hq and hq % g:
                continue
            for tp in (1, 2, 4, 8, 16):
                kv = hq // g if hq else 0
                if hq == 0:
                    kv = 1
                assert tattn.padded_head_counts(hq, kv, tp) == \
                    jattn.padded_head_counts(hq, kv, tp), (hq, kv, tp)


def test_mesh_layouts():
    for multi, (sizes, names) in ((False, MESHES["pod1"]),
                                  (True, MESHES["pod2"])):
        layout = mesh.make_production_mesh(multi_pod=multi)
        assert (layout.sizes, layout.axis_names) == (sizes, names)
        assert layout.size == math.prod(sizes)
        amesh = AbstractMesh(sizes, names)
        assert mesh.dp_axes(layout) == jmesh.dp_axes(amesh)
    host = mesh.make_host_mesh()
    assert (host.axis_names, host.sizes) == (("data", "model"), (1, 1))
    with pytest.raises(ValueError):
        mesh.make_host_mesh(tp=2)
    with pytest.raises(ValueError):
        mesh.MeshLayout(("data",), (0,))
    rules = steps.make_rules(host, tconfigs.get("minicpm-2b"),
                             knobs_for(tconfigs.get("minicpm-2b"),
                                       tconfig.TRAIN_4K))
    assert (rules.dp, rules.tp_size(), rules.dp_size()) == ("data", 1, 1)
    pod2 = steps.make_rules(mesh.make_production_mesh(multi_pod=True),
                            tconfigs.get("minicpm-2b"),
                            knobs_for(tconfigs.get("minicpm-2b"),
                                      tconfig.PREFILL_32K))
    jcfg = jconfigs.get("minicpm-2b")
    jrules = jsteps.make_rules(AbstractMesh(*MESHES["pod2"]), jcfg,
                               jcells.knobs_for(jcfg, jconfig.PREFILL_32K))
    assert (pod2.dp, pod2.tp_size(), pod2.dp_size()) == (
        jrules.dp, jrules.tp_size(), jrules.dp_size()) == (("pod", "data"),
                                                          16, 32)
    assert all(getattr(pod2, f) == getattr(jrules, f) for f in (
        "dp_axes", "tp_axis", "tp_enabled", "fsdp_axis", "shard_kv_heads",
        "moe_a2a", "zero1"))
    assert pod2.axis_size(("data", "model")) == 256
    assert pod2.divisible(64, "model") and not pod2.divisible(40, "model")
    assert not pod2.divisible(64, None)


# ---------------------------------------------------------------------------
# spec and byte parity on the production meshes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_params(name):
    """The reference's parameter shapes (``jax.eval_shape``)."""
    return jax.eval_shape(functools.partial(
        JT.init_params, jconfigs.get(name)), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _reference_cell(name, shape_name, mesh_tag):
    """The reference's knobs, rules and spec trees of a cell, flattened:
    ``{group: {path: (shape, dtype name, spec)}}`` and the mesh sizes."""
    sizes, axes = MESHES[mesh_tag]
    amesh = AbstractMesh(sizes, axes)
    jcfg = jconfigs.get(name)
    shape = next(s for s in jconfig.ALL_SHAPES if s.name == shape_name)
    knobs = jcells.knobs_for(jcfg, shape)
    rules = jsteps.make_rules(amesh, jcfg, knobs)
    # jsteps.model_specs, its shapes traced once per architecture
    params = _reference_params(name)
    params_ps = jsharding.param_pspecs(jcfg, params, rules)
    groups = {"params": (params, params_ps),
              "batch": jsteps.batch_specs(jcfg, shape, rules, knobs)}
    if shape.kind == "train":
        groups["opt_state"] = jsteps.opt_specs(params, params_ps)
    else:
        groups["caches"] = (
            jsteps.cache_specs(jcfg, shape, tp=rules.tp_size()),
            jsteps.cache_pspecs(jcfg, shape, rules))
    out = {}
    for group, (tree, ps) in groups.items():
        leaves, specs = _flat(tree), _specs(ps)
        out[group] = {p: (tuple(leaf.shape), _jstr(leaf.dtype),
                          tuple(_spec_of(specs, p)))
                      for p, leaf in leaves.items()}
    return out, dataclasses.asdict(knobs), dict(amesh.shape)


def _port_leaves(cell, cfg):
    """The port's leaves of a cell keyed by the reference's paths:
    ``{group: {path: [(shape, dtype name, spec, stacked)]}}``."""
    out = {}
    params, params_ps = cell.specs["params"], cell.pspecs["params"]
    paths = reference_param_paths(params, cfg)

    def by_name(tensors, ps, prefix=""):
        group = {}
        for name, t in tensors.items():
            path, stacked = paths[name]
            group.setdefault(prefix + path, []).append(
                (tuple(t.shape), _tstr(t.dtype), ps[name], stacked))
        return group

    out["params"] = by_name(dict(params.named_parameters()), params_ps)
    out["batch"] = {k: [(tuple(t.shape), _tstr(t.dtype),
                         cell.pspecs["batch"][k], False)]
                    for k, t in cell.specs["batch"].items()}
    if "opt_state" in cell.specs:
        opt, opt_ps = cell.specs["opt_state"], cell.pspecs["opt_state"]
        out["opt_state"] = {**by_name(opt["m"], opt_ps["m"], "m/"),
                            **by_name(opt["v"], opt_ps["v"], "v/"),
                            "step": [((), _tstr(opt["step"].dtype),
                                      opt_ps["step"], False)]}
    else:
        group = {}
        for (path, stacked), cache, ps in zip(
                steps.cache_reference_paths(cfg), cell.specs["caches"],
                cell.pspecs["caches"]):
            for leaf, t in cache.items():
                shape, spec = tuple(t.shape), ps[leaf]
                if leaf in ("k", "v"):  # back to the reference's dim order
                    inv = [steps.KV_REFERENCE_DIMS.index(d)
                           for d in range(4)]
                    shape = tuple(shape[i] for i in inv)
                    spec = tuple(spec[i] for i in inv)
                group.setdefault(f"{path}/{leaf}", []).append(
                    (shape, _tstr(t.dtype), spec, stacked))
        out["caches"] = group
    return out


def _admitted(name):
    tcfg = tconfigs.get(name)
    return [s for s in tconfig.ALL_SHAPES
            if tconfig.shape_applicable(tcfg, s)[0]]


CELLS = [(tag, name) for tag in MESHES for name in NAMES]


@pytest.mark.parametrize("tag,name", CELLS)
def test_specs_equal_reference(tag, name):
    tcfg = tconfigs.get(name)
    layout = mesh.MeshLayout(MESHES[tag][1], MESHES[tag][0])
    for shape in _admitted(name):
        ref, _, _ = _reference_cell(name, shape.name, tag)
        cell = steps.build_cell(tcfg, shape, layout, device="meta")
        port = _port_leaves(cell, tcfg)
        assert port.keys() == ref.keys()
        for group, leaves in ref.items():
            assert port[group].keys() == leaves.keys(), (shape.name, group)
            for path, (rshape, rdtype, rspec) in leaves.items():
                entries = port[group][path]
                stacked = entries[0][3]
                where = (shape.name, group, path)
                if stacked:
                    assert len(entries) == rshape[0], where
                    assert rspec[:1] in ((None,), ()), where
                    rshape, rspec = rshape[1:], rspec[1:]
                else:
                    assert len(entries) == 1, where
                for pshape, pdtype, pspec, _ in entries:
                    assert pshape == rshape, where
                    assert pdtype == rdtype, where
                    # a reference spec may leave trailing dims out
                    assert pspec[:len(rspec)] == rspec, where
                    assert all(a is None for a in pspec[len(rspec):]), where


def _reference_bytes(ref, sizes):
    def divisor(spec):
        n = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n *= sizes[a]
        return n

    return {group: sum(math.prod(shape) * jnp.dtype(dtype).itemsize
                       // divisor(spec)
                       for shape, dtype, spec in leaves.values())
            for group, leaves in ref.items()}


@pytest.mark.parametrize("tag,name", CELLS)
def test_bytes_and_meta_equal_reference(tag, name):
    tcfg = tconfigs.get(name)
    layout = mesh.MeshLayout(MESHES[tag][1], MESHES[tag][0])
    for shape in _admitted(name):
        ref, knobs, sizes = _reference_cell(name, shape.name, tag)
        cell = steps.build_cell(tcfg, shape, layout, device="meta")
        got = dryrun.cell_bytes(cell, layout)
        want = _reference_bytes(ref, sizes)
        assert {k: v for k, v in got.items() if k != "total"} == want, \
            shape.name
        assert got["total"] == sum(want.values())
        assert cell.meta == {"arch": tcfg.name, "shape": shape.name,
                             "mesh": sizes, "knobs": knobs}


# ---------------------------------------------------------------------------
# step parity on the CPU
# ---------------------------------------------------------------------------

PROMPT = 12
DECODE_STEPS = 3


def _host_rules(jcfg, shape):
    amesh = jmesh.make_host_mesh()
    return jsteps.make_rules(amesh, jcfg, jcells.knobs_for(jcfg, shape))


def _kv_to_reference(t):
    return t.permute(*[steps.KV_REFERENCE_DIMS.index(d)
                       for d in range(4)])


def _assert_caches_close(tcaches, jcaches, tcfg):
    flat = _flat(jcaches)
    n_pre, unit = len(tcfg.prefix), len(tcfg.unit)
    for j, ((path, stacked), cache) in enumerate(zip(
            steps.cache_reference_paths(tcfg), tcaches)):
        for leaf, t in cache.items():
            want = np.asarray(flat[f"{path}/{leaf}"], np.float32)
            if stacked:
                want = want[(j - n_pre) // unit]
            got = _kv_to_reference(t) if leaf in ("k", "v") else t
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=CACHE_TOL, atol=CACHE_TOL,
                                       err_msg=f"{path}/{leaf}")


@pytest.mark.parametrize("name", ["minicpm-2b", "paligemma-3b",
                                  "seamless-m4t-medium"])
def test_prefill_and_serve_steps_match_reference(name):
    jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(3)))
    model = params_from_reference(tree, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    b, p = 2, tcfg.num_prefix_embeds
    fd = tcfg.frontend_dim or tcfg.d_model
    s_max = p + PROMPT + DECODE_STEPS
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (b, PROMPT),
                                    dtype=np.int32)}
    if p:
        batch["prefix_embeds"] = rng.standard_normal((b, p, fd),
                                                     dtype=np.float32)
    if tcfg.encoder_layers:
        batch["src_embeds"] = rng.standard_normal((b, 7, fd),
                                                  dtype=np.float32)

    jprefill = jax.jit(jsteps.build_prefill_step(
        jcfg, _host_rules(jcfg, jconfig.PREFILL_32K)))
    jserve = jax.jit(jsteps.build_serve_step(
        jcfg, _host_rules(jcfg, jconfig.DECODE_32K)))
    jcaches = JT.init_caches(jcfg, b, s_max)
    jtok, jcaches = jprefill(tree, jcaches, batch)
    tcaches = TT.init_caches(tcfg, b, s_max, device="cpu")
    ttok, tcaches = steps.build_prefill_step(tcfg)(
        model, tcaches, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches_close(tcaches, jcaches, tcfg)

    enc = None
    if tcfg.encoder_layers:
        enc = np.asarray(JT._encode(tree, batch["src_embeds"], jcfg),
                         np.float32)
    serve = steps.build_serve_step(tcfg)
    for i in range(DECODE_STEPS):
        index = p + PROMPT + i
        dec = {"tokens": np.asarray(jtok, np.int32)[:, None],
               "index": np.int32(index)}
        if enc is not None:
            dec["enc_out"] = enc
        jtok, jcaches = jserve(tree, jcaches, dec)
        tdec = {k: torch.as_tensor(np.array(v)) for k, v in dec.items()}
        ttok, tcaches = serve(model, tcaches, tdec)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches_close(tcaches, jcaches, tcfg)


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

SMALL = {"train": tconfig.ShapeConfig("train_small", 32, 4, "train"),
         "prefill": tconfig.ShapeConfig("prefill_small", 32, 2, "prefill"),
         "decode": tconfig.ShapeConfig("decode_small", 32, 4, "decode")}


@pytest.mark.parametrize("name", ["minicpm-2b", "deepseek-moe-16b",
                                  "mamba2-780m", "seamless-m4t-medium"])
def test_dryrun_reduced_cells_write_ok_records(name, tmp_path):
    cfg = tconfigs.get(name).reduced()
    counted = {}
    for kind, shape in SMALL.items():
        for tag, layout in (("host", mesh.make_host_mesh()),
                            ("pod1", mesh.make_production_mesh())):
            rec = dryrun.run_cell(cfg, shape, layout, str(tmp_path), tag,
                                  counted=counted,
                                  microbatches=2 if kind == "train" else 1)
            assert rec["status"] == "ok", rec.get("traceback")
            on_disk = json.loads((tmp_path / f"{cfg.name}_{shape.name}_"
                                  f"{tag}.json").read_text())
            assert on_disk["status"] == "ok"
            flops = rec["flops"]
            assert flops["per_step"] >= flops["products_per_step"] > 0
            assert flops["per_chip"] == flops["per_step"] / layout.size
            assert ("flops_counted_for" in rec) == (tag == "pod1")
            assert rec["bytes_per_chip"]["total"] > 0
            assert rec["model_flops"] == pytest.approx(
                dryrun.model_flops(cfg, shape))


def test_dryrun_cli_skips_and_errors(tmp_path, capsys):
    rc = dryrun.main(["--arch", "minicpm-2b", "--shape", "long_500k",
                      "--both-meshes", "--out", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert [r["tag"] for r in recs] == ["pod1", "pod2"]
    assert all(r["status"] == "skip" and r["reason"] == jconfig
               .shape_applicable(jconfigs.get("minicpm-2b"),
                                 jconfig.LONG_500K)[1] for r in recs)
    # a knob the cell cannot take is an error record and exit code 1
    rc = dryrun.main(["--arch", "minicpm-2b", "--shape", "train_4k",
                      "--knob", "microbatches=3", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "minicpm-2b_train_4k_pod1.json")
                     .read_text())
    assert rec["status"] == "error" and "microbatches" in rec["error"]
    assert "FAIL" in capsys.readouterr().out


#: the port counts the products of the step as it runs them; the
#: reference's HLO of the same reduced prefill (prompt 64 <= 256, so its
#: attention is the materializing ``attend_naive``) holds the same
#: products: projections, every (query, key) pair's scores and values, the
#: MLPs and the last position's logits.  Equal up to XLA folding a product
#: away, which these shapes do not give it room to do.
FLOP_RTOL = 1e-6


@pytest.mark.parametrize("name", ["minicpm-2b", "paligemma-3b"])
def test_prefill_product_flops_match_reference(name):
    jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    jshape = jconfig.ShapeConfig("prefill_small", 64, 2, "prefill")
    lowered, _ = jsteps.lower_cell(jcfg, jshape, jmesh.make_host_mesh())
    want = hlo_analysis.analyze(lowered.compile().as_text()).dot_flops
    tshape = tconfig.ShapeConfig("prefill_small", 64, 2, "prefill")
    cell = steps.build_cell(tcfg, tshape, mesh.make_host_mesh(),
                            device="meta")
    got = dryrun.count_flops(cell, tcfg, tshape)["products"]
    assert got == pytest.approx(want, rel=FLOP_RTOL)
