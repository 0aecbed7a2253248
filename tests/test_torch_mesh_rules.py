"""The sharding rules' own behaviour, in one process (the multi-rank runs
are ``test_torch_mesh_*.py``).

* Without active rules ``constrain`` and ``gather_params_for_compute``
  return their input itself, and the steps built with ``rules=None`` are
  the one-card steps.
* ``_resolve`` maps ``batch`` and ``tp`` as the reference's does, on rules
  with and without the pod axis and with TP off.
* Axes whose mesh size does not divide a dimension are dropped, as the
  reference's ``constrain`` drops them.
* ``make_param_rule(..., fsdp_override=None)``, the compute-time specs of
  ZeRO's gather, equals the reference's for every leaf of every
  architecture on the production meshes, with and without ``moe_a2a``.
* Every configuration's ranks read their kv heads as one block in equal
  shares on model axes of 2, 4 and 16, which decode takes as a view.
* ``live_mesh`` refuses a world size other than the layout's, and a
  one-rank mesh runs every collective as the identity, counting no wire
  bytes.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.launch import sharding as jsharding
import repro_torch.configs as tconfigs
from repro_torch.interop import reference_param_paths
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import transformer as TT
from repro_torch.models.config import PREFILL_32K

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _rules_pair(tag, **over):
    """(the reference's rules on an AbstractMesh, the port's on the
    layout) with the same fields."""
    sizes, names = MESHES[tag]
    jr = jsharding.ShardingRules(mesh=AbstractMesh(sizes, names),
                                 dp_axes=mesh_lib.dp_axes(
                                     mesh_lib.MeshLayout(names, sizes)),
                                 **over)
    tr = sh.ShardingRules(mesh=mesh_lib.MeshLayout(names, sizes),
                          dp_axes=jr.dp_axes, **over)
    return jr, tr


def test_no_rules_returns_the_input_itself():
    x = torch.ones(2, 3, 4)
    assert sh.active_rules() is None
    assert sh.constrain(x, "batch", None, "tp") is x
    assert sh.constrain(x, "batch", None, None, partial="tp") is x
    model = TT.init_params(tconfigs.get("minicpm-2b").reduced(), 0,
                           device="cpu")
    layer = model.layers[0]
    assert sh.gather_params_for_compute(layer) is layer
    assert sh.gathered(layer.mixer.wq) is layer.mixer.wq
    with sh.use_rules(None):
        assert sh.constrain(x, "tp") is x


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("over", [{}, {"tp_enabled": False}])
def test_resolve_matches_reference(tag, over):
    jr, tr = _rules_pair(tag, **over)
    for axes in [("batch", None, "tp"), ("tp", None), (None,),
                 ("batch", None, "tp", None), ("data", ("pod", "data")
                                               if tag == "pod2" else "data")]:
        assert sh._resolve(tr, axes) == tuple(jsharding._resolve(jr, axes))


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_axes_that_do_not_divide_are_dropped(tag):
    _, tr = _rules_pair(tag)
    dp = tr.dp
    cases = [((32, 7, 8), ("batch", None, "tp"), (dp, None, None)),
             ((16, 5, 16), ("batch", None, "tp"),
              (dp if tag == "pod1" else None, None, "model")),
             ((64, 3), ("batch",), (dp, None)),
             ((3, 48, 2), (None, "tp", "batch"), (None, "model", None))]
    for shape, axes, want in cases:
        assert sh._fixed(tr, shape, sh._resolve(tr, axes)) == want, \
            (shape, axes)


def _compute_specs_equal(tag, name, **over):
    jr, tr = _rules_pair(tag, fsdp_axis="data", **over)
    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    jrule = jsharding.make_param_rule(jcfg, jr, fsdp_override=None)
    trule = sh.make_param_rule(tcfg, tr, fsdp_override=None)
    model = TT.Transformer(tcfg, device="meta")
    for pname, (path, stacked) in reference_param_paths(model, tcfg).items():
        shape = tuple(model.get_parameter(pname).shape)
        want = jrule(path, shape)
        want = tuple(want) + (None,) * (len(shape) - len(want))
        assert trule(path, shape) == want, (name, path)
        # storage specs keep the fsdp axis where the compute spec has none
        store = sh.make_param_rule(tcfg, tr)(path, shape)
        assert all(s == c or c is None for s, c in zip(store, want)), path


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("moe_a2a", [False, True])
def test_compute_specs_match_reference(tag, moe_a2a):
    for name in jconfigs.names():
        _compute_specs_equal(tag, name, moe_a2a=moe_a2a)


@pytest.mark.parametrize("n", [2, 4, 16])
def test_kv_heads_a_rank_reads_are_a_block(n):
    """On a model axis of ``n`` that divides the padded q heads, every
    rank's q heads read a block of kv heads in equal shares, for every
    configuration, so a replicated cache (kv heads that do not divide
    ``n``, or ``shard_kv_heads=False``) is read as a view, with no copy a
    decode step (``attention.kv_block``)."""
    from repro_torch.models.attention import kv_block, padded_head_counts

    replicated = 0
    for name in tconfigs.names():
        cfg = tconfigs.get(name)
        if not cfg.num_heads or not cfg.num_kv_heads:
            continue
        hq_pad, kv_pad = padded_head_counts(cfg.num_heads, cfg.num_kv_heads,
                                            n)
        if hq_pad % n:
            continue
        hq = hq_pad // n
        for r in range(n):
            block = kv_block(r * hq, hq, hq_pad // kv_pad)
            assert block is not None, (name, n, r)
            assert 0 <= block[0] and sum(block) <= kv_pad
        replicated += kv_pad % n != 0
    assert replicated     # some configuration replicates its kv heads


def test_steps_without_rules_are_the_one_card_steps():
    cfg = tconfigs.get("mamba2-780m").reduced()
    model = TT.init_params(cfg, 1, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(2))
    a = TT.init_caches(cfg, 2, 12, device="cpu")
    b = TT.init_caches(cfg, 2, 12, device="cpu")
    ta, a = steps.build_prefill_step(cfg)(model, a, {"tokens": toks})
    tb, b = steps.build_prefill_step(cfg, None)(model, b, {"tokens": toks})
    assert torch.equal(ta, tb)
    logits, _ = TT.prefill_forward(model, {"tokens": toks}, cfg,
                                   TT.init_caches(cfg, 2, 12, device="cpu"))
    assert torch.equal(ta, steps.next_token(logits, cfg.padded_vocab))
    assert torch.equal(ta, steps.next_token(logits))


def _one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def test_live_mesh_sizes_and_one_rank_collectives():
    _one_rank_group()
    try:
        with pytest.raises(ValueError, match="1 ranks for a layout of 2"):
            mesh_lib.live_mesh(mesh_lib.MeshLayout(("data", "model"),
                                                   (2, 1)), "cpu")
        layout = mesh_lib.MeshLayout(("data", "model"), (1, 1))
        live = mesh_lib.live_mesh(layout, "cpu")
        assert live.coords == {"data": 0, "model": 0}
        assert live.size(("data", "model")) == 1
        assert live.group("data") is None
        mesh_lib.reset_wire_bytes()
        x = torch.arange(6.0).reshape(2, 3)
        for op in (lambda t: mesh_lib.all_reduce(t, live, "data"),
                   lambda t: mesh_lib.reduce_out(t, live, "model"),
                   lambda t: mesh_lib.copy_in(t, live, "model"),
                   lambda t: mesh_lib.all_gather(t, live, "data", 0),
                   lambda t: mesh_lib.reduce_scatter(t, live, "data", 1),
                   lambda t: mesh_lib.all_to_all(t, live, "data")):
            assert op(x) is x
        assert mesh_lib.wire_bytes() == dict.fromkeys(mesh_lib.FAMILIES, 0.0)
        with pytest.raises(ValueError, match="mesh's order"):
            live.names(("model", "data"))
        # a one-rank cell: its rules run, every leaf whole
        cfg = tconfigs.get("deepseek-moe-16b").reduced()
        shape = dataclasses.replace(PREFILL_32K, seq_len=10, global_batch=2)
        cell = steps.build_cell(cfg, shape, layout, device="cpu", mesh=live,
                                zero1=True)
        assert cell.rules.live is live and cell.rules.zero1
        full = TT.init_params(cfg, 3, device="cpu")
        params = sh.distribute_params(full, cell.pspecs["params"],
                                      cell.rules)
        for p, f in zip(params.parameters(), full.parameters()):
            assert torch.equal(p, f) and p.data_ptr() != f.data_ptr()
        toks = torch.randint(0, cfg.vocab_size, (2, 10),
                             generator=torch.Generator().manual_seed(4))
        caches = steps.local_zeros(cell.specs["caches"],
                                   cell.pspecs["caches"], cell.rules, "cpu")
        got, _ = cell.step(params, caches, {"tokens": toks})
        want, _ = steps.build_prefill_step(cfg)(
            full, TT.init_caches(cfg, 2, 10, device="cpu"),
            {"tokens": toks})
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def test_wire_byte_formulas():
    """The ring formulas of the reference's hlo_analysis, per family."""
    mesh_lib.reset_wire_bytes()
    mesh_lib._count("all_reduce", 1000, 4)
    mesh_lib._count("all_gather", 1000, 4)
    mesh_lib._count("reduce_scatter", 1000, 2)
    mesh_lib._count("all_to_all", 1000, 4)
    assert mesh_lib.wire_bytes() == {"all_reduce": 1500.0,
                                     "all_gather": 750.0,
                                     "reduce_scatter": 500.0,
                                     "all_to_all": 750.0}
    mesh_lib.reset_wire_bytes()


def test_placements_of_specs():
    """The DTensor placements the multi-rank tests hold the local shards
    to (``_torch_mesh_parity.placements``)."""
    from torch.distributed.tensor import Replicate, Shard

    from _torch_mesh_parity import placements

    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")

    got = placements((("pod", "data"), None, "model"), FakeMesh())
    assert got == (Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), FakeMesh()) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("data", "pod"),), FakeMesh())
    with pytest.raises(ValueError, match="shards two"):
        placements(("data", "data"), FakeMesh())
