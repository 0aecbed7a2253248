"""The port's training step, fault-tolerant loop and training checkpoints
against the JAX package, on the CPU.

* ``build_train_step`` + ``TrainLoop`` on reduced paper-synthetic, as the
  reference's ``tests/test_substrates.py`` sets it up (2 microbatches of 4
  rows, constant schedule at 3e-3): 3 steps from the same parameters and
  stream give the reference's losses to 1e-5 relative and its parameters
  within ``PARAM_ATOL`` (a tenth of the learning rate), all but
  ``LOOSE_SHARE`` of the elements within 1e-6.  Why that holds: AdamW
  divides each moment by ``sqrt(v)``, so an element whose gradient is near
  the float32 noise of the two frameworks' sums (a few ulps of the leaf's
  largest entries) moves by up to a learning rate either way, while every
  other element follows the gradient's sign and scale, which agree.  A
  failure before step 7 with checkpoints every 5 steps restarts from
  step 5 and ends bit-identical to the uninterrupted run; at each
  checkpoint the runtime's ``Autoscaler`` is consulted over the loop's
  ``MetricsBus``.
* Checkpoints: a bfloat16 leaf round-trips bit-exactly, written byte for
  byte as the reference writes it (descr ``'<V2'``, manifest dtype
  ``"bfloat16"``); the port reads a directory the reference's ``save``
  wrote with bfloat16 and float32 leaves bit for bit; the reference's
  ``restore`` reads the port's float32 training directory; and the
  reference's ``restore`` fails on its own bfloat16 leaves (pinned: the
  port reads that format anyway).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.data.pipeline import SyntheticLM as JData
from repro.ft.driver import TrainLoop as JTrainLoop
from repro.launch.cells import CellKnobs as JKnobs
from repro.launch.sharding import ShardingRules
from repro.launch.steps import build_train_step as jbuild
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft.driver import (BestTracker, InjectedFailure, TrainLoop,
                                   elastic_resize, state_template)
from repro_torch.interop import (opt_state_to_reference,
                                 params_from_reference, params_to_reference)
from repro_torch.launch.cells import CellKnobs, knobs_for
from repro_torch.launch.steps import build_train_step
from repro_torch.models.config import DECODE_32K, TRAIN_4K
from repro_torch.optim import adamw

PARAM_ATOL = 3e-4
LOOSE_SHARE = 1e-3
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=1000,
           schedule="constant")
NAME = "paper-synthetic"


def _data(cls, cfg, **kw):
    return cls(vocab=cfg.padded_vocab, seq_len=16, batch=4, microbatches=2,
               seed=0, **kw)


def _port_loop(ckpt_dir, fail_at=None, tree=None):
    cfg = tconfigs.get(NAME).reduced()
    if tree is None:
        tree = jax.tree.map(np.asarray, JT.init_params(
            jconfigs.get(NAME).reduced(), jax.random.PRNGKey(0)))
    model = params_from_reference(tree, cfg, device="cpu")
    step = build_train_step(cfg, CellKnobs(microbatches=2, remat=False),
                            adamw.AdamWConfig(**OPT))
    loop = TrainLoop(train_step=step, data=_data(SyntheticLM, cfg,
                                                 device="cpu"),
                     ckpt_dir=str(ckpt_dir), cfg=cfg, ckpt_every=5,
                     metric_flush_every=1, fail_at=fail_at)
    return loop, model, adamw.init_state(model)


def _recording(step, losses):
    """``step`` that appends each step's loss to ``losses``."""
    def run(*args):
        out = step(*args)
        losses.append(float(out[2]["loss"]))
        return out
    return run


def test_train_loop_matches_reference(tmp_path):
    cfg = jconfigs.get(NAME).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = ShardingRules(mesh=mesh, dp_axes=("data",), fsdp_axis=None)
    jstep = jax.jit(jbuild(cfg, rules, JKnobs(microbatches=2, remat=False,
                                               fsdp=False),
                           opt_cfg=jadamw.AdamWConfig(**OPT)))
    jlosses, tlosses = [], []
    jloop = JTrainLoop(train_step=_recording(jstep, jlosses),
                       data=_data(JData, cfg), ckpt_dir=str(tmp_path / "j"),
                       ckpt_every=5, metric_flush_every=1)
    jparams, _, _ = jloop.run(params, jadamw.init_state(params), 3,
                              log=lambda *_: None)
    loop, model, opt = _port_loop(tmp_path / "t",
                                  tree=jax.tree.map(np.asarray, params))
    loop.train_step = _recording(loop.train_step, tlosses)
    model, opt, best = loop.run(model, opt, 3, log=lambda *_: None)
    assert len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert best.best == min(tlosses)
    assert int(opt["step"]) == 3
    got = params_to_reference(model, loop.cfg)
    errs = np.concatenate([
        np.abs(np.asarray(a) - b).ravel() for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jparams),
            jax.tree_util.tree_leaves_with_path(got))])
    assert errs.max() <= PARAM_ATOL
    assert (errs > 1e-6).mean() <= LOOSE_SHARE


def test_restart_is_bit_exact(tmp_path):
    loop1, p1, o1 = _port_loop(tmp_path / "a")
    p1, o1, best1 = loop1.run(p1, o1, 12, log=lambda *_: None)
    logs = []
    loop2, p2, o2 = _port_loop(tmp_path / "b", fail_at=7)
    p2, o2, best2 = loop2.run(p2, o2, 12, log=logs.append)
    assert any("injected failure at step 7" in line for line in logs)
    assert any(line.startswith("[train] step 7 ") for line in logs)
    for a, b in zip(p1.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    for key in ("m", "v"):
        for name in o1[key]:
            assert torch.equal(o1[key][name], o2[key][name])
    assert int(o1["step"]) == int(o2["step"]) == 12
    # a new loop over the same directory resumes from the newest step
    loop3, p3, o3 = _port_loop(tmp_path / "b")
    logs = []
    p3, o3, _ = loop3.run(p3, o3, 12, log=logs.append)
    assert logs == ["[ft] restored step 10", "[train] step 11 loss "
                    + logs[1].split("loss ")[1], logs[2]]
    for a, b in zip(p1.parameters(), p3.parameters()):
        assert torch.equal(a, b)


def test_best_tracker_and_elastic_resize(tmp_path):
    t = BestTracker()
    assert t.propose(5.0, 1)
    assert not t.propose(6.0, 2)  # non-monotone proposal discarded (S4)
    assert t.propose(4.0, 3)
    assert (t.best, t.step) == (4.0, 3)
    loop, model, opt = _port_loop(tmp_path)
    with pytest.raises(FileNotFoundError, match="needs a checkpoint"):
        elastic_resize(str(tmp_path), state_template(model, loop.cfg))
    loop.run(model, opt, 5, log=lambda *_: None)
    (ptree, otree), meta = elastic_resize(
        str(tmp_path), state_template(model, loop.cfg), device="cpu")
    assert meta["stream"] == {"position": 5}
    np.testing.assert_array_equal(ptree["embed"]["table"],
                                  model.embed.detach().numpy())
    assert int(otree["step"]) == 5
    assert issubclass(InjectedFailure, RuntimeError)
    assert knobs_for(loop.cfg, TRAIN_4K).microbatches == 1
    assert knobs_for(tconfigs.get("minicpm-2b"), TRAIN_4K) == CellKnobs(
        microbatches=4, remat=True, grad_accum_dtype="float32")
    assert not knobs_for(loop.cfg, DECODE_32K).remat


# ---------------------------------------------------------------------------
# training checkpoints: bfloat16 leaves and the reference's directories
# ---------------------------------------------------------------------------

def _bf16_values(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 100).astype(ml_dtypes.bfloat16)


def test_bfloat16_round_trip_is_the_reference_format(tmp_path):
    vals = _bf16_values(24, 1).reshape(2, 3, 4)
    words = torch.from_numpy(vals.view(np.int16).copy())
    tree = {"w": words.view(torch.bfloat16), "x": torch.arange(5.0)}
    tckpt.save(str(tmp_path / "t"), 2, tree)
    jckpt.save(str(tmp_path / "j"), 2, {"w": jnp.asarray(vals),
                                        "x": jnp.arange(5.0)})
    for leaf in ("w", "x"):
        files = [open(tmp_path / d / "step_2" / f"{leaf}.npy", "rb").read()
                 for d in ("t", "j")]
        assert files[0] == files[1]
    buf = io.BytesIO()
    np.save(buf, vals)
    assert files and buf.getvalue() == open(
        tmp_path / "t" / "step_2" / "w.npy", "rb").read()
    assert b"'descr': '<V2'" in buf.getvalue()
    manifests = [json.load(open(tmp_path / d / "step_2" / "manifest.json"))
                 for d in ("t", "j")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["leaves"]["w"]["dtype"] == "bfloat16"
    back, _ = tckpt.restore(str(tmp_path / "t"), 2,
                            {"w": torch.empty(0, dtype=torch.bfloat16),
                             "x": torch.empty(0)})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), words)
    assert torch.equal(back["x"], tree["x"])


def test_port_reads_reference_bf16_and_f32_directory(tmp_path):
    vals = _bf16_values(30, 2).reshape(5, 6)
    f32 = np.random.default_rng(3).standard_normal(7).astype(np.float32)
    jckpt.save(str(tmp_path), 4, {"p": {"w": jnp.asarray(vals),
                                        "b": jnp.asarray(f32)},
                                  "step": jnp.int32(4)},
               metadata={"stream": {"position": 4}})
    template = {"p": {"w": torch.empty(0), "b": torch.empty(0)},
                "step": np.int32(0)}
    back, meta = tckpt.restore(str(tmp_path), 4, template)
    assert meta == {"stream": {"position": 4}}
    np.testing.assert_array_equal(back["p"]["w"].view(torch.int16).numpy(),
                                  vals.view(np.int16))
    assert back["p"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(back["p"]["b"].numpy(), f32)
    assert back["step"] == 4 and back["step"].dtype == np.int32
    # a non-tensor template leaf still gets a bfloat16 tensor
    loose, _ = tckpt.restore(str(tmp_path), 4, {
        "p": {"w": np.zeros(0), "b": np.zeros(0)}, "step": np.zeros(0)})
    assert loose["p"]["w"].dtype == torch.bfloat16
    assert isinstance(loose["p"]["b"], np.ndarray)


def test_reference_restores_port_float32_training_directory(tmp_path):
    loop, model, opt = _port_loop(tmp_path)
    model, opt, _ = loop.run(model, opt, 5, log=lambda *_: None)
    cfg = jconfigs.get(NAME).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    (jp, jo), meta = jckpt.restore(str(tmp_path), 5,
                                   (params, jadamw.init_state(params)))
    assert meta["stream"] == {"position": 5}
    want_p = params_to_reference(model, loop.cfg)
    want_o = opt_state_to_reference(opt, model, loop.cfg)
    for got, want in ((jp, want_p), (jo, want_o)):
        g = jax.tree_util.tree_leaves_with_path(got)
        w = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(g) == len(w)
        for path, leaf in g:
            np.testing.assert_array_equal(np.asarray(leaf), w[path])
    assert jo["step"].dtype == jnp.int32 and int(jo["step"]) == 5


def test_reference_cannot_restore_its_own_bf16_leaves(tmp_path):
    """The reference writes a bfloat16 leaf with ``np.save`` (descr
    ``'<V2'``) and its ``restore`` then fails at ``jnp.asarray`` of the
    ``V2`` array (ROADMAP Queue 3); the port reads the same file."""
    vals = _bf16_values(8, 4)
    jckpt.save(str(tmp_path), 1, {"w": jnp.asarray(vals)})
    with pytest.raises(TypeError, match="V2"):
        jckpt.restore(str(tmp_path), 1, {"w": jnp.zeros(8, jnp.bfloat16)})
    back, _ = tckpt.restore(str(tmp_path), 1, {"w": torch.empty(0)})
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy(),
                                  vals.view(np.int16))
    assert os.path.exists(tmp_path / "step_1" / "w.npy")


def test_autoscaler_is_consulted_at_checkpoints(tmp_path):
    """The elastic hook: every step is a record on the loop's MetricsBus,
    and at each checkpoint the runtime's Autoscaler is asked for a degree;
    an accepted one goes to ``on_resize`` and becomes the loop's degree."""
    from repro_torch.runtime.autoscaler import Autoscaler, Policy
    from repro_torch.runtime.metrics import MetricsBus

    class Grow(Policy):
        def target(self, bus, current, candidates, queue=None):
            return min((c for c in candidates if c > current),
                       default=current)

    loop, model, opt = _port_loop(tmp_path)
    resized, logs = [], []
    loop.autoscaler = Autoscaler(Grow(), [1, 2, 4], cooldown_chunks=0)
    loop.metrics_bus = MetricsBus()
    loop.on_resize = resized.append
    loop.run(model, opt, 10, log=logs.append)
    assert resized == [2, 4] and loop.degree == 4
    assert [r.n_workers for r in loop.metrics_bus.chunks] == [1] * 5 + [2] * 5
    assert sum(line.startswith("[elastic]") for line in logs) == 2
