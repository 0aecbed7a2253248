"""The port's training loop against the JAX package's on the two families
phase 17 of ``chip_smoke.py`` trains on the card, on the CPU.

``build_train_step`` + ``TrainLoop`` on reduced DeepSeekMoE-16B and
Mamba2-780M, set up as ``tests/test_torch_ft.py`` sets up paper-synthetic
(2 microbatches of 4 rows of 16 tokens, constant schedule at 3e-3, no
remat): the same parameters and stream through both loops give the
reference's losses to 1e-5 relative at every step and its parameters
within ``PARAM_ATOL`` (a tenth of the learning rate), all but
``LOOSE_SHARE`` of the elements within 1e-6 (the reasons are that file's).
Whether the stream's loss falls or rises over the steps is then the
recipe's (the model, the data and the optimizer), not the port's: both
loops give the same losses.
"""

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
from repro.data.pipeline import SyntheticLM as JData
from repro.ft.driver import TrainLoop as JTrainLoop
from repro.launch.cells import CellKnobs as JKnobs
from repro.launch.sharding import ShardingRules
from repro.launch.steps import build_train_step as jbuild
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
import repro_torch.configs as tconfigs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft.driver import TrainLoop
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch.cells import CellKnobs
from repro_torch.launch.steps import build_train_step
from repro_torch.optim import adamw

PARAM_ATOL = 3e-4
LOOSE_SHARE = 1e-3
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=1000,
           schedule="constant")
STEPS = 4


def _data(cls, cfg, **kw):
    return cls(vocab=cfg.padded_vocab, seq_len=16, batch=4, microbatches=2,
               seed=0, **kw)


def _recording(step, losses):
    def run(*args):
        out = step(*args)
        losses.append(float(out[2]["loss"]))
        return out
    return run


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-780m"])
def test_train_loop_matches_reference(tmp_path, name):
    cfg = jconfigs.get(name).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = ShardingRules(mesh=mesh, dp_axes=("data",), fsdp_axis=None)
    jstep = jax.jit(jbuild(cfg, rules, JKnobs(microbatches=2, remat=False,
                                               fsdp=False),
                           opt_cfg=jadamw.AdamWConfig(**OPT)))
    jlosses, tlosses = [], []
    jloop = JTrainLoop(train_step=_recording(jstep, jlosses),
                       data=_data(JData, cfg), ckpt_dir=str(tmp_path / "j"),
                       ckpt_every=100, metric_flush_every=1)
    jparams, _, _ = jloop.run(params, jadamw.init_state(params), STEPS,
                              log=lambda *_: None)

    tcfg = tconfigs.get(name).reduced()
    model = params_from_reference(tree, tcfg, device="cpu")
    step = build_train_step(tcfg, CellKnobs(microbatches=2, remat=False),
                            adamw.AdamWConfig(**OPT))
    loop = TrainLoop(train_step=_recording(step, tlosses),
                     data=_data(SyntheticLM, tcfg, device="cpu"),
                     ckpt_dir=str(tmp_path / "t"), cfg=tcfg, ckpt_every=100,
                     metric_flush_every=1)
    model, opt, _ = loop.run(model, adamw.init_state(model), STEPS,
                             log=lambda *_: None)
    assert len(tlosses) == len(jlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    got = params_to_reference(model, tcfg)
    errs = np.concatenate([
        np.abs(np.asarray(a) - b).ravel() for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jparams),
            jax.tree_util.tree_leaves_with_path(got))])
    assert errs.max() <= PARAM_ATOL
    assert (errs > 1e-6).mean() <= LOOSE_SHARE
