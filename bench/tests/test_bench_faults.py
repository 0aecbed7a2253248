"""The comparison that decides ``correct`` sees each fault a cell can have,
planted under the harness in the timed path at tiny sizes on the CPU (the
look for a card is skipped): a step that returns its state unchanged, half
of the batch left out with the mean taken over the rest, a served token
altered where it is produced.  Both cells run on one chip, so there is no
exchange between chips to leave out."""

import pytest
import torch

from bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("faults"))


def test_sound_runs_are_correct(root):
    assert tiny.run(root, tiny.TRAIN)["correct"]
    assert tiny.run(root, tiny.SERVE)["correct"]


def test_a_step_that_leaves_the_state_unchanged(root, monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(params, grads, state, cfg, *, grad_norm=None):
        zero = torch.zeros(())
        return params, {**state, "step": state["step"] + 1}, {
            "grad_norm": zero, "lr": zero}

    monkeypatch.setattr(adamw, "apply_updates", unchanged)
    r = tiny.run(root, tiny.TRAIN)
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(root, monkeypatch):
    from repro_torch.launch import steps

    whole = steps.accumulate_grads

    def half(params, batch, run_cfg, accum_dtype=torch.float32):
        k = batch["tokens"].shape[0]
        return whole(params, {n: v[:k // 2] for n, v in batch.items()},
                     run_cfg, accum_dtype)

    monkeypatch.setattr(steps, "accumulate_grads", half)
    r = tiny.run(root, tiny.TRAIN)
    assert not r["correct"]
    assert r["checks"]["grad_norm_gap"]["value"] > \
        r["checks"]["grad_norm_gap"]["limit"]


def test_a_served_token_altered_where_it_is_produced(root, monkeypatch):
    from repro_torch.models import transformer

    decode = transformer.decode_forward
    steps = []

    def altered(params, batch, cfg, caches, cache_index):
        """Every third decode step serves each slot another token than its
        greedy one."""
        logits, caches = decode(params, batch, cfg, caches, cache_index)
        steps.append(1)
        if len(steps) % 3 == 0:
            rows = logits[:, -1]
            pick = (rows.argmax(-1) + 7) % rows.shape[-1]
            rows.scatter_(-1, pick[:, None], rows.max(-1, keepdim=True)
                          .values + 1.0)
        return logits, caches

    monkeypatch.setattr(transformer, "decode_forward", altered)
    r = tiny.run(root, tiny.SERVE)
    assert not r["correct"]
    assert r["checks"]["logit_gap_mean"]["value"] > \
        r["checks"]["logit_gap_mean"]["limit"]
