"""The MoE token table, the combine over a given table and the MoE FFN's
gradients against the JAX package, on the CPU.

* ``ref.token_rows_table`` (the plain version of the ``moe_token_table``
  kernel) and ``ops.token_rows_table`` on CPU tensors against a direct
  oracle: ``table[t, j]`` is token ``t``'s ``j``-th row in buffer order,
  ``R`` for none, a token's rows past ``k`` dropped (its first ``k`` kept),
  rows of a token outside ``[0, T)`` nowhere, ``k = 0`` taken as 1; drawn
  by Hypothesis and at the edges (over-full tokens, only dummy rows, no
  rows, one token in every row).  The kernel is held bit for bit to the
  plain version on the card by ``tests/test_torch_cuda.py``.
* ``ops.moe_combine`` and the gather's plain backward given a prebuilt
  table (int64 or int32) give the same bits as without one.
* ``moe_ffn`` (which now builds its table once and hands it to the gather
  and the combine) against ``jax.grad`` of the reference's ``moe_ffn``: the
  gradients of x and of every parameter within 2e-5 of each leaf's largest
  magnitude (float32 sums in another order), with and without capacity
  drops and with a router bias.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.configs as jconfigs
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe

GRAD_REL = 2e-5


def _oracle(tok, num_tokens, k):
    """The table by a loop over the rows in buffer order."""
    r = len(tok)
    k = max(k, 1)
    table = np.full((num_tokens, k), r, np.int64)
    seen = np.zeros(num_tokens, np.int64)
    for row, tk in enumerate(tok):
        if 0 <= tk < num_tokens:
            if seen[tk] < k:
                table[tk, seen[tk]] = row
            seen[tk] += 1
    return table


def _both(tok, num_tokens, k):
    tt = torch.as_tensor(np.asarray(tok, np.int32))
    got = tref.token_rows_table(tt, num_tokens, k)
    via_ops = tops.token_rows_table(tt, num_tokens, k)
    assert got.dtype == torch.int64
    assert torch.equal(via_ops, got)
    return got.numpy()


@settings(deadline=None, max_examples=60)
@given(st.integers(1, 12).flatmap(lambda n: st.tuples(
    st.just(n), st.integers(0, 5),
    st.lists(st.integers(-2, n + 2), max_size=40))))
def test_token_table_matches_oracle(case):
    n, k, tok = case
    np.testing.assert_array_equal(_both(tok, n, k), _oracle(tok, n, k))


@pytest.mark.parametrize("tok,n,k,want", [
    # token 1 has five rows: its first three in buffer order stay
    ([1, 0, 1, 1, 2, 1, 1], 3, 3, [[1, 7, 7], [0, 2, 3], [4, 7, 7]]),
    # only dummy rows (and one below zero): no token has a row
    ([4, 4, -1, 4], 4, 2, [[4, 4]] * 4),
    # no rows at all
    ([], 3, 2, [[0, 0]] * 3),
    # one token in every row, k 0 taken as 1
    ([0, 0, 0, 0], 1, 0, [[0]]),
    ([2] * 6, 3, 4, [[6] * 4, [6] * 4, [0, 1, 2, 3]]),
], ids=["over-full", "dummies", "no-rows", "k0", "one-token"])
def test_token_table_edges(tok, n, k, want):
    np.testing.assert_array_equal(_both(tok, n, k), np.asarray(want))


@pytest.mark.parametrize("index", [torch.int64, torch.int32])
def test_combine_and_gather_backward_with_a_given_table(index):
    """A prebuilt table (the model's, int64 on the CPU and int32 from the
    kernel on the card) changes nothing: the same bits as without one."""
    rng = np.random.default_rng(4)
    n, d, r, k = 25, 12, 90, 4
    rows = torch.as_tensor(rng.standard_normal((r, d)).astype(np.float32))
    tok = torch.as_tensor(rng.integers(0, n + 1, r).astype(np.int32))
    w = torch.as_tensor(rng.random(r).astype(np.float32))
    table = tops.token_rows_table(tok, n, k).to(index)
    want = tops.moe_combine(rows, tok, w, n, max_rows_per_token=k)
    got = tops.moe_combine(rows, tok, w, n, max_rows_per_token=k,
                           table=table)
    assert torch.equal(got, want)
    want = tref.moe_gather_backward_ref(rows, tok, n, max_rows_per_token=k)
    got = tref.moe_gather_backward_ref(rows, tok, n, max_rows_per_token=k,
                                       table=table)
    assert torch.equal(got, want)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                        ).requires_grad_()
    for tab in (None, table):
        out = tmd.MoeGatherFunction.apply(x, tok, k, tab)
        (gx,) = torch.autograd.grad(out, x, rows)
        assert torch.equal(gx, want)


def _moe_layer(capacity_factor, bias, seed):
    j = jconfigs.get("deepseek-moe-16b").reduced()
    tc = tconfigs.get("deepseek-moe-16b").reduced()
    jm = dataclasses.replace(j.moe, capacity_factor=capacity_factor,
                             router_bias=bias)
    tm = dataclasses.replace(tc.moe, capacity_factor=capacity_factor,
                             router_bias=bias)
    d = j.d_model
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), d,
                                                 jm, jnp.float32))
    if bias:
        jp["router_bias"] = np.random.default_rng(seed).standard_normal(
            jm.num_experts).astype(np.float32)
    mod = tmoe.MoE(d, tm, "silu", dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.as_tensor(np.array(leaf)))
    return jm, tm, jp, mod, d


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("capacity_factor,bias", [(1.25, False),
                                                  (0.5, False),
                                                  (1.25, True)],
                         ids=["no-drops", "drops", "router-bias"])
def test_moe_ffn_gradients_match_reference(capacity_factor, bias):
    jm, tm, jp, mod, d = _moe_layer(capacity_factor, bias, 3)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    gout = rng.standard_normal((2, 24, d)).astype(np.float32)

    def jloss(xx, pp):
        out, aux = jmoe.moe_ffn(xx, pp, jm)
        return jnp.sum(out * gout) + 0.5 * aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.as_tensor(x).requires_grad_()
    out, aux = tmoe.moe_ffn(tx, mod, tm)
    names = [n for n, p in mod.named_parameters() if p.requires_grad]
    params = [p for n, p in mod.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(
        (out * torch.as_tensor(gout)).sum() + 0.5 * aux, [tx] + params,
        allow_unused=True)
    pairs = [("x", grads[0], np.asarray(jgx))] + [
        (n, g, _leaf(jgp, n)) for n, g in zip(names, grads[1:])]
    for name, got, want in pairs:
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= GRAD_REL * scale, name
