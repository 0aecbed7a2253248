"""The long-context decode's single-process parts: the decode over a block
of global positions and its merge, the rules' ``seq_axis``, and
``build_cell`` for a decode batch that does not divide the data axes (the
multi-rank runs are ``test_torch_mesh_{dp2,dp2tp2,pod}.py``).

* ``ref.decode_attention_partial_ref`` over a cache cut into 1-4 blocks,
  the blocks merged by their log-sum-exp, equals the reference's
  ``attend_decode`` over the whole cache (its token's own k/v passed apart,
  the port's written into the cache) within float32 3e-5: windows that
  cross a block boundary, softcap, blocks with no admitted row (``o`` 0,
  ``lse`` -inf, weight 0), and a window's lower bound on global positions
  (a length clamped to a block's rows first would admit more rows).
* ``ops.decode_attention_partial`` on CPU tensors is the plain version.
* ``_resolve`` with ``seq_axis`` and ``logical`` equal the reference's.
* ``build_cell`` on a live mesh gives a decode cell of batch 1 rules whose
  ``seq_axis`` is the data axes, and refuses a prefill of that batch.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh

from repro.launch import sharding as jsharding
from repro.models import attention as jattn
import repro_torch.configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import mamba2
from repro_torch.models.config import LONG_500K, ShapeConfig

TOL = 3e-5
S, HD = 48, 16


def _case(seed, b, hq, hkv, index):
    """q, the cache with each slot's token at its index (the port's) and
    without it (the reference's, the token's k/v apart), numpy float32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, HD)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, hkv, S, HD)).astype(np.float32)
              for _ in range(2))
    k_new, v_new = (rng.standard_normal((b, hkv, HD)).astype(np.float32)
                    for _ in range(2))
    tk, tv = ck.copy(), cv.copy()
    for i, p in enumerate(index):
        tk[i, :, p], tv[i, :, p] = k_new[i], v_new[i]
    return q, (ck, cv), (k_new, v_new), (tk, tv)


def _merged(q, tk, tv, valid, n_blocks, **kw):
    """The blocks' partial decodes merged: ``(o, every block's lse)``."""
    size = S // n_blocks
    parts = [ref.decode_attention_partial_ref(
        q, tk[:, :, i * size:(i + 1) * size], tv[:, :, i * size:(i + 1) * size],
        valid, i * size, **kw) for i in range(n_blocks)]
    o_r = torch.stack([o for o, _ in parts])
    lse_r = torch.stack([lse for _, lse in parts])
    total = torch.logsumexp(lse_r, dim=0)
    return (torch.exp(lse_r - total)[..., None] * o_r).sum(dim=0), lse_r


def _reference(q, cache, new, index, *, softcap, window):
    """The reference's ``attend_decode`` over the whole cache, the token's
    k/v apart, per-slot lengths ``index``."""
    ck, cv = cache
    k_new, v_new = new
    o = jattn.attend_decode(
        jnp.asarray(q)[:, None], jnp.asarray(ck.transpose(0, 2, 1, 3)),
        jnp.asarray(cv.transpose(0, 2, 1, 3)),
        kv_valid_len=jnp.asarray(index, jnp.int32),
        k_new=jnp.asarray(k_new)[:, None], v_new=jnp.asarray(v_new)[:, None],
        softcap=softcap, window=window, block_k=16)
    return np.asarray(o)[:, 0]


def _holds(seed, n_blocks, index, window, softcap, hq=4, hkv=2):
    q, cache, new, (tk, tv) = _case(seed, len(index), hq, hkv, index)
    q, tk, tv = (torch.from_numpy(a) for a in (q, tk, tv))
    valid = torch.tensor(index, dtype=torch.int32) + 1
    got, lse_r = _merged(q, tk, tv, valid, n_blocks, softcap=softcap,
                         window=window + 1 if window else 0)
    want = _reference(q.numpy(), cache, new, index, softcap=softcap,
                      window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    return lse_r


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 50.0), (10, 0.0),
                                            (13, 30.0)])
def test_blocks_merged_equal_the_reference(n_blocks, window, softcap):
    """Slots at the first position, in block 0, on a block's last and
    first rows and at the cache's last row."""
    size = S // n_blocks
    index = [0, size // 2, size - 1, min(size, S - 1), S - 1]
    _holds(n_blocks + 10 * window, n_blocks, index, window, softcap)


def test_window_across_a_block_boundary_and_empty_blocks():
    """Blocks of 16 rows: position 20 with a window of 8 admits rows 13-20
    (the window's bound on global positions, across blocks 0 and 1: a
    length clamped to block 0's rows first, 16, would move the bound to 7
    and admit rows 8-12 too); block 2 admits none, so its ``o`` is 0 and
    its ``lse`` -inf."""
    lse_r = _holds(5, 3, [20, 5], 8, 50.0)
    assert torch.isinf(lse_r[2]).all() and (lse_r[2] < 0).all()
    assert torch.isfinite(lse_r[:2, 0]).all()
    assert torch.isinf(lse_r[1:, 1]).all()        # position 5: block 0 only
    q, _, _, (tk, tv) = _case(5, 1, 4, 2, [20])
    o, lse = ref.decode_attention_partial_ref(
        torch.from_numpy(q), torch.from_numpy(tk[:, :, 32:]),
        torch.from_numpy(tv[:, :, 32:]), torch.tensor([21]), 32, window=9)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.full_like(lse, -torch.inf))


@settings(max_examples=40, deadline=None)
@given(n_blocks=st.sampled_from([1, 2, 3, 4]),
       index=st.lists(st.integers(0, S - 1), min_size=1, max_size=3),
       window=st.integers(0, S + 4),
       softcap=st.sampled_from([0.0, 30.0]),
       group=st.sampled_from([(4, 4), (4, 2), (8, 1)]),
       seed=st.integers(0, 2 ** 16))
def test_blocks_merged_equal_the_reference_property(n_blocks, index, window,
                                                    softcap, group, seed):
    _holds(seed, n_blocks, index, window, softcap, *group)


def test_ops_partial_on_cpu_is_the_plain_version():
    q, _, _, (tk, tv) = _case(1, 2, 4, 2, [7, 30])
    q, tk, tv = (torch.from_numpy(a) for a in (q, tk, tv))
    valid = torch.tensor([8, 31], dtype=torch.int32)
    before = ops.launch_counts()["decode_attention_partial"]
    got = ops.decode_attention_partial(q, tk[:, :, 16:], tv[:, :, 16:],
                                       valid, 16, softcap=30.0, window=9)
    want = ref.decode_attention_partial_ref(q, tk[:, :, 16:], tv[:, :, 16:],
                                            valid, 16, softcap=30.0, window=9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["decode_attention_partial"] == before


@pytest.mark.parametrize("sizes,names,seq", [
    ((16, 16), ("data", "model"), "data"),
    ((2, 16, 16), ("pod", "data", "model"), ("pod", "data")),
    ((16, 16), ("data", "model"), None)])
def test_resolve_seq_and_logical_match_reference(sizes, names, seq):
    dp = mesh_lib.dp_axes(mesh_lib.MeshLayout(names, sizes))
    jr = jsharding.ShardingRules(mesh=AbstractMesh(sizes, names), dp_axes=dp,
                                 seq_axis=seq)
    tr = sh.ShardingRules(mesh=mesh_lib.MeshLayout(names, sizes), dp_axes=dp,
                          seq_axis=seq)
    for axes in [("batch", "seq", "tp", None), ("seq",), (None, "seq"),
                 ("tp", "seq", "batch"), ("data", "seq")]:
        assert sh.logical(*axes) == jsharding.logical(*axes) == axes
        assert sh._resolve(tr, sh.logical(*axes)) == tuple(
            jsharding._resolve(jr, axes))
    assert steps.make_rules(mesh_lib.MeshLayout(names, sizes),
                            tconfigs.get("mamba2-780m"),
                            steps.knobs_for(tconfigs.get("mamba2-780m"),
                                            LONG_500K)).seq_axis is None


@pytest.mark.parametrize("sizes", [(2, 1), (2, 2)])
def test_build_cell_runs_a_batch_that_does_not_divide_the_data_axes(sizes):
    """A live mesh (here a stand-in: ``build_cell`` reads its layout) of a
    decode whose batch of 1 does not divide the data axes: the cell's rules
    carry ``seq_axis``, its caches' specs split the KV sequence over the
    data axes and the Mamba state's heads by ``long_decode_heads``; a
    prefill of that batch is refused."""
    layout = mesh_lib.MeshLayout(("data", "model"), sizes)
    live = types.SimpleNamespace(layout=layout)
    cfg = tconfigs.get("jamba-1.5-large-398b")
    cell = steps.build_cell(cfg, LONG_500K, layout, device="meta", mesh=live)
    assert cell.rules.seq_axis == "data" and cell.rules.live is live
    kv = next(c for c in cell.pspecs["caches"] if "k" in c)["k"]
    assert kv[2] == "data"                          # [B, Hkv, S, hd]
    h = next(c for c in cell.pspecs["caches"] if "h" in c)["h"]
    heads = mamba2.dims(cfg.d_model, cfg.ssm)[1]
    assert h[1] == mamba2.long_decode_heads(heads, cell.rules) == (
        "data", "model")
    # a batch that divides keeps no seq axis
    even = steps.build_cell(cfg, ShapeConfig("even", 64, 4, "decode"),
                            layout, device="meta", mesh=live)
    assert even.rules.seq_axis is None
    with pytest.raises(ValueError, match="does not split"):
        steps.build_cell(cfg, ShapeConfig("one", 64, 1, "prefill"), layout,
                         device="meta", mesh=live)


@pytest.mark.parametrize("heads,sizes,want", [
    (48, (2, 2), ("data", "model")), (6, (2, 2), "model"),
    (3, (2, 2), None), (6, (4, 1), "model"), (8, (4, 1), ("data", "model"))])
def test_long_decode_heads_is_the_references_spec(heads, sizes, want):
    """The reference's rule (``cache_pspecs``): every axis the heads
    divide, else the model axis, else replicated."""
    layout = mesh_lib.MeshLayout(("data", "model"), sizes)
    rules = sh.ShardingRules(mesh=layout, dp_axes=("data",))
    assert mamba2.long_decode_heads(heads, rules) == want
