"""The Mamba-2 slice against the JAX package: the SSD scan, the mixer and
the reduced Mamba2-780M.

The same numpy inputs go through the reference (its Pallas ``ssd_scan`` in
interpret mode, its sequential ``ssd_scan_ref``, its model code) and
through the port's plain versions on the CPU, in float32.  The scan is held
to 2e-4, the tolerance the reference holds its own kernel to
(``tests/test_kernels.py``); the mixer to 1e-5 and the whole reduced model
to 1e-4 (sums in another order through several layers).  The CUDA kernel is
held against the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models import mamba2 as jmamba
from repro.models import transformer as JT
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import transformer as TT

SSD = dict(atol=2e-4, rtol=2e-4)
BLOCK = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)


def t(a):
    return torch.as_tensor(np.array(a))


def _scan_inputs(seed, b, h, s, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, s, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, h, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, h, s, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (2, 2, 64, 8, 16, 16), (1, 3, 96, 16, 32, 32), (1, 2, 128, 32, 64, 64)])
def test_plain_scan_matches_reference_kernel_and_oracle(b, h, s, p, n, chunk):
    """The port's chunked plain version (at its own chunk and at the
    reference kernel's) and its sequential oracle against the reference's
    Pallas kernel in interpret mode and its sequential ``ssd_scan_ref``."""
    args = _scan_inputs(s, b, h, s, p, n)
    jy, jh = jssd(*(jnp.asarray(a) for a in args), chunk=chunk,
                  interpret=True)
    sy, sh = jref.ssd_scan_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(np.asarray(jy), np.asarray(sy), **SSD)
    targs = [t(a) for a in args]
    for got_y, got_h in (tref.ssd_scan_ref(*targs),
                         tref.ssd_scan_ref(*targs, chunk=chunk),
                         tref.ssd_scan_sequential(*targs),
                         tops.ssd_scan(*targs)):
        for want_y, want_h in ((jy, jh), (sy, sh)):
            np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                       **SSD)
            np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                       **SSD)


@pytest.mark.parametrize("s", [1, 37, 300])
def test_plain_scan_ragged_lengths(s):
    """Lengths no chunk divides (the tail padded with dt = 0) against the
    reference's sequential scan; the state is the one after the last real
    position."""
    args = _scan_inputs(7, 1, 2, s, 8, 16)
    want_y, want_h = jref.ssd_scan_ref(*(jnp.asarray(a) for a in args))
    for chunk in (256, 64, 16):
        y, h = tref.ssd_scan_ref(*(t(a) for a in args), chunk=chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SSD)


def test_plain_scan_takes_strided_views():
    """The model hands the scan transposed activations and one B/C group
    expanded over the heads with stride 0; the result equals the one on
    contiguous copies."""
    x, dt, a, bm, cm = _scan_inputs(3, 2, 4, 40, 8, 16)
    x_bshp = t(x).transpose(1, 2).contiguous()
    dt_bsh = t(dt).transpose(1, 2).contiguous()
    group = t(bm[:, :1]).expand(2, 4, 40, 16)
    y, h = tops.ssd_scan(x_bshp.transpose(1, 2), dt_bsh.transpose(1, 2), t(a),
                         group, group)
    y2, h2 = tref.ssd_scan_ref(t(x), t(dt), t(a), group.contiguous(),
                               group.contiguous())
    torch.testing.assert_close(y, y2, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h, h2, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    cfg = jconfigs.get("mamba2-780m").reduced()
    tcfg = tconfigs.get("mamba2-780m").reduced()
    jp = jax.tree.map(np.asarray, jmamba.init_mamba(
        jax.random.PRNGKey(2), cfg.d_model, cfg.ssm, jnp.float32))
    rng = np.random.default_rng(2)
    # non-trivial A, D, dt_bias and norm (the init's are constants)
    h = jp["A_log"].shape[0]
    jp["A_log"] = rng.uniform(-1.0, 2.0, h).astype(np.float32)
    jp["D"] = rng.standard_normal(h).astype(np.float32)
    jp["dt_bias"] = (rng.standard_normal(h) * 0.5).astype(np.float32)
    jp["norm"]["scale"] = (rng.standard_normal(jp["norm"]["scale"].shape)
                           * 0.1).astype(np.float32)
    mod = tmamba.Mamba(tcfg.d_model, tcfg.ssm, tcfg.norm_eps,
                       dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(t(leaf))
    return cfg, tcfg, jp, mod


def _state(cfg, seed, batch, zero_h):
    st = jax.tree.map(np.asarray, jmamba.init_mamba_state(
        batch, cfg.d_model, cfg.ssm, jnp.float32))
    rng = np.random.default_rng(seed)
    return {k: (v if (k == "h" and zero_h) else
                rng.standard_normal(v.shape).astype(np.float32) * 0.5)
            for k, v in st.items()}


@pytest.mark.parametrize("s", [1, 5, 37, 64])
def test_mamba_block_matches_reference(mixer, s):
    """Outputs and every state leaf.  S = 1 with a state is the one-step
    recurrence (a random state); longer inputs scan from a zero SSM state
    with the conv continuing from a random history, and without a state."""
    cfg, tcfg, jp, mod = mixer
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = _state(cfg, s, 2, zero_h=s > 1)
    jout, jst = jmamba.mamba_block(jnp.asarray(x), jp, cfg.ssm,
                                   norm_eps=cfg.norm_eps,
                                   state={k: jnp.asarray(v)
                                          for k, v in st.items()})
    tst = {k: t(v) for k, v in st.items()}
    tout, tst = tmamba.mamba_block(t(x), mod, tcfg.ssm,
                                   norm_eps=tcfg.norm_eps, state=tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **BLOCK)
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   **BLOCK)
    if s > 1:
        jout, _ = jmamba.mamba_block(jnp.asarray(x), jp, cfg.ssm,
                                     norm_eps=cfg.norm_eps)
        tout, none = tmamba.mamba_block(t(x), mod, tcfg.ssm,
                                        norm_eps=tcfg.norm_eps)
        assert none is None
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **BLOCK)


def test_short_input_with_state_the_reference_reads_one_token(mixer):
    """The reference sends 2-4 tokens that come with a state to its
    one-step recurrence, which reads only token 0, so with a zero state (a
    prefill, as its engine passes) its outputs at positions 1-2 differ from
    its stateless path.  The port scans: with a zero state it equals the
    stateless path and the token-by-token recurrence."""
    cfg, tcfg, jp, mod = mixer
    x = np.random.default_rng(3).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    zero = _state(cfg, 0, 2, zero_h=True)
    zero = {k: np.zeros_like(v) for k, v in zero.items()}
    j_state, _ = jmamba.mamba_block(jnp.asarray(x), jp, cfg.ssm,
                                    norm_eps=cfg.norm_eps,
                                    state={k: jnp.asarray(v)
                                           for k, v in zero.items()})
    j_free, _ = jmamba.mamba_block(jnp.asarray(x), jp, cfg.ssm,
                                   norm_eps=cfg.norm_eps)
    gap = np.abs(np.asarray(j_state) - np.asarray(j_free))
    assert gap[:, 0].max() < 1e-5 and gap[:, 1:].max() > 1e-3

    out, st = tmamba.mamba_block(t(x), mod, tcfg.ssm, norm_eps=tcfg.norm_eps,
                                 state={k: t(v) for k, v in zero.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(j_free), **BLOCK)
    seq = {k: t(v) for k, v in zero.items()}
    steps = []
    for i in range(3):
        o, seq = tmamba.mamba_block(t(x[:, i:i + 1]), mod, tcfg.ssm,
                                    norm_eps=tcfg.norm_eps, state=seq)
        steps.append(o)
    torch.testing.assert_close(out, torch.cat(steps, dim=1), **BLOCK)
    for k in st:
        torch.testing.assert_close(st[k], seq[k], **BLOCK)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_small():
    cfg = jconfigs.get("mamba2-780m").reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(4)))
    tcfg = tconfigs.get("mamba2-780m").reduced()
    return cfg, tree, tcfg, params_from_reference(tree, tcfg, device="cpu")


def test_reduced_mamba2_prefill_and_decode(mamba_small):
    """A 21-token prefill (ragged against the chunk of 16) and 8 decode
    steps: logits within 1e-4 and every state leaf of every layer."""
    cfg, tree, tcfg, model = mamba_small
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jcaches = JT.init_caches(cfg, 2, 48, cfg.cdtype)
    jlog, jcaches = JT.prefill_forward(tree, {"tokens": prompt}, cfg, jcaches)
    caches = TT.init_caches(tcfg, 2, 48, device="cpu")
    tlog, caches = TT.prefill_forward(model, {"tokens": t(prompt).long()},
                                      tcfg, caches)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for step in range(8):
        idx = np.full(2, 21 + step, np.int32)
        jlog, jcaches = JT.decode_forward(tree, {"tokens": tok}, cfg,
                                          jcaches, jnp.asarray(idx))
        tlog, caches = TT.decode_forward(model, {"tokens": t(tok).long()},
                                         tcfg, caches, t(idx))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for i, cache in enumerate(caches):
        for k, leaf in cache.items():
            want = np.asarray(jcaches["units"]["l0"][k])[i]
            np.testing.assert_allclose(leaf.numpy(), want, **MODEL)


def test_weights_round_trip_and_float32_leaves(mamba_small):
    cfg, tree, tcfg, model = mamba_small
    back = params_to_reference(model, tcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      flat_b[path])
    big = tconfigs.get("mamba2-780m")
    layer = TT.DecoderLayer(big.layer_specs()[0], big, device="meta")
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(layer.mixer, name).dtype == torch.float32
    assert layer.mixer.w_x.dtype == torch.bfloat16
    assert not hasattr(layer, "mlp") and not hasattr(layer, "ln2")


def test_init_params_and_caches():
    tcfg = tconfigs.get("mamba2-780m").reduced()
    model = TT.init_params(tcfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    mixer = model.layers[0].mixer
    torch.testing.assert_close(-torch.exp(mixer.A_log),
                               -torch.linspace(1.0, 16.0, 16))
    assert torch.equal(mixer.D, torch.ones(16))
    assert abs(float(mixer.conv_x.std()) / 0.1 - 0.8796) < 0.1
    caches = TT.init_caches(tcfg, 3, 32, device="cpu")
    assert len(caches) == tcfg.num_layers
    assert caches[0]["h"].shape == (3, 16, 16, 8)
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv_x"].shape == (3, 3, 128)
    assert caches[0]["conv_B"].shape == (3, 3, 16)
