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

from pathlib import Path

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
from repro_torch.kernels import ssd_scan as tss
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


def _planes(v, split):
    """A float32 operand as the kernel's products take it: whole (float32),
    or bf16 hi = bf16(v) and lo = bf16(v - hi) (bfloat16)."""
    if not split:
        return [v]
    hi = v.to(torch.bfloat16).float()
    return [hi, (v - hi).to(torch.bfloat16).float()]


def _scan_emulation(x, dt, A, Bm, Cm, *, drop_carry=False):
    """The chunk-parallel CUDA scan's arithmetic on the CPU in float32, at
    its chunk (``tss.CHUNK`` of x's dtype), the tail padded with dt = 0:
    (a) cum, the decays and S_k = B^T (x w) with w_j = exp(total - cum_j)
    dt_j, the score tile C B^T once per chunk for a shared group (head
    stride 0) else per head; (b) h_{k-1} passed over the chunks; (c) y =
    exp(cum_i) C h_{k-1} + (C B^T o L dt) x.  bfloat16: x w, h_{k-1} and G
    enter the products as bf16 hi + lo planes, x, B, C exact, y rounded
    once.  ``drop_carry`` leaves out h_{k-1} (a planted fault)."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    c = tss.CHUNK[x.dtype]
    split = x.dtype == torch.bfloat16
    nc = -(-s // c)
    pad = nc * c - s
    rows = torch.nn.functional.pad

    def chunked(v, width):
        return rows(v.float(), (0, 0, 0, pad)).reshape(v.shape[0], v.shape[1],
                                                      nc, c, width)

    def clip_exp(v):
        return torch.exp(v.clamp(-60.0, 0.0))

    xf, Bf, Cf = chunked(x, p), chunked(Bm, n), chunked(Cm, n)
    dtf = rows(dt.float(), (0, pad)).reshape(b, h, nc, c)
    cum = torch.cumsum(dtf * A.float()[None, :, None, None], -1)
    total = cum[..., -1]
    # (a)
    xw = xf * (clip_exp(total[..., None] - cum) * dtf)[..., None]
    states = sum(Bf.transpose(-1, -2) @ part for part in _planes(xw, split))
    shared = tss.shared_group(Bm, Cm)
    scores = (Cf[:, :1] @ Bf[:, :1].transpose(-1, -2)) if shared \
        else Cf @ Bf.transpose(-1, -2)
    # (b)
    hk = torch.zeros((b, h, n, p))
    h_prev = []
    for k in range(nc):
        h_prev.append(hk)
        hk = clip_exp(total[..., k])[..., None, None] * hk + states[:, :, k]
    h_prev = torch.stack(h_prev, dim=2)
    # (c)
    lower = torch.ones((c, c), dtype=torch.bool).tril()
    G = scores * clip_exp(cum[..., :, None] - cum[..., None, :]) \
        * torch.where(lower, dtf[..., None, :], 0.0)
    y = sum(part @ xf for part in _planes(G, split))
    if not drop_carry:
        carry = sum(Cf @ part for part in _planes(h_prev, split))
        y = y + carry * clip_exp(cum)[..., None]
    return y.reshape(b, h, nc * c, p)[:, :, :s].to(x.dtype), hk


class TestChunkParallelScan:
    """The CUDA scan's decomposition (``_scan_emulation``) against the
    reference's Pallas kernel in interpret mode, at the edges of the
    kernel's chunk (its length - 1, the length, + 1, 2 x + 1), with one B/C
    group shared by every head (stride 0, one score tile per chunk) and
    with B/C per head, at dt = softplus(randn - 5), where the state carried
    across chunks matters (and at softplus(randn)).  float32 within 2e-4;
    bfloat16 (x, B, C rounded to bf16 first, the operand splits emulated)
    within 5e-2 and within one bf16 rounding step of each value past 3e-5
    (float32 sums at these widths differ by less), since the splits keep
    the products near float32 and y is rounded once; a run without the
    splits fails it."""

    H, P, N = 3, 16, 32

    def _inputs(self, seed, s, shift):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal((1, s, self.H, self.P)) * 0.5)
        dt = np.log1p(np.exp(rng.standard_normal((1, self.H, s)) - shift))
        a = -np.exp(rng.standard_normal(self.H) * 0.3)
        bm = rng.standard_normal((1, s, self.N)) * 0.3
        cm = rng.standard_normal((1, s, self.N)) * 0.3
        return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("edge,shared,shift", [
        (-1, True, 5.0), (-1, False, 5.0), (0, True, 5.0), (0, False, 5.0),
        (1, True, 5.0), (1, False, 5.0), ("2c+1", True, 5.0),
        ("2c+1", False, 5.0), ("2c+1", True, 0.0)])
    def test_emulation_vs_interpret_kernel(self, dtype, edge, shared, shift):
        c = tss.CHUNK[dtype]
        s = 2 * c + 1 if edge == "2c+1" else c + edge
        x, dt, a, bm, cm = self._inputs(s, s, shift)
        # the model's layouts: x transposed from [B, S, H, P], the group
        # expanded over the heads (stride 0) or copied per head
        tx = torch.as_tensor(x).to(dtype).transpose(1, 2)
        group = [torch.as_tensor(v).to(dtype)[:, None].expand(
            1, self.H, s, self.N) for v in (bm, cm)]
        if not shared:
            group = [g.contiguous() for g in group]
        assert tss.shared_group(*group) == shared
        # the reference on the same (rounded) values, one chunk of S
        ref_in = [tx.float().numpy(), dt, a] + [g.float().numpy()
                                               for g in group]
        jy, jh = jssd(*(jnp.asarray(v) for v in ref_in), chunk=s,
                      interpret=True)
        jy, jh = np.asarray(jy), np.asarray(jh)
        y, h = _scan_emulation(tx, t(dt), t(a), *group)
        assert y.dtype == dtype and y.shape == (1, self.H, s, self.P)
        tol = SSD if dtype == torch.float32 else dict(atol=5e-2, rtol=5e-2)
        np.testing.assert_allclose(y.float().numpy(), jy, **tol)
        np.testing.assert_allclose(h.numpy(), jh, **SSD)

        def steps(got):  # in bf16 rounding steps of each value, past 3e-5
            return (np.abs(got.float().numpy() - jy)
                    / (3e-5 + 2 ** -7 * np.abs(jy))).max()

        if dtype == torch.bfloat16:
            assert steps(y) <= 1.0
        if edge == "2c+1" and shift:
            # the state carried across chunks moves y past the check here
            lost, _ = _scan_emulation(tx, t(dt), t(a), *group,
                                      drop_carry=True)
            if dtype == torch.bfloat16:
                assert steps(lost) > 1.0
            else:
                assert not np.allclose(lost.numpy(), jy, **SSD)

    def test_chunk_and_workspace_follow_the_source(self):
        """The wrapper's chunks and workspace size are the kernel's own
        (csrc/ssd_scan.cu), which refuses a smaller workspace."""
        src = (Path(tss.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
        for dtype, cname in ((torch.bfloat16, "bf16"),
                             (torch.float32, "float")):
            block = src.split(f"struct Route<{cname}> {{")[1].split("};")[0]
            assert f"kChunk = {tss.CHUNK[dtype]};" in block
        c = tss.CHUNK[torch.bfloat16]
        nc = -(-8192 // c)
        states = 48 * nc * 128 * 64 * 4
        assert tss.workspace_bytes(1, 48, 8192, 64, 128, torch.bfloat16,
                                   True) == 2 * states + 48 * nc * 4 \
            + nc * c * c * 4
        assert tss.workspace_bytes(1, 48, 8192, 64, 128, torch.bfloat16,
                                   False) == 2 * states + 48 * nc * 4 \
            + 48 * nc * c * c * 4


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
