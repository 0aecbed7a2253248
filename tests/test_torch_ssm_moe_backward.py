"""The gradients of the SSD scan and the MoE gather against the JAX package,
on the CPU.

* ``ref.ssd_scan_backward_ref`` (explicit formulas, chunk by chunk) against
  ``torch.autograd`` through ``ref.ssd_scan_ref`` and against ``jax.grad``
  of the reference's ``ssd_chunked`` (``src/repro/models/mamba2.py``), on
  the same numpy inputs in float32: every gradient within 2e-4 of its
  largest magnitude (the scan's tolerance; both sides sum the same float32
  products in other orders).  Cases: S a multiple of the chunk and not, one
  B/C group shared by every head and B/C per head, a nonzero gradient of
  the final state, and a trained model's small dt, where the state carried
  across chunks decides the result.  ``ssd_chunked`` needs ``S % chunk ==
  0``, so it is compared on such lengths.
* ``ref.moe_gather_backward_ref`` against autograd through
  ``ref.moe_gather_ref`` and ``jax.grad`` of the reference's gather
  (``take_along_axis`` on the zero-padded x, ``moe.py``), exactly in
  float32 where a token has one row and within float32 rounding otherwise;
  at most ``k`` rows a token, dummy rows giving nothing.
* ``SsdScanFunction`` and ``MoeGatherFunction`` on CPU tensors take their
  plain versions and give autograd's gradients (a shared group's summed
  over the heads, in its ``[B, 1, S, N]`` layout).
The card versions are held to these plain versions by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import mamba2 as jmamba
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss

#: a gradient's largest error as a share of its largest magnitude
SSD_REL = 2e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _scan_case(seed, b, h, s, p, n, groups, dt_shift=0.0):
    """Numpy inputs in the model's layouts (x ``[B, S, H, P]``, dt ``[B, S,
    H]``, B/C ``[B, S, G, N]``), the output gradients (dy ``[B, S, H, P]``,
    dh ``[B, H, N, P]``)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    dt = np.log1p(np.exp(r(b, s, h) - dt_shift)).astype(np.float32)
    a = (-np.exp(r(h, scale=0.3))).astype(np.float32)
    return dict(x=r(b, s, h, p, scale=0.5), dt=dt, a=a,
                bm=r(b, s, groups, n, scale=0.3),
                cm=r(b, s, groups, n, scale=0.3), dy=r(b, s, h, p),
                dh=r(b, h, n, p))


def _port_args(c):
    """The case as the port's public layout: [B, H, S, ...] views and B/C
    in the group layout [B, G, S, N]."""
    def t(a):
        return torch.as_tensor(a)
    return (t(c["x"]).transpose(1, 2), t(c["dt"]).transpose(1, 2), t(c["a"]),
            t(c["bm"]).transpose(1, 2), t(c["cm"]).transpose(1, 2))


def _autograd(args, dy, dh, chunk):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    x, dt, a, bm, cm = leaves
    heads = x.shape[1]
    y, h = tref.ssd_scan_ref(x, dt, a, tss.heads_view(bm, heads),
                             tss.heads_view(cm, heads), chunk=chunk)
    loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
    return torch.autograd.grad(loss, leaves)


def _close(got, want, rel=SSD_REL):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (name, err)


@pytest.mark.parametrize("s,chunk,groups,dt_shift,with_dh", [
    (64, 16, 1, 0.0, True),      # a multiple of the chunk, a shared group
    (37, 16, 1, 0.0, True),      # a tail chunk
    (45, 16, 3, 0.0, False),     # B/C per head, no final-state gradient
    (80, 16, 1, 5.0, True),      # small dt: the carry decides
    (5, 256, 3, 0.0, True),      # one chunk shorter than the default
])
def test_scan_backward_ref_matches_autograd(s, chunk, groups, dt_shift,
                                            with_dh):
    c = _scan_case(s, 2, 3, s, 8, 12, groups, dt_shift)
    args = _port_args(c)
    dy = torch.as_tensor(c["dy"]).transpose(1, 2)
    dh = torch.as_tensor(c["dh"]) if with_dh else None
    got = tref.ssd_scan_backward_ref(*args, dy, dh, chunk=chunk)
    _close(got, _autograd(args, dy, dh, chunk))
    assert got[0].shape == args[0].shape and got[3].shape == args[3].shape


@pytest.mark.parametrize("s,chunk,groups,dt_shift", [
    (64, 16, 1, 0.0), (48, 16, 4, 0.0), (96, 32, 1, 5.0)])
def test_scan_backward_ref_matches_jax_grad_of_ssd_chunked(s, chunk, groups,
                                                           dt_shift):
    """``jax.grad`` of the reference's ``ssd_chunked`` on a loss that reads
    y and the final state: the port's explicit formulas at the same
    chunk."""
    h = 4
    c = _scan_case(7 * s, 2, h, s, 8, 16, groups, dt_shift)

    def loss(x, dt, a, bm, cm):
        y, hf = jmamba.ssd_chunked(x, dt, a, bm, cm, chunk)
        return (y * c["dy"]).sum() + (hf * c["dh"]).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(c[k]) for k in ("x", "dt", "a", "bm", "cm")))
    got = tref.ssd_scan_backward_ref(
        *_port_args(c), torch.as_tensor(c["dy"]).transpose(1, 2),
        torch.as_tensor(c["dh"]), chunk=chunk)
    # the port's [B, H, S, ...] / [B, G, S, N] layouts back to the model's
    got = [got[0].transpose(1, 2), got[1].transpose(1, 2), got[2],
           got[3].transpose(1, 2), got[4].transpose(1, 2)]
    _close(got, [np.asarray(w) for w in want])


def test_scan_function_on_the_cpu_gives_autograds_gradients():
    """``SsdScanFunction`` on CPU tensors: the plain forward and the plain
    backward; a shared group's gradient comes back ``[B, 1, S, N]``."""
    for groups in (1, 3):
        c = _scan_case(11 + groups, 1, 3, 40, 8, 12, groups)
        args = [a.detach().clone().requires_grad_(True)
                for a in _port_args(c)]
        dy = torch.as_tensor(c["dy"]).transpose(1, 2)
        dh = torch.as_tensor(c["dh"])
        y, hf = tss.SsdScanFunction.apply(*args)
        want_y, want_h = tref.ssd_scan_ref(
            *args[:3], tss.heads_view(args[3], 3),
            tss.heads_view(args[4], 3))
        torch.testing.assert_close(y, want_y, rtol=0, atol=0)
        torch.testing.assert_close(hf, want_h, rtol=0, atol=0)
        got = torch.autograd.grad((y * dy).sum() + (hf * dh).sum(), args)
        assert got[3].shape == (1, groups, 40, 12)
        _close(got, _autograd(_port_args(c), dy, dh, 256))
        # only y's gradient (dh None)
        y, _ = tss.SsdScanFunction.apply(*args)
        got = torch.autograd.grad((y * dy).sum(), args)
        _close(got, _autograd(_port_args(c), dy, None, 256))


# ---------------------------------------------------------------------------
# the MoE gather
# ---------------------------------------------------------------------------

def _dispatch(seed, tokens, rows, k, dummies):
    """A buffer of ``rows`` rows naming tokens, each token at most ``k``
    times, ``dummies`` of them the dummy ``tokens``."""
    rng = np.random.default_rng(seed)
    picks = np.repeat(np.arange(tokens), k)[rng.permutation(tokens * k)]
    tok = np.full(rows, tokens, np.int32)
    live = rng.choice(rows, size=rows - dummies, replace=False)
    tok[live] = picks[:rows - dummies]
    return tok


@pytest.mark.parametrize("tokens,rows,k,dummies,d", [
    (6, 16, 2, 5, 4), (10, 60, 6, 12, 33), (5, 8, 1, 3, 8), (4, 6, 2, 6, 3)])
def test_gather_backward_ref_matches_autograd_and_jax(tokens, rows, k,
                                                      dummies, d):
    tok = _dispatch(rows, tokens, rows, k, dummies)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((tokens, d)).astype(np.float32)
    dout = rng.standard_normal((rows, d)).astype(np.float32)
    got = tref.moe_gather_backward_ref(torch.as_tensor(dout),
                                       torch.as_tensor(tok), tokens,
                                       max_rows_per_token=k)
    xt = torch.as_tensor(x).requires_grad_(True)
    want = torch.autograd.grad(
        tref.moe_gather_ref(xt, torch.as_tensor(tok)), xt,
        torch.as_tensor(dout))[0]

    def gather(xj):  # the reference's: take_along_axis on the padded x
        x_pad = jnp.concatenate([xj, jnp.zeros((1, d), xj.dtype)])
        return jnp.take_along_axis(x_pad, jnp.asarray(tok)[:, None], axis=0)

    jwant = jax.grad(lambda xj: (gather(xj) * dout).sum())(jnp.asarray(x))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-6,
                               atol=1e-6)
    if k == 1:   # one row a token: a copy, exact
        assert torch.equal(got, want)
    if dummies == rows:
        assert not got.any()


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 9), st.integers(1, 4), st.integers(0, 12),
       st.integers(1, 6), st.integers(0, 2 ** 16))
def test_gather_backward_sums_each_tokens_rows_in_buffer_order(
        tokens, k, dummies, d, seed):
    """Each token's rows summed in buffer order in float32, rounded once:
    the plain version equals a loop that does those additions."""
    rows = tokens * k + dummies
    tok = _dispatch(seed, tokens, rows, k, dummies)
    dout = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (rows, d)).astype(np.float32)).to(torch.bfloat16)
    got = tref.moe_gather_backward_ref(dout, torch.as_tensor(tok), tokens,
                                       max_rows_per_token=k)
    want = torch.zeros((tokens, d), dtype=torch.float32)
    for r in range(rows):
        if tok[r] < tokens:
            want[tok[r]] += dout[r].float()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_gather_function_on_the_cpu_gives_autograds_gradient():
    tok = torch.as_tensor(_dispatch(3, 7, 20, 2, 6))
    x = torch.randn(7, 16, requires_grad=True)
    dout = torch.randn(20, 16)
    out = tmd.MoeGatherFunction.apply(x, tok, 2)
    assert torch.equal(out, tref.moe_gather_ref(x, tok))
    got = torch.autograd.grad(out, x, dout)[0]
    want = torch.autograd.grad(tref.moe_gather_ref(x, tok), x, dout)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
