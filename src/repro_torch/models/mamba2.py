"""The Mamba-2 (SSD) mixer: prefill through the chunked scan kernel, decode
by the one-step recurrence.

Port of ``repro/models/mamba2.py``.  Shapes follow the reference: d_inner =
expand * d_model, heads = d_inner / headdim, state N = d_state, ngroups
shared B/C groups (one in every configuration).  The parameters keep the
reference's leaves and layouts (split in-projections ``w_z``, ``w_x``
``[d, d_inner]``, ``w_B``, ``w_C`` ``[d, G N]``, ``w_dt`` ``[d, H]``,
depthwise ``conv_*`` ``[W, D]``, float32 ``A_log``, ``D`` and ``dt_bias``
``[H]``, the gated ``norm`` and ``w_out`` ``[d_inner, d]``).

A step of :func:`mamba_block`:

* ``S == 1`` with a state: :func:`ssd_decode_step`, plain PyTorch as in the
  reference (it has no kernel);
* any other call: the chunked scan through ``ops.ssd_scan`` from a zero
  SSM state, with the causal convolutions continuing from the state's conv
  history when a state is given.  Under grad on the card the scan's
  gradient (x, dt, A, B, C) is the backward kernel's
  (``csrc/ssd_scan_backward.cu``, through ``SsdScanFunction``); the rest
  of the block is plain PyTorch, which autograd differentiates.  The
  reference sends a call of 2-4 tokens with a state to its one-step
  recurrence, which reads only the first token; the port scans every
  ``S > 1`` (ROADMAP Queue 3).

The recurrent state of a layer is ``{"h", "conv_x", "conv_B", "conv_C"}``:
``h [B, H, N, P]`` float32 and the last ``W - 1`` conv inputs ``[B, W-1,
D]``.  Given a state, the block writes the new one into it in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import SSD_CLIP
from repro_torch.models import layers
from repro_torch.models.config import SSMConfig


def dims(d_model: int, ssm: SSMConfig) -> Tuple[int, int]:
    d_inner = ssm.expand * d_model
    return d_inner, d_inner // ssm.headdim


class Mamba(nn.Module):
    """The mixer's parameters, the reference's leaves; ``A_log``, ``D`` and
    ``dt_bias`` are float32 whatever the model's dtype."""

    def __init__(self, d_model: int, ssm: SSMConfig, norm_eps: float, *,
                 dtype, device):
        super().__init__()
        d_inner, n_heads = dims(d_model, ssm)
        gn, w = ssm.ngroups * ssm.d_state, ssm.conv_width

        def param(*shape, dt=dtype):
            return layers.zeros_param(shape, dt, device)

        self.w_z = param(d_model, d_inner)
        self.w_x = param(d_model, d_inner)
        self.w_B = param(d_model, gn)
        self.w_C = param(d_model, gn)
        self.w_dt = param(d_model, n_heads)
        self.conv_x = param(w, d_inner)
        self.conv_B = param(w, gn)
        self.conv_C = param(w, gn)
        self.A_log = param(n_heads, dt=torch.float32)
        self.D = param(n_heads, dt=torch.float32)
        self.dt_bias = param(n_heads, dt=torch.float32)
        self.norm = layers.RMSNorm(d_inner, norm_eps, dtype=dtype,
                                   device=device)
        self.w_out = param(d_inner, d_model)

    def init_weights(self, generator) -> None:
        """The reference's initialization: ``d ** -0.5`` for the
        in-projections, 0.1 for the convolutions, ``d_inner ** -0.5`` for
        ``w_out``, ``A = -linspace(1, 16)``, ``D = 1``; ``dt_bias`` and the
        norm scale stay zero."""
        d = self.w_z.shape[0]
        for w in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt):
            layers.truncated_normal_(w.data, d ** -0.5, generator)
        for w in (self.conv_x, self.conv_B, self.conv_C):
            layers.truncated_normal_(w.data, 0.1, generator)
        layers.truncated_normal_(self.w_out.data, self.w_out.shape[0] ** -0.5,
                                 generator)
        n = self.A_log.shape[0]
        self.A_log.data.copy_(torch.log(torch.linspace(
            1.0, 16.0, n, dtype=torch.float32, device=self.A_log.device)))
        self.D.data.fill_(1.0)


def _causal_conv(x, conv_w, conv_state=None):
    """Depthwise causal conv over time, x ``[B, S, D]``, conv_w ``[W, D]``,
    in x's dtype; returns (silu(y), the last ``W - 1`` inputs)."""
    w = conv_w.shape[0]
    if conv_state is not None:
        x_ext = torch.cat([conv_state.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, w - 1, 0))
    s = x.shape[1]
    y = x_ext[:, 0:s] * conv_w[0].to(x.dtype)
    for i in range(1, w):
        y = y + x_ext[:, i:i + s] * conv_w[i].to(x.dtype)
    return F.silu(y), x_ext[:, x_ext.shape[1] - (w - 1):]


def ssd_decode_step(xh, dt, A, Bvec, Cvec, h):
    """One token: xh ``[B, 1, H, P]``, dt ``[B, 1, H]`` float32, Bvec, Cvec
    ``[B, 1, G, N]``, h ``[B, H, N, P]`` float32 -> (y ``[B, 1, H, P]`` of
    xh's dtype, new h).  The reference's arithmetic, with ``x dt`` rounded
    to xh's dtype before the float32 update."""
    n_heads = xh.shape[2]
    rep = n_heads // Bvec.shape[2]
    Bh = Bvec[:, 0].repeat_interleave(rep, dim=1).float()   # [B, H, N]
    Ch = Cvec[:, 0].repeat_interleave(rep, dim=1).float()
    dA = torch.exp((dt[:, 0] * A[None, :]).clamp(SSD_CLIP, 0.0))
    x_dt = (xh[:, 0] * dt[:, 0, :, None].to(xh.dtype)).float()
    h_new = h * dA[..., None, None] + Bh[..., :, None] * x_dt[..., None, :]
    y = (Ch[..., :, None] * h_new).sum(dim=2)
    return y[:, None].to(xh.dtype), h_new


def _scan(xh, dt, A, Bmat, Cmat):
    """The chunked scan on the model's layouts: xh ``[B, S, H, P]``, dt
    ``[B, S, H]``, Bmat, Cmat ``[B, S, G, N]`` -> (y ``[B, S, H, P]``, h).
    The kernel reads transposed views; one shared B/C group goes in its
    group layout ``[B, 1, S, N]`` (no copy), which the scan expands over
    the heads with stride 0 and whose gradient the backward kernel sums
    over the heads; several groups are repeated to one per head."""
    g = Bmat.shape[2]
    n_heads = xh.shape[2]

    def per_head(m):
        if g == 1:
            return m.transpose(1, 2)
        return m.repeat_interleave(n_heads // g, dim=2).transpose(1, 2)

    y, h = ops.ssd_scan(xh.transpose(1, 2), dt.transpose(1, 2), A,
                        per_head(Bmat), per_head(Cmat))
    return y.transpose(1, 2), h


def mamba_block(x, params: Mamba, ssm: SSMConfig, *, norm_eps: float,
                state: Optional[dict] = None):
    """x ``[B, S, d_model]`` -> (out, state).  With a state, its leaves are
    overwritten in place with the new state and it is returned; without
    one, returns None.  See the module docstring for which path runs."""
    b, s, d_model = x.shape
    d_inner, n_heads = dims(d_model, ssm)
    g, n, p = ssm.ngroups, ssm.d_state, ssm.headdim
    cd = x.dtype
    z = x @ params.w_z.to(cd)
    xr = x @ params.w_x.to(cd)
    Bm = x @ params.w_B.to(cd)
    Cm = x @ params.w_C.to(cd)
    dt_raw = x @ params.w_dt.to(cd)

    cs = state if state is not None else {}
    xr, new_cx = _causal_conv(xr, params.conv_x, cs.get("conv_x"))
    Bm, new_cb = _causal_conv(Bm, params.conv_B, cs.get("conv_B"))
    Cm, new_cc = _causal_conv(Cm, params.conv_C, cs.get("conv_C"))

    xh = xr.reshape(b, s, n_heads, p)
    Bmat = Bm.reshape(b, s, g, n)
    Cmat = Cm.reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + params.dt_bias[None, None, :])
    A = -torch.exp(params.A_log)

    if state is not None and s == 1:
        y, h_new = ssd_decode_step(xh, dt, A, Bmat, Cmat, state["h"])
    else:
        y, h_new = _scan(xh, dt, A, Bmat, Cmat)

    y = y + xh * params.D[None, None, :, None].to(cd)
    y = y.reshape(b, s, d_inner) * F.silu(z)
    y = layers.rmsnorm(y, params.norm.scale, norm_eps)
    out = y @ params.w_out.to(cd)

    if state is not None:
        state["h"].copy_(h_new)
        for name, new in (("conv_x", new_cx), ("conv_B", new_cb),
                          ("conv_C", new_cc)):
            state[name].copy_(new.to(state[name].dtype))
    return out, state


def init_mamba_state(batch: int, d_model: int, ssm: SSMConfig,
                     dtype=torch.float32, device=None) -> dict:
    d_inner, n_heads = dims(d_model, ssm)
    gn, w = ssm.ngroups * ssm.d_state, ssm.conv_width - 1

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "h": zeros(batch, n_heads, ssm.d_state, ssm.headdim,
                   dt=torch.float32),
        "conv_x": zeros(batch, w, d_inner),
        "conv_B": zeros(batch, w, gn),
        "conv_C": zeros(batch, w, gn),
    }
