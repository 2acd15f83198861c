"""Mamba2 (SSD) block — zamba2's recurrent backbone.

Train/prefill run the selective-state recurrence over the sequence, as a
sequential scan or in chunks (``_mamba2_chunked``); decode carries
(conv_state, ssm_state), O(1) per token.

The reference's ``models/layers/mamba2.py`` in plain PyTorch: a Python
loop over the steps replaces ``jax.lax.scan``, and the casts sit where the
reference's do (the scans and the skip in float32, the output back to
``cfg.dtype``).  The reference's sharding hints are the identity on one
device and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_alloc_device
from repro_torch.models.layers import basic


class Mamba2State(NamedTuple):
    conv: torch.Tensor  # (B, conv_dim, d_conv-1) rolling conv window
    ssm: torch.Tensor  # (B, heads, head_dim, d_state)


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, heads, conv_dim


def init_mamba2(init: basic.ParamInit, cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, heads, conv_dim = _dims(cfg)
    f32 = torch.float32
    return {
        # [z, xBC, dt] fused input projection
        "w_in": init.normal((d, d_inner + conv_dim + heads), cfg.dtype,
                            d ** -0.5),
        "conv_w": init.normal((s.d_conv, conv_dim), cfg.dtype, 0.2),
        "conv_b": init.zeros((conv_dim,), cfg.dtype),
        "a_log": init.zeros((heads,), f32),  # A = -exp(a_log)
        "dt_bias": init.zeros((heads,), f32),
        "d_skip": init.ones((heads,), f32),
        "w_out": init.normal((d_inner, d), cfg.dtype, d_inner ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C); w: (K,C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def mamba2_layer(x: torch.Tensor, p: dict, cfg,
                 state: Mamba2State | None = None
                 ) -> tuple[torch.Tensor, Mamba2State]:
    """x: (B,S,D). state!=None => single-token decode (S==1)."""
    s = cfg.ssm
    d_inner, heads, conv_dim = _dims(cfg)
    b, seq, _ = x.shape
    f32 = torch.float32

    zxbcdt = x @ p["w_in"]
    z, xbc, dt = torch.tensor_split(zxbcdt, [d_inner, d_inner + conv_dim],
                                    dim=-1)

    if state is None:
        # rolling conv window of the final (d_conv-1) raw inputs (prefill
        # handoff)
        new_conv = xbc.transpose(1, 2)[..., -(s.d_conv - 1):]
        xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    else:
        window = torch.cat([state.conv, xbc.transpose(1, 2)], dim=2)
        conv_out = torch.einsum("bck,kc->bc", window.to(cfg.dtype),
                                p["conv_w"]) + p["conv_b"]
        xbc = F.silu(conv_out)[:, None, :]
        new_conv = window[:, :, 1:]

    xs, bs, cs = torch.tensor_split(xbc, [d_inner, d_inner + s.d_state],
                                    dim=-1)
    xs = xs.reshape(b, -1, heads, s.head_dim)
    # jax.nn.softplus is exact; F.softplus returns x itself above 20, an
    # error under 3e-9 there, inside every tolerance the port is held to
    dt = F.softplus(dt.to(f32) + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])  # (H,)
    decay = torch.exp(dt * a)  # (B,S,H)

    def step(h, x_t, b_t, c_t, dec_t, dt_t):
        # h: (B,H,hd,N)
        h = h * dec_t[..., None, None] + \
            (dt_t[..., None] * x_t.to(f32))[..., None] \
            * b_t[:, None, None, :].to(f32)
        y = torch.einsum("bhdn,bn->bhd", h, c_t.to(f32))
        return h, y

    if state is None and s.scan_impl == "chunked" \
            and seq % max(s.chunk, 1) == 0 and seq > 1:
        y, new_ssm = _mamba2_chunked(xs, bs, cs, dt, a, s.chunk)
    elif state is None:
        h = torch.zeros((b, heads, s.head_dim, s.d_state), dtype=f32,
                        device=x.device)
        ys = []
        for t in range(seq):
            h, y_t = step(h, xs[:, t], bs[:, t], cs[:, t], decay[:, t],
                          dt[:, t])
            ys.append(y_t)
        y = torch.stack(ys, dim=1)  # (B,S,H,hd)
        new_ssm = h
    else:
        new_ssm, y1 = step(state.ssm.to(f32), xs[:, 0], bs[:, 0], cs[:, 0],
                           decay[:, 0], dt[:, 0])
        y = y1[:, None]

    y = y + p["d_skip"][:, None] * xs.to(f32)
    y = (y.reshape(b, -1, d_inner) * F.silu(z.to(f32))).to(cfg.dtype)
    out = y @ p["w_out"]
    return out, Mamba2State(conv=new_conv.to(cfg.dtype), ssm=new_ssm)


def _mamba2_chunked(xs, bs, cs, dt, a, chunk: int):
    """Chunked SSD form of the selective-state recurrence.

    Recurrence  h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) (x) b_t ;  y_t = h_t c_t
    is evaluated per chunk of length L: within-chunk terms become a masked
    (L x L) attention-like product and the carried state is materialised
    only at chunk boundaries.

    xs: (B,S,H,hd); bs/cs: (B,S,N); dt: (B,S,H) fp32; a: (H,).
    Returns (y (B,S,H,hd) fp32, h_last (B,H,hd,N) fp32).
    """
    b, seq, h, hd = xs.shape
    n = bs.shape[-1]
    nc, L = seq // chunk, chunk
    f32 = torch.float32

    def shp(t):
        return t.reshape(b, nc, L, *t.shape[2:])

    xs_c = shp(xs.to(f32))
    bs_c = shp(bs.to(f32))
    cs_c = shp(cs.to(f32))
    dt_c = shp(dt)
    logd = dt_c * a  # (B,nc,L,H) log-decay, <= 0
    cum = torch.cumsum(logd, dim=2)  # inclusive within-chunk cumulative
    u = dt_c[..., None] * xs_c  # (B,nc,L,H,hd) dt-scaled inputs

    # intra-chunk: scores shared across heads, decay weights per head
    scores = torch.einsum("bcln,bcsn->bcls", cs_c, bs_c)  # (B,nc,L,L)
    mask = torch.ones((L, L), dtype=torch.bool, device=xs.device).tril()
    # w[t,s] = exp(cum_t - cum_s) for s <= t; above the diagonal exp
    # overflows to inf, which torch.where drops (a 0/1 product would not)
    wlog = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,L,L,H)
    w = torch.where(mask[None, None, :, :, None], torch.exp(wlog), 0.0)
    # "bclsh,bcls,bcshd->bclhd", the scores folded into w first so that the
    # product is one batched matmul over (b, c, h)
    y_intra = torch.einsum("bclsh,bcshd->bclhd", w * scores[..., None], u)

    # chunk-boundary states: h'_c = exp(cumL) h_c + sum_s exp(cumL - cum_s)
    # u_s b_s
    dec_L = torch.exp(cum[:, :, -1])  # (B,nc,H)
    inj = torch.einsum("bcsh,bcshd,bcsn->bchdn",
                       torch.exp(cum[:, :, -1:, :] - cum), u, bs_c)

    hprev = torch.zeros((b, h, hd, n), dtype=f32, device=xs.device)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)  # the state ENTERING the chunk
        hprev = hprev * dec_L[:, c, :, None, None] + inj[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,hd,N) boundary states

    y_inter = torch.einsum("bclh,bcln,bchdn->bclhd", torch.exp(cum), cs_c,
                           h_in)
    y = (y_intra + y_inter).reshape(b, seq, h, hd)
    return y, hprev


def init_mamba2_state(cfg, batch: int,
                      device: torch.device | str = "cuda") -> Mamba2State:
    s = cfg.ssm
    device = resolve_alloc_device(device)  # meta: shapes only
    d_inner, heads, conv_dim = _dims(cfg)
    return Mamba2State(
        conv=torch.zeros((batch, conv_dim, s.d_conv - 1), dtype=cfg.dtype,
                         device=device),
        ssm=torch.zeros((batch, heads, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device),
    )
