"""xLSTM blocks (sLSTM + mLSTM) with optional *spiking* mode.

The spiking mode is the paper's technique applied to this family: the
sLSTM hidden output is binarised by a learnable-threshold LIF-style spike
(surrogate gradient, ``core/lif.py`` ``spike_fn``), so the recurrent
matmul h @ R consumes {0,1} spikes gated by the output gate.

The reference's ``models/layers/xlstm.py`` in plain PyTorch: Python loops
over the steps (and, in the chunked mLSTM, over the chunks) replace
``jax.lax.scan``; gates, scans and stabilisers run in float32 and ``h``
goes back to ``cfg.dtype`` where the reference casts.  The reference's
sharding hints have no counterpart (DTensor places the activations of a
sharded step).  On DTensors the log-sigmoid's backward is written out
(``_logsigmoid``): ``aten.log_sigmoid_backward`` has no sharding strategy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core.device import resolve_alloc_device
from repro_torch.core.lif import spike_fn
from repro_torch.models.layers import basic
from repro_torch.models.layers.mamba2 import _causal_conv

M_INIT = -1e30  # the stabiliser's start, float32


class _LogSigmoid(torch.autograd.Function):
    """``F.logsigmoid`` with its backward in the formula of ATen's
    ``log_sigmoid_backward`` kernels, op by op in float32 (their
    arithmetic type): g (1 - q) where x < 0, g q elsewhere, q = z / (1 +
    z), z = exp(-|x|) as the CPU forward buffers it (the CUDA kernel
    computes it again, as here when the buffer is empty)."""

    @staticmethod
    def forward(ctx, x):
        out, buffer = torch.ops.aten.log_sigmoid_forward(x)
        ctx.save_for_backward(x, buffer)
        return out

    @staticmethod
    def backward(ctx, g):
        x, z = ctx.saved_tensors
        x = x.float()
        local = z.to_local() if isinstance(z, DTensor) else z
        z = z.float() if local.numel() else torch.exp(-x.abs())
        q = z / (1 + z)
        return (g.float() * torch.where(x < 0, 1 - q, q)).to(g.dtype)


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid(x)``; on a DTensor through ``_LogSigmoid``, whose
    backward has sharding strategies where ``aten.log_sigmoid_backward``
    has none.  The forward is the same op either way."""
    return _LogSigmoid.apply(x) if isinstance(x, DTensor) else \
        F.logsigmoid(x)


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, d_qk, d_v) matrix memory
    n: torch.Tensor  # (B, H, d_qk)
    m: torch.Tensor  # (B, H) stabiliser
    conv: torch.Tensor  # (B, d_inner, 3) rolling conv window (raw xm inputs)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, hd)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor  # (B, H, hd) stabiliser


def _mlstm_dims(cfg) -> tuple[int, int, int, int]:
    """(heads, d_inner, d_v, d_qk)."""
    h = cfg.num_heads
    d_inner = 2 * cfg.d_model
    d_v = d_inner // h
    return h, d_inner, d_v, d_v // 2


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(init: basic.ParamInit, cfg) -> dict:
    d = cfg.d_model
    h, d_inner, d_v, d_qk = _mlstm_dims(cfg)
    s = d ** -0.5
    si = d_inner ** -0.5
    dt, f32 = cfg.dtype, torch.float32
    return {
        "w_up": init.normal((d, 2 * d_inner), dt, s),
        "conv_w": init.normal((4, d_inner), dt, 0.2),
        "conv_b": init.zeros((d_inner,), dt),
        "w_q": init.normal((d_inner, h * d_qk), dt, si),
        "w_k": init.normal((d_inner, h * d_qk), dt, si),
        "w_v": init.normal((d_inner, h * d_v), dt, si),
        "w_if": init.normal((d_inner, 2 * h), f32, si),
        "b_if": torch.cat([init.zeros((h,), f32),
                           init.ones((h,), f32).mul_(3.0)], dim=-1),
        "w_o": init.normal((d_inner, d_inner), dt, si),
        "w_down": init.normal((d_inner, d), dt, si),
    }


def _mlstm_step(carry: MLSTMState, q, k, v, i_t, f_t
                ) -> tuple[MLSTMState, torch.Tensor]:
    """q,k: (B,H,dqk); v: (B,H,dv); gates: (B,H)."""
    m_new = torch.maximum(f_t + carry.m, i_t)
    i = torch.exp(i_t - m_new)
    f = torch.exp(f_t + carry.m - m_new)
    c = carry.c * f[..., None, None] + \
        i[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = carry.n * f[..., None] + i[..., None] * k
    num = torch.einsum("bhqv,bhq->bhv", c, q)
    # stabilised normaliser: true-units threshold 1 becomes exp(-m) in the
    # stabilised representation (xLSTM eq. 15)
    den = torch.maximum(torch.einsum("bhq,bhq->bh", n, q).abs(),
                        torch.exp(-m_new))
    h_out = num / den[..., None]
    return MLSTMState(c=c, n=n, m=m_new, conv=carry.conv), h_out


def mlstm_block(x: torch.Tensor, p: dict, cfg,
                state: MLSTMState | None = None
                ) -> tuple[torch.Tensor, MLSTMState]:
    b, seq, d = x.shape
    h, d_inner, d_v, d_qk = _mlstm_dims(cfg)
    f32 = torch.float32

    up = x @ p["w_up"]
    xm, z = up.chunk(2, dim=-1)
    if state is None:
        new_conv = xm.transpose(1, 2)[..., -3:]  # prefill handoff
        xc = F.silu(_causal_conv(xm, p["conv_w"], p["conv_b"]))
    else:
        window = torch.cat([state.conv, xm.transpose(1, 2)], dim=2)
        conv_out = torch.einsum("bck,kc->bc", window.to(xm.dtype),
                                p["conv_w"]) + p["conv_b"]
        xc = F.silu(conv_out)[:, None, :]
        new_conv = window[:, :, 1:]
    q = (xc @ p["w_q"]).reshape(b, seq, h, d_qk) * d_qk ** -0.5
    k = (xc @ p["w_k"]).reshape(b, seq, h, d_qk) * d_qk ** -0.5
    v = (xc @ p["w_v"]).reshape(b, seq, h, d_v)
    gates = xc.to(f32) @ p["w_if"] + p["b_if"]
    i_t, f_t = gates.reshape(b, seq, 2 * h).chunk(2, dim=-1)
    f_t = _logsigmoid(f_t)

    ssm = cfg.ssm
    chunk = ssm.chunk if ssm else 128
    impl = ssm.scan_impl if ssm else "chunked"
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    if state is None and impl == "chunked" and seq % max(chunk, 1) == 0 \
            and seq > 1:
        h_seq, last = _mlstm_chunked(q, k, v, i_t, f_t, chunk,
                                     init_mlstm_state(cfg, b, x.device))
    elif state is None:
        last = init_mlstm_state(cfg, b, x.device)._replace(conv=new_conv)
        hs = []
        for t in range(seq):
            last, h_t = _mlstm_step(last, q[:, t], k[:, t], v[:, t],
                                    i_t[:, t], f_t[:, t])
            hs.append(h_t)
        h_seq = torch.stack(hs, dim=1)  # (B,S,H,dv)
    else:
        last, h1 = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], i_t[:, 0],
                               f_t[:, 0])
        h_seq = h1[:, None]
    new_state = last._replace(conv=new_conv.to(last.conv.dtype))

    h_flat = h_seq.reshape(b, -1, d_inner).to(cfg.dtype)
    o = torch.sigmoid(xc @ p["w_o"])
    out = (h_flat * o * F.silu(z)) @ p["w_down"]
    return out, new_state


def init_mlstm_state(cfg, batch: int,
                     device: torch.device | str = "cuda") -> MLSTMState:
    h, d_inner, d_v, d_qk = _mlstm_dims(cfg)
    device = resolve_alloc_device(device)  # meta: shapes only
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, h, d_qk, d_v), dtype=f32, device=device),
        n=torch.zeros((batch, h, d_qk), dtype=f32, device=device),
        m=torch.full((batch, h), M_INIT, dtype=f32, device=device),
        conv=torch.zeros((batch, d_inner, 3), dtype=cfg.dtype,
                         device=device),
    )


def _mlstm_chunked(q, k, v, i_t, f_t, chunk: int, state0: MLSTMState
                   ) -> tuple[torch.Tensor, MLSTMState]:
    """Chunkwise-parallel stabilised mLSTM.

    The matrix memory C is materialised only at chunk boundaries; the
    within-chunk contribution is a masked (L x L) attention-like product.
    The running stabiliser m of the sequential form equals
    max(cumf_t + m0, max_{s<=t}(cumf_t - cumf_s + i_s)), computed here in
    closed form, so chunked == sequential up to float association.

    q/k: (B,S,H,dqk) pre-scaled; v: (B,S,H,dv); i_t/f_t: (B,S,H) with f_t
    already log-sigmoided. Emits h (B,S,H,dv) and the final boundary state.
    """
    b, seq, h, dqk = q.shape
    dv = v.shape[-1]
    nc, L = seq // chunk, chunk

    def shp(t):
        return t.reshape(b, nc, L, *t.shape[2:])

    qc, kc, vc = shp(q), shp(k), shp(v)
    ic, fc = shp(i_t), shp(f_t)
    cumf = torch.cumsum(fc, dim=2)  # (B,nc,L,H) inclusive
    mask3 = torch.ones((L, L), dtype=torch.bool,
                       device=q.device).tril()[None, :, :, None]

    c0, n0, m0 = state0.c, state0.n, state0.m
    hs = []
    for j in range(nc):
        qx, kx, vx = qc[:, j], kc[:, j], vc[:, j]
        icx, cumfx = ic[:, j], cumf[:, j]
        # intra log-weights w[t,s] = cumf_t - cumf_s + i_s (s <= t)
        wlogx = cumfx[:, :, None, :] - cumfx[:, None, :, :] \
            + icx[:, None, :, :]
        wlogx = torch.where(mask3, wlogx, -torch.inf)
        # per-position stabiliser: max over intra terms and the boundary
        m_intra = wlogx.amax(dim=2)  # (B,L,H) max over s
        m_bound = cumfx + m0[:, None, :]
        m_t = torch.maximum(m_intra, m_bound)
        aw = torch.exp(wlogx - m_t[:, :, None, :])  # (B,L,L,H)
        qk = torch.einsum("blhd,bshd->blsh", qx, kx)
        h_num = torch.einsum("blsh,bshv->blhv", aw * qk, vx)
        n_t = torch.einsum("blsh,bshd->blhd", aw, kx)  # intra normaliser
        # boundary contribution
        bscale = torch.exp(m_bound - m_t)  # (B,L,H)
        h_num = h_num + torch.einsum("blh,blhd,bhdv->blhv", bscale, qx, c0)
        n_t = n_t + bscale[..., None] * n0[:, None, :, :]
        den = torch.maximum(torch.einsum("blhd,blhd->blh", qx, n_t).abs(),
                            torch.exp(-m_t))
        hs.append(h_num / den[..., None])
        # --- boundary state update ---------------------------------------
        cl = cumfx[:, -1]  # (B,H)
        m_new = torch.maximum(cl + m0,
                              (cl[:, None] - cumfx + icx).amax(dim=1))
        inj = torch.exp(cl[:, None] - cumfx + icx - m_new[:, None])  # (B,L,H)
        carry = torch.exp(cl + m0 - m_new)
        c0 = carry[..., None, None] * c0 + \
            torch.einsum("blh,blhd,blhv->bhdv", inj, kx, vx)
        n0 = carry[..., None] * n0 + torch.einsum("blh,blhd->bhd", inj, kx)
        m0 = m_new
    h_seq = torch.stack(hs, dim=1).reshape(b, seq, h, dv)
    return h_seq, MLSTMState(c=c0, n=n0, m=m0, conv=state0.conv)


# ---------------------------------------------------------------------------
# sLSTM (optionally spiking)
# ---------------------------------------------------------------------------


def init_slstm(init: basic.ParamInit, cfg) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    s = d ** -0.5
    f_up = int(d * 4 / 3)
    f32 = torch.float32
    # the reference draws w_ff_gate and w_ff_up from one key, so they start
    # equal: one draw here, used for both
    w_ff = init.normal((d, f_up), cfg.dtype, s)
    return {
        "w_gates": init.normal((d, 4 * d), f32, s),
        "r_gates": init.normal((h, hd, 4 * hd), f32, hd ** -0.5),
        "b_gates": init.zeros((4 * d,), f32),
        "w_ff_gate": w_ff,
        "w_ff_up": w_ff.clone(),
        "w_ff_down": init.normal((f_up, d), cfg.dtype, f_up ** -0.5),
        "vth": init.ones((d,), f32),  # spiking-mode threshold
    }


def _slstm_step_fn(p, cfg):
    h = cfg.num_heads
    hd = cfg.d_model // h

    def step(carry: SLSTMState, wx_t) -> tuple[SLSTMState, torch.Tensor]:
        # recurrent contribution from previous hidden (possibly spikes)
        rh = torch.einsum("bhd,hde->bhe", carry.h, p["r_gates"])  # (B,H,4hd)
        g = wx_t.reshape(*wx_t.shape[:-1], h, 4 * hd) + rh
        z_t, i_t, f_t, o_t = g.chunk(4, dim=-1)
        f_log = _logsigmoid(f_t)
        m_new = torch.maximum(f_log + carry.m, i_t)
        i = torch.exp(i_t - m_new)
        f = torch.exp(f_log + carry.m - m_new)
        c = f * carry.c + i * torch.tanh(z_t)
        n = f * carry.n + i
        membrane = c / torch.clamp(n, min=1e-6)
        if cfg.spiking:
            vth = p["vth"].reshape(h, hd)
            h_new = spike_fn(membrane, vth) * torch.sigmoid(o_t)
        else:
            h_new = torch.sigmoid(o_t) * membrane
        return SLSTMState(c=c, n=n, h=h_new, m=m_new), h_new

    return step


def slstm_block(x: torch.Tensor, p: dict, cfg,
                state: SLSTMState | None = None
                ) -> tuple[torch.Tensor, SLSTMState]:
    b, seq, d = x.shape
    wx = x.to(torch.float32) @ p["w_gates"] + p["b_gates"]
    step = _slstm_step_fn(p, cfg)
    if state is None:
        last = init_slstm_state(cfg, b, x.device)
        hs = []
        for t in range(seq):
            last, h_t = step(last, wx[:, t])
            hs.append(h_t)
        h_seq = torch.stack(hs, dim=1)
    else:
        last, h1 = step(state, wx[:, 0])
        h_seq = h1[:, None]
    h_flat = h_seq.reshape(b, -1, d).to(cfg.dtype)
    ff = (F.silu(h_flat @ p["w_ff_gate"]) * (h_flat @ p["w_ff_up"])) \
        @ p["w_ff_down"]
    return ff, last  # the final recurrent state (prefill handoff)


def init_slstm_state(cfg, batch: int,
                     device: torch.device | str = "cuda") -> SLSTMState:
    h = cfg.num_heads
    hd = cfg.d_model // h
    device = resolve_alloc_device(device)  # meta: shapes only
    z = torch.zeros((batch, h, hd), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z,
                      m=torch.full((batch, h, hd), M_INIT,
                                   dtype=torch.float32, device=device))
