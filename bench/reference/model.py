"""The plain RSNN reference: the paper's frame step in plain PyTorch.

Two recurrent spiking layers of leaky integrate-and-fire neurons at TS
time steps a frame, and the merged-spike FC readout (paper Fig. 1, Eq.
2-3, §II-D2), over the weights that ``data.py`` drew:

    x_q   = clamp(round(x / scale), -2^(b-1), 2^(b-1) - 1)   (8-bit input)
    U0[ts] = x_q W0x + S0[t-1][ts] W0h + beta0 U0[ts-1] (1 - S0[ts-1])
    S0[ts] = 1[U0[ts] >= vth0]
    U1[ts] = S0[ts] W1x + S1[t-1][ts] W1h + beta1 U1[ts-1] (1 - S1[ts-1])
    S1[ts] = 1[U1[ts] >= vth1]
    logits = (sum_ts S1[ts]) Wfc

where U[-1] and S[-1] of a frame are the last time step of the previous
frame, and every stream starts from zero state.  The int4 weights are
dequantized here from the stored integers and scales (``q * scale``, the
pruned FC entries zero), the float model's LIF constants are worked out
from their learnable form (``beta = sigmoid(raw_beta)``, ``vth =
softplus(raw_vth)``).  Nothing here imports or reads the program.

``precision="exact"`` computes in float64: the truth the program's
float32 arithmetic is held against.  ``precision="tf32"`` is the control:
the same step in float32 with every weight rounded to TF32 (10 explicit
mantissa bits) before its products, as the tensor cores' TF32 mode rounds
its operands; the 8-bit inputs and the spikes are exact in TF32.

``Reference.frames`` steps a batch of streams frame by frame and yields
each frame's logits with the magnitude sum of their terms (``merged |W|``),
which sets the comparison's tolerance, and counts the multiply-accumulates
the frame's inputs need at the stored nonzero weights (the zero-skipping
dataflow's work: nonzero inputs and spikes times the nonzero weights of
their rows), from which ``counts.py`` takes the kernel's operations.

It also marks the streams that reach a threshold tie: a membrane potential
within ``TIE`` float32 roundings of its threshold, ``|U - vth| <= TIE *
2^-24 * (A + vth)``, where ``A`` is the magnitude of U's terms with its
leaked history (``A[ts] = |x_q| |W0x| + S0[t-1] |W0h| + beta (1 - S)
(|U[ts-1]| + A[ts-1])``, and alike for L1).  There float32 arithmetic in
any order may take either side of the threshold, and the stream may run
apart from the truth from then on without any fault.  An int4 model makes
such ties common on some draws: a neuron's integer sums of spike-driven
inputs, times its two column scales, can land within a few float32
roundings of 1.0, and every stream that reaches those sums ties.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import data

PRECISIONS = ("exact", "tf32")
# a threshold tie: |U - vth| within TIE float32 roundings (2^-24) of the
# magnitude of U's terms; sound runs' spike flips lie within 0.2 of them
TIE = 4.0


def quantize(x: torch.Tensor, scale, bits: int = 8) -> torch.Tensor:
    """Symmetric fixed-point quantization of float32 ``x`` at the static
    ``scale``: ``round(x / scale)`` (float32 division, round half to even)
    clamped to the signed ``bits``-bit range; float32 integers."""
    s = torch.as_tensor(np.float32(scale), dtype=torch.float32,
                        device=x.device)
    qmax = 2.0 ** (bits - 1) - 1
    return torch.clamp(torch.round(x.to(torch.float32) / s), -qmax - 1, qmax)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (the low 13 mantissa bits dropped,
    round half to even)."""
    i = t.to(torch.float32).view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


class Reference:
    """The reference model of one configuration on ``device``."""

    def __init__(self, cfg: dict, model: dict, precision: str = "exact",
                 device="cpu"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.precision = precision
        self.device = torch.device(device)
        self.dtype = torch.float64 if precision == "exact" else torch.float32
        dev, f64 = self.device, torch.float64
        w, nnz = {}, {}
        for name in data.layer_shapes(cfg):
            if cfg["precision"] == "int4":
                q, scale, _ = model["layers"][name]
                q = q.to(dev, f64)
                scale = scale.to(dev, f64)
                nnz[name] = (q != 0).sum(dim=1).to(f64)
                w[name] = q * scale if precision == "exact" else \
                    to_tf32((q * scale).to(torch.float32))
            else:
                m = model["layers"][name].to(dev, torch.float32)
                nnz[name] = (m != 0).sum(dim=1).to(f64)
                w[name] = m.to(f64) if precision == "exact" else to_tf32(m)
        self.w = w
        self.abs_w = {k: v.abs() for k, v in w.items()}
        # after each frame that ``frames`` yields: (B,) bool, the streams
        # that reached a threshold tie at that frame or before
        self.tied = None
        self.row_nnz = nnz  # stored nonzero weights of each input row
        self.abs_fc = w["fc_w"].abs()
        lif = model["lif"]
        self.beta, self.vth = [], []
        for i in (0, 1):
            if cfg["precision"] == "int4":
                beta = lif[f"beta{i}"].to(dev, f64)
                vth = lif[f"vth{i}"].to(dev, f64)
            else:
                raw_b = lif[f"raw_beta{i}"].to(dev, f64)
                raw_v = lif[f"raw_vth{i}"].to(dev, f64)
                beta = torch.sigmoid(raw_b)
                vth = torch.logaddexp(raw_v, torch.zeros_like(raw_v))
            self.beta.append(beta.to(self.dtype))
            self.vth.append(vth.to(self.dtype))

    def frames(self, streams: list[np.ndarray], scale):
        """Run the ``streams`` (each (T, input_dim) raw float32 features)
        side by side from zero state.  Yields, for each frame t of the
        longest, ``(t, live, logits, magnitude, macs)``: ``live`` (B,) bool
        the streams that have a frame t, ``logits`` and ``magnitude`` (B,
        fc_dim) float64 on the device (``magnitude`` the sum of the
        logit's terms' absolute values), ``macs`` (B,) the frame's
        multiply-accumulates at the stored nonzero weights (0 where not
        live); ``self.tied`` then marks the streams that have reached a
        threshold tie (module docstring) at frame t or before."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        b, h, ts = len(streams), cfg["hidden_dim"], cfg["num_ts"]
        lens = np.array([len(s) for s in streams])
        steps = int(lens.max()) if b else 0
        x = np.zeros((steps, b, cfg["input_dim"]), np.float32)
        for i, s in enumerate(streams):
            x[:len(s), i] = s
        xq_all = quantize(torch.from_numpy(x).to(dev), scale,
                          cfg["input_bits"])
        lens_t = torch.from_numpy(lens).to(dev)
        w, nnz, aw = self.w, self.row_nnz, self.abs_w
        beta0, beta1 = self.beta
        vth0, vth1 = self.vth
        zeros = torch.zeros((b, h), dtype=dt, device=dev)
        s0_prev = torch.zeros((ts, b, h), dtype=dt, device=dev)
        s1_prev = torch.zeros((ts, b, h), dtype=dt, device=dev)
        u0, h0, u1, h1 = zeros, zeros, zeros, zeros
        a0, a1 = zeros, zeros  # the magnitudes of U0's and U1's terms
        tied = torch.zeros(b, dtype=torch.bool, device=dev)
        band = TIE * 2.0 ** -24

        def ties(u, a, vth):
            return ((u - vth).abs() <= band * (a + vth)).any(dim=1)

        for t in range(steps):
            live = lens_t > t
            xq = xq_all[t].to(dt)
            ff0 = xq @ w["l0_wx"]
            aff0 = xq.abs() @ aw["l0_wx"]
            s0 = []
            tie = torch.zeros_like(tied)
            for k in range(ts):
                a0 = (aff0 + s0_prev[k] @ aw["l0_wh"]
                      + beta0 * (1.0 - h0) * (u0.abs() + a0))
                u0 = (ff0 + s0_prev[k] @ w["l0_wh"]) + beta0 * u0 * (1.0 - h0)
                h0 = (u0 >= vth0).to(dt)
                s0.append(h0)
                tie |= ties(u0, a0, vth0)
            s0 = torch.stack(s0)
            s1 = []
            for k in range(ts):
                a1 = (s0[k] @ aw["l1_wx"] + s1_prev[k] @ aw["l1_wh"]
                      + beta1 * (1.0 - h1) * (u1.abs() + a1))
                u1 = ((s0[k] @ w["l1_wx"] + s1_prev[k] @ w["l1_wh"])
                      + beta1 * u1 * (1.0 - h1))
                h1 = (u1 >= vth1).to(dt)
                s1.append(h1)
                tie |= ties(u1, a1, vth1)
            s1 = torch.stack(s1)
            tied = tied | (tie & live)
            self.tied = tied
            merged = s1.sum(dim=0)
            logits = (merged @ w["fc_w"]).to(torch.float64)
            magnitude = merged.to(torch.float64) @ self.abs_fc.to(
                torch.float64)
            f64 = torch.float64
            macs = ((xq != 0).to(f64) @ nnz["l0_wx"]
                    + (s0_prev.to(f64) @ nnz["l0_wh"]).sum(dim=0)
                    + (s0.to(f64) @ nnz["l1_wx"]).sum(dim=0)
                    + (s1_prev.to(f64) @ nnz["l1_wh"]).sum(dim=0)
                    + (merged != 0).to(f64) @ nnz["fc_w"])
            yield t, live, logits, magnitude, torch.where(live, macs, 0.0)
            s0_prev, s1_prev = s0, s1


def dense_macs_per_frame(cfg: dict) -> float:
    """Multiply-accumulates of one frame of the dense model at the
    configuration's published shapes and stored FC density: the L0
    feed-forward product once a frame, the three hidden products at each
    time step, and the merged-spike FC once a frame over its kept
    weights."""
    d, h, n, ts = (cfg["input_dim"], cfg["hidden_dim"], cfg["fc_dim"],
                   cfg["num_ts"])
    keep = 1.0 - cfg.get("fc_prune_fraction", 0.0)
    return float(d * h + 3 * ts * h * h + h * n * keep)
