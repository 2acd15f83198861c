"""The benchmark's inputs, made from ``--seed``: weights and speech features.

Both sides of the comparison get these and nothing else: the program as an
artifact that ``bench/program.py`` writes from them, the reference as they
are.  Everything is drawn with a ``torch.Generator`` on the run's device in
a few large calls, so a run makes its model and its feature pool in well
under a second; the same seed on the same kind of device gives the same
inputs.

The features follow the TIMIT-shaped generator of the port's
``data/synthetic.py`` (``TimitLikeStream``): 40-dim fbank-like frames made
of phone segments of 3-18 frames, each a phone prototype plus a linear
delta across the segment, plus Gaussian noise, so that the spike activity
is that of structured speech and not of white noise.  Here one long
segment sequence is drawn for the whole pool and cut into utterances, which
vectorises the draw; a segment may run across an utterance boundary.

Every seed gets the same multiset of utterance lengths (evenly spaced over
the traffic's range) in another order, so two seeds differ in content and
order and not in the amount of work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PHONES = 48  # latent phone inventory
MIN_SEG, MAX_SEG = 3, 18  # frames a phone segment
DELTA = 0.15  # scale of a phone's delta across its segment
NOISE = 0.35  # feature noise
INT4_MAX = 7  # symmetric int4 per-channel quantization: q in [-8, 7]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of the run's streams of draws
    (0: weights, 1: features), from any whole-number seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)
    return g


def layer_shapes(cfg: dict) -> dict[str, tuple[int, int]]:
    """The five weight matrices of the RSNN (paper Table I)."""
    d, h, n = cfg["input_dim"], cfg["hidden_dim"], cfg["fc_dim"]
    return {"l0_wx": (d, h), "l0_wh": (h, h), "l1_wx": (h, h),
            "l1_wh": (h, h), "fc_w": (h, n)}


def _uniform(g: torch.Generator, shape, half_width: float, device
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return (2.0 * u - 1.0) * half_width


def int4_weights(cfg: dict, seed: int, device) -> dict:
    """The stored int4 model: for each layer ``(q, scale, keep)``, ``q``
    int8 (K, N) in [-8, 7], ``scale`` float32 (N,) (per output channel,
    max-abs / 7, round half to even), ``keep`` the FC's pruning mask (a
    fraction ``fc_prune_fraction`` dropped at random, ``q`` zero there) and
    None elsewhere; and ``lif``: ``beta0``, ``vth0``, ``beta1``, ``vth1``
    float32 (H,), beta drawn from the configuration's choices."""
    a = cfg["assumed"]
    g = generator(seed, 0, device)
    layers = {}
    for name, shape in layer_shapes(cfg).items():
        w = _uniform(g, shape, a["weight_half_width"][name], device)
        scale = torch.clamp(w.abs().amax(dim=0), min=1e-12) / INT4_MAX
        q = torch.clamp(torch.round(w / scale), -INT4_MAX - 1, INT4_MAX)
        keep = None
        if name == "fc_w":
            keep = torch.rand(shape, generator=g, device=device) \
                >= cfg["fc_prune_fraction"]
            q = torch.where(keep, q, 0.0)
        layers[name] = (q.to(torch.int8), scale, keep)
    h = cfg["hidden_dim"]
    choices = torch.tensor(a["beta_choices"], dtype=torch.float32,
                           device=device)
    lif = {}
    for i in (0, 1):
        pick = torch.randint(0, len(a["beta_choices"]), (h,), generator=g,
                             device=device)
        lif[f"beta{i}"] = choices[pick]
        lif[f"vth{i}"] = torch.full((h,), float(a["vth"]),
                                    dtype=torch.float32, device=device)
    return {"layers": layers, "lif": lif}


def float_weights(cfg: dict, seed: int, device) -> dict:
    """The float32 model: each layer uniform of its half-width, and the LIF
    parameters in their learnable form, ``raw_beta = logit(beta)`` and
    ``raw_vth = softplus^-1(vth)`` (computed in double, rounded once)."""
    a = cfg["assumed"]
    g = generator(seed, 0, device)
    layers = {name: _uniform(g, shape, a["weight_half_width"][name], device)
              for name, shape in layer_shapes(cfg).items()}
    h = cfg["hidden_dim"]
    beta, vth = float(a["beta"]), float(a["vth"])
    raw_beta = math.log(beta / (1.0 - beta))
    raw_vth = math.log(math.expm1(vth))
    lif = {}
    for i in (0, 1):
        lif[f"raw_beta{i}"] = torch.full((h,), raw_beta, dtype=torch.float32,
                                         device=device)
        lif[f"raw_vth{i}"] = torch.full((h,), raw_vth, dtype=torch.float32,
                                        device=device)
    return {"layers": layers, "lif": lif}


def weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's model at its stated precision."""
    if cfg["precision"] == "int4":
        return int4_weights(cfg, seed, device)
    if cfg["precision"] == "float32":
        return float_weights(cfg, seed, device)
    raise ValueError(f"unknown precision {cfg['precision']!r}")


def lengths(count: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """``count`` utterance lengths in frames: the same evenly spaced
    multiset over [lo, hi] for every seed, in the seed's order."""
    span = hi - lo + 1
    base = lo + (np.arange(count) * span) // count
    rng = np.random.default_rng([int(seed) % 2 ** 63, 2])
    return rng.permutation(base).astype(np.int64)


def feature_pool(lens: np.ndarray, input_dim: int, seed: int, device
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Features for utterances of ``lens`` frames: (frames (sum(lens),
    input_dim) float32 on the host, offsets (len(lens) + 1,)); utterance
    k is ``frames[offsets[k]:offsets[k + 1]]``."""
    total = int(lens.sum())
    g = generator(seed, 1, device)
    proto = torch.randn((PHONES, input_dim), generator=g, device=device)
    delta = DELTA * torch.randn((PHONES, input_dim), generator=g,
                                device=device)
    nseg = total // MIN_SEG + 1  # enough segments to cover every frame
    seg = torch.randint(MIN_SEG, MAX_SEG + 1, (nseg,), generator=g,
                        device=device)
    phone = torch.randint(0, PHONES, (nseg,), generator=g, device=device)
    ends = torch.cumsum(seg, 0)
    t = torch.arange(total, device=device)
    sid = torch.searchsorted(ends, t, right=True)
    pos = ((t - (ends - seg)[sid]).to(torch.float32)
           / (seg[sid] - 1).to(torch.float32))
    ph = phone[sid]
    x = proto[ph] + pos[:, None] * delta[ph]
    x += NOISE * torch.randn((total, input_dim), generator=g, device=device)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return x.cpu().numpy(), offsets


def input_scale(frames: np.ndarray, bits: int = 8) -> np.float32:
    """The static 8-bit input scale: the pool's max-abs over 2^(bits-1) - 1,
    in float32."""
    amax = np.float32(max(float(np.abs(frames).max()), 1e-8))
    return np.float32(amax / np.float32(2 ** (bits - 1) - 1))
