"""``chip_smoke.py``'s u rule, on the CPU.

K1 (``rsnn_cell``), K10 (``spike_cell``) and K6/K7 (``megastep``) are held
on the card to a bound derived from float32 arithmetic: the plain chain is
replayed in float64 with the magnitude ``A`` of its summands, and both the
kernel and its plain version must satisfy ``|u32 - u64| <= (n + 3) 2^-24
A`` (``chip_smoke.gamma``), a spike differing from the replay's only
where ``|u64 - vth|`` is within that bound.  Here the plain float32
versions stand in for the kernels: they pass the rule on seeded inputs
(no false alarm), and two planted errors fail it — one dropped product,
and a u off by 1e-3.  The float64 replay equals the plain chain run in
float64.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from test_torch_compression import _chip_smoke

CS = _chip_smoke()
TS_, B, D, H, N, F = 2, 32, 8, 24, 12, 3


def _cell_args(seed: int, broadcast: bool):
    """K1's operands: 0/1 trains, a stimulus broadcast over TS (the L0
    call) or dense, random carries, beta in [0.5, 0.95], vth in [0.5, 1.5];
    a stimulus and weights that bring potentials near and across the
    threshold."""
    g = torch.Generator().manual_seed(seed)
    s = (torch.rand((TS_, B, H), generator=g) < 0.3).float()
    stim = torch.randn((1 if broadcast else TS_, B, H), generator=g) * 0.8
    return (stim.expand(TS_, B, H), s,
            torch.randn((H, H), generator=g) * 0.3,
            torch.randn((B, H), generator=g),
            (torch.rand((B, H), generator=g) < 0.3).float(),
            0.5 + 0.45 * torch.rand(H, generator=g),
            0.5 + torch.rand(H, generator=g))


def _mega_args(seed: int, fc_mode: str):
    """K6's operands at small widths over ``F`` frames, float weights and
    the ``dense_float`` FC, or int4 weights and the ``dense_int4`` FC."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    params = {f"params['{n}']": rng.uniform(-a, a, s).astype(np.float32)
              for n, a, s in (("l0_wx", 0.1, (D, H)), ("l0_wh", 0.3, (H, H)),
                              ("l1_wx", 0.4, (H, H)), ("l1_wh", 0.3, (H, H)),
                              ("fc_w", 0.3, (H, N)))}
    if fc_mode == "dense_float":
        state = (t(rng.integers(-128, 128, (F, B, D)).astype(np.float32)),)
        s = lambda *sh: t((rng.random(sh) < 0.3).astype(np.float32))  # noqa
        r = lambda *sh: t(rng.standard_normal(sh, dtype=np.float32))  # noqa
        lif = tuple(t(v) for _ in range(2) for v in (
            0.5 + 0.45 * rng.random(H, dtype=np.float32),
            0.5 + rng.random(H, dtype=np.float32)))
        w = tuple(t(params[f"params['{n}']"]) for n in CS.LAYERS)
        return (*state, s(TS_, B, H), r(B, H), s(B, H), s(TS_, B, H),
                r(B, H), s(B, H), *lif, w[:4], (w[4],))
    return CS.megastep_edge_args(params, fc_mode, B, H, TS_, N, F, rng,
                                 "cpu")


def _check_k1(args, got, want, capacity=None, name="rsnn_cell"):
    errs = {}
    CS.check_call(name, got, want, args, capacity, errs)
    return errs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("broadcast", [True, False])
def test_plain_cell_chains_pass_the_rule(seed, broadcast):
    args = _cell_args(seed, broadcast)
    want = ref.rsnn_cell_ref(*args)
    errs = _check_k1(args, want, want)
    ratio = errs["rsnn_cell |du|/(2^-24 A)"]
    assert 0.0 <= ratio <= H + 5
    cut = ref.spike_cell_ref(*args, 4)
    errs = _check_k1(args, cut, cut, 4, "spike_cell")
    assert errs["spike_cell plain |du|/(2^-24 A)"] <= H + 5


def _dropped_product(args):
    """The plain K1 with one product left out of one element's sum: the
    active event with the largest |w| in the first train row."""
    stim, s, w, *cell = args
    k = int(torch.nonzero(s[0, 0])[0])
    j = int(torch.argmax(w[k].abs()))
    stim = stim.clone()
    stim[0, 0, j] -= w[k, j]  # the sum without s[0, 0, k] * w[k, j]
    return ref.rsnn_cell_ref(stim, s, w, *cell)


@pytest.mark.parametrize("plant", ["dropped_product", "u_off_1e-3"])
@pytest.mark.parametrize("who", ["kernel", "plain"])
def test_planted_cell_errors_fail_the_rule(plant, who):
    args = _cell_args(0, False)
    want = ref.rsnn_cell_ref(*args)
    if plant == "dropped_product":
        bad = _dropped_product(args)
    else:
        near = (CS.lif_trace(args[0], torch.matmul(args[1], args[2]),
                             *args[3:]) - args[6]).abs().amin(dim=0)
        i = np.unravel_index(int(torch.argmax(near)), near.shape)
        u = want[1].clone()
        u[i] += 1e-3
        bad = (want[0], u)
    got, plain = (bad, want) if who == "kernel" else (want, bad)
    with pytest.raises(AssertionError, match="u rule|spike differs"):
        _check_k1(args, got, plain)


@pytest.mark.parametrize("fc_mode", ["dense_float", "dense_int4", "csc"])
@pytest.mark.parametrize("spike", [False, True])
def test_plain_megastep_chains_pass_the_rule(fc_mode, spike):
    args = _mega_args(5, fc_mode)
    plain = CS.megastep_pair(fc_mode, spike)[1]
    want = plain(*args)
    rep = CS.megastep_replay(args)
    assert not bool(rep.near.all())
    errs = {}
    CS.check_mega("megastep", want, want, rep, fc_mode == "dense_float",
                  errs, "row")
    for key in ("row u0 |du|/(2^-24 A)", "row u1 |du|/(2^-24 A)"):
        assert 0.0 <= errs[key] <= D + H + 4
    if fc_mode == "dense_float":
        assert errs["row logits |du|/(2^-24 A)"] <= TS_ * H + 3


@pytest.mark.parametrize("plant", ["dropped_product", "u_off_1e-3",
                                   "logit_off_1e-3"])
def test_planted_megastep_errors_fail_the_rule(plant):
    args = _mega_args(5, "dense_float")
    plain = CS.megastep_pair("dense_float", False)[1]
    want = plain(*args)
    rep = CS.megastep_replay(args)
    slot = int(torch.nonzero(~rep.near)[0])
    if plant == "dropped_product":
        wq = list(args[11])
        k = int(torch.nonzero(args[1][0, slot])[0])  # an event of L0's train
        wq[1] = wq[1].clone()
        wq[1][k, int(torch.argmax(wq[1][k].abs()))] = 0.0
        got = plain(*args[:11], tuple(wq), args[12])
    else:
        got = [t.clone() for t in want]
        if plant == "u_off_1e-3":
            got[1][slot, 0] += 1e-3
        else:
            got[4][-1, slot, 0] += 1e-3
    with pytest.raises(AssertionError, match="u rule|differs"):
        CS.check_mega("megastep", got, want, rep, True)


def test_float64_replay_equals_lif_trace_in_float64():
    stim, s, w, u0, h0, beta, vth = (t.double() for t in _cell_args(3, True))
    rec = s @ w
    u, a = CS.lif_bound(stim, rec, stim.abs() + s @ w.abs(), u0, h0, beta,
                        vth)
    assert torch.equal(u, CS.lif_trace(stim, rec, u0, h0, beta, vth))
    assert bool((a > 0).all())


@pytest.mark.parametrize("fc_mode", ["dense_float", "dense_int4"])
def test_megastep_replay_equals_the_plain_chain_in_float64(fc_mode):
    """The per-frame replay is the plain mega-step's chain (``megastep_ref``
    composes the plain K1 in this order) run in float64, the int4 weights
    dequantized exactly: the same last trains and potentials, and with a
    float FC the same logits of every frame."""
    args = _mega_args(7, fc_mode)
    rep = CS.megastep_replay(args)
    x, s0, u0, h0, s1, u1, h1, b0, v0, b1, v1 = (t.double()
                                                   for t in args[:11])
    wq = args[11]
    if fc_mode == "dense_float":
        w0x, w0h, w1x, w1h = (w.double() for w in wq)
    else:
        w0x, w0h, w1x, w1h = (ref.unpack_int4_ref(q).double() * sc.double()
                              for q, sc in zip(wq[0::2], wq[1::2]))
    logits = []
    for xf in x:
        s0, u0 = ref.rsnn_cell_ref((xf @ w0x).expand(TS_, B, H), s0, w0h,
                                   u0, h0, b0, v0)
        h0 = s0[-1]
        s1, u1 = ref.rsnn_cell_ref((s0.reshape(-1, H) @ w1x).reshape(
            TS_, B, H), s1, w1h, u1, h1, b1, v1)
        h1 = s1[-1]
        if fc_mode == "dense_float":
            logits.append(s1.sum(dim=0) @ args[12][0].double())
    assert torch.equal(s0.bool(), rep.s[0])
    assert torch.equal(s1.bool(), rep.s[1])
    assert torch.equal(u0, rep.u[0]) and torch.equal(u1, rep.u[1])
    if fc_mode == "dense_float":
        assert torch.equal(torch.stack(logits), rep.logits)
