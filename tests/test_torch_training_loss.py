"""repro_torch's ``rsnn.loss_fn`` against the reference's ``jax.grad``:
the loss-function cases of tests/test_torch_training.py, with that file's
weights, helpers and tolerances.

Over ``LOSS_CASES`` (plain, masked and fake-quantized weights; 1, 2 and
4 time steps; the hardware-rounded LIF; a frame mask and an empty one):
every frame's forward spikes bit for bit, the loss within rtol 1e-4,
atol 1e-6, the metrics within rtol 1e-6, atol 1e-7, and every gradient
leaf within rtol 1e-4 and an atol of 1e-6 + 5e-4 max |g| over the leaf
(the reasons are in tests/test_torch_training.py).
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rsnn as j_rsnn
from repro.core import spike_ops as j_spike_ops
from repro.core.compression import compress as j_compress
from repro_torch.core import artifact, rsnn, spike_ops
from repro_torch.core.compression import compress
from repro_torch.training import optimizer as opt
from test_torch_training import (B, GRAD_SCALE, LOSS_ATOL, LOSS_RTOL, T,
                                 _as_port, _close, _np, _weights)


def _materializers(kind: str, pj, pt):
    if kind == "none":
        return None, None
    kw = {"fc_prune_frac": 0.4,
          "weight_bits": 4 if kind == "fake_quant" else None}
    jcc, tcc = (j_compress.CompressionConfig(**kw),
                compress.CompressionConfig(**kw))
    jcs, tcs = (j_compress.init_compression(pj, jcc),
                compress.init_compression(pt, tcc))
    for n, m in jcs.masks.items():
        np.testing.assert_array_equal(_np(tcs.masks[n]), np.asarray(m))
    return (j_compress.materializer(jcc, jcs),
            compress.materializer(tcc, tcs))


def _spike_trains(p, x, cfg, num_ts, mod):
    """Every frame's (h0, h1) of ``mod``'s golden model, frame by frame."""
    if mod is rsnn:
        xq, _ = spike_ops.quantize_input(torch.from_numpy(x))
        st = rsnn.init_state(cfg, x.shape[0], num_ts, device="cpu")
        frames = xq.unbind(1)
    else:
        xq, _ = j_spike_ops.quantize_input(jnp.asarray(x))
        st = j_rsnn.init_state(cfg, x.shape[0], num_ts)
        frames = [xq[:, t] for t in range(x.shape[1])]
    out = []
    for x_t in frames:
        st, _ = mod.frame_step(p, st, x_t, cfg)
        out.append((_np(st.h0), _np(st.h1)))
    return out


LOSS_CASES = [  # (materialize, num_ts, hw_rounded_lif, mask)
    ("none", 1, False, None), ("none", 2, False, None),
    ("none", 4, False, None), ("masks", 2, False, None),
    ("fake_quant", 2, False, None), ("none", 2, True, None),
    ("masks", 1, True, None), ("fake_quant", 4, True, None),
    ("fake_quant", 2, True, "frames"), ("none", 2, False, "empty"),
]


@pytest.mark.parametrize("kind,num_ts,hw,mask", LOSS_CASES)
def test_loss_fn_matches_jax_grad(kind, num_ts, hw, mask):
    pj, pt, cfg_j, cfg_t = _weights(num_ts, hw)
    mat_j, mat_t = _materializers(kind, pj, pt)
    rng = np.random.default_rng(10 + num_ts)
    x = rng.normal(size=(B, T, 8)).astype(np.float32)
    labels = rng.integers(0, 12, size=(B, T)).astype(np.int32)
    labels[0, 0] = -1  # counts from the end
    batch_np = {"features": x, "labels": labels}
    if mask == "frames":
        batch_np["mask"] = (rng.uniform(size=(B, T)) < 0.6).astype(
            np.float32)
    elif mask == "empty":  # the denominator max(sum, 1)
        batch_np["mask"] = np.zeros((B, T), np.float32)
    # the forward spikes first: every frame's trains equal
    mj = mat_j(pj) if mat_j else pj
    with torch.no_grad():
        mt = mat_t(pt) if mat_t else pt
        got = _spike_trains(mt, x, cfg_t, num_ts, rsnn)
    want = _spike_trains(mj, x, cfg_j, num_ts, j_rsnn)
    for (a0, a1), (b0, b1) in zip(got, want):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
    assert 0.05 < float(np.mean([h.mean() for h, _ in want])) < 0.95

    (loss_j, aux_j), g_j = jax.value_and_grad(
        lambda p: j_rsnn.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                     batch_np.items()}, cfg_j,
                                 materialize=mat_j, num_ts=num_ts),
        has_aux=True)(pj)
    leaves = opt.tree_map(lambda v: v.clone().requires_grad_(True), pt)
    loss, aux = rsnn.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in
                                      batch_np.items()}, cfg_t,
                             materialize=mat_t, num_ts=num_ts)
    grads = opt.tree_unflatten(leaves, iter(torch.autograd.grad(
        loss, opt.tree_leaves(leaves))))
    _close(loss, loss_j, LOSS_RTOL, LOSS_ATOL)
    for k in ("accuracy", "frame_error_rate", "spike_rate_l0",
              "spike_rate_l1", "union_rate_l1", "input_bit_sparsity"):
        _close(aux[k], aux_j[k], 1e-6, 1e-7)
    want_flat = _as_port(g_j)
    got_flat = artifact._flatten_params(grads)
    assert sorted(got_flat) == sorted(want_flat)
    for k, g in got_flat.items():
        want = want_flat[k]
        _close(g, want, LOSS_RTOL,
               LOSS_ATOL + GRAD_SCALE * float(np.abs(want).max()))
    if mask == "empty":
        assert float(loss.detach()) == 0.0
    else:
        assert float(np.abs(want_flat["params['l0_wx']"]).max()) > 0
        assert float(np.abs(want_flat["params['lif0'].raw_vth"]).max()) > 0
