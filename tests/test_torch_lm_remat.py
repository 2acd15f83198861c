"""``remat="full"`` (activation checkpointing) in the four token-LM
forwards of repro_torch that read it (``lm_forward``, ``xlstm_forward``,
``encdec_forward``, ``hybrid_forward``), against ``"none"`` and against
the reference's ``remat="full"`` gradients on the CPU; prefill and decode
never checkpoint; and the gradients of the chunked scans' masked ``exp``:
a Mamba2 chunk whose masked entries overflow gives NaN at the same
elements in both packages, the mLSTM's ``-inf`` mask stays finite.

The same seeded parameters and tolerances as
``tests/test_torch_lm_training.py``."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import mamba2 as j_m2
from repro_torch.models import encdec, registry, transformer
from repro_torch.models.layers import mamba2 as m2
from repro_torch.models.layers import xlstm as xl
from test_torch_lm_training import (B, GRAD_TOL, LOSS_RTOL, S, _batch,
                                    _cfgs, _close_grads, _port, _reference)

# one arch of each forward that reads cfg.remat, and the function its
# train mode checkpoints, (module, name)
REMAT = {"gemma2-2b": [(transformer, "layer_fwd")],
         "xlstm-350m": [(xl, "mlstm_block"), (xl, "slstm_block")],
         "whisper-base": [(encdec, "decode_layer")],
         "zamba2-7b": [(m2, "mamba2_layer")]}


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(REMAT))
def test_remat_full(arch, monkeypatch):
    """``remat="full"``: the checkpointed function runs twice a layer
    (forward, then recomputed in the backward pass), once with
    ``"none"``; the gradients bit-equal to ``"none"``'s on the CPU, and
    within ``GRAD_TOL`` of the reference's ``remat="full"`` gradients."""
    calls = {"n": 0}
    for module, name in REMAT[arch]:
        real = getattr(module, name)

        def counted(*a, _real=real, **kw):
            calls["n"] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    got = {}
    for remat in ("none", "full"):
        tc, params, batch, loss, want = _reference(arch, remat=remat)
        calls["n"] = 0
        got_loss, got[remat] = _port(arch, tc, params, batch)
        layers = tc.num_layers - tc.dense_layers
        assert calls["n"] == layers * (2 if remat == "full" else 1)
        np.testing.assert_allclose(float(got_loss), loss, rtol=LOSS_RTOL)
        _close_grads(got[remat], want)
    for a, b in zip(got["none"], got["full"], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_remat_only_in_train_mode(mode, monkeypatch):
    """Prefill and decode with ``remat="full"`` run each layer once and
    give ``"none"``'s logits."""
    calls = {"n": 0}
    real = transformer.layer_fwd

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(transformer, "layer_fwd", counted)
    out = {}
    for remat in ("none", "full"):
        _, tc = _cfgs("gemma2-2b", remat=remat)
        api = registry.get_model("gemma2-2b", tc)
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        toks = torch.from_numpy(_batch(tc)["tokens"])
        calls["n"] = 0
        with torch.enable_grad():
            if mode == "prefill":
                out[remat], _ = api.forward(params, {"tokens": toks},
                                            mode="prefill")
            else:
                cache = api.init_cache(B, S + 1, device="cpu")
                out[remat], _ = api.forward(params, {"tokens": toks[:, :1]},
                                            cache=cache)
        assert calls["n"] == tc.num_layers
    assert torch.equal(out["none"], out["full"])


# ---------------------------------------------------------------------------
# the chunked scans' masked exp under differentiation
# ---------------------------------------------------------------------------


def test_mamba2_strong_decay_gradient():
    """a = -exp(5): above the diagonal of a chunk exp(cum_t - cum_s)
    overflows to inf, which the forward's ``where`` drops; the backward
    multiplies that inf by the zero cotangent, so d/d(a_log, dt_bias,
    w_in, x) hold NaN in the reference (``jax.grad``).  The port gives
    NaN at the same elements and the reference's values elsewhere."""
    jc, tc = _cfgs("zamba2-7b")
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(jc.ssm, chunk=4))
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm, chunk=4))
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, j_m2.init_mamba2(jax.random.PRNGKey(0),
                                                  jc))
    heads = p["a_log"].shape[0]
    p["a_log"] = (rng.normal(size=heads) * 0.5 + 5.0).astype(np.float32)
    p["dt_bias"] = (rng.normal(size=heads) * 0.5).astype(np.float32)
    x = rng.normal(size=(B, 12, jc.d_model)).astype(np.float32)
    cot = rng.normal(size=(B, 12, jc.d_model)).astype(np.float32)

    def j_loss(p, x):
        y, _ = j_m2.mamba2_layer(x, p, jc)
        return jnp.sum(y * cot)

    want_p, want_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(p, x)
    tp = registry.params_from_numpy(p, "cpu")
    xs = torch.from_numpy(x).requires_grad_()
    names = sorted(tp)
    y, _ = m2.mamba2_layer(xs, {k: tp[k].requires_grad_() for k in names},
                           tc)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                              [xs] + [tp[k] for k in names])
    nan_leaves = set()
    for name, g, w in zip(["x"] + names, got,
                          [want_x] + [want_p[k] for k in names]):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        if np.isnan(w).any():
            nan_leaves.add(name)
        ok = ~np.isnan(w)
        if ok.any():
            assert np.abs(g[ok] - w[ok]).max() <= GRAD_TOL * np.abs(
                w[ok]).max(), name
    assert nan_leaves == {"x", "a_log", "dt_bias", "w_in"}


def test_xlstm_chunked_gradient_stays_finite():
    """The mLSTM's chunked form masks with -inf before its exp, so a
    strong forget gate leaves every gradient finite, and equal to the
    reference's."""
    from repro.models.layers import xlstm as j_xl

    jc, tc = _cfgs("xlstm-350m")
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(jc.ssm, chunk=4))
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm, chunk=4))
    rng = np.random.default_rng(1)
    p = jax.tree.map(np.asarray, j_xl.init_mlstm(jax.random.PRNGKey(0), jc))
    p["b_if"] = (p["b_if"] + rng.normal(size=p["b_if"].shape) * 8.0
                 - 20.0).astype(np.float32)  # forget gates near 0
    x = rng.normal(size=(B, 12, jc.d_model)).astype(np.float32)
    cot = rng.normal(size=(B, 12, jc.d_model)).astype(np.float32)

    def j_loss(p):
        y, _ = j_xl.mlstm_block(jnp.asarray(x), p, jc)
        return jnp.sum(y * cot)

    want = jax.jit(jax.grad(j_loss))(p)
    tp = registry.params_from_numpy(p, "cpu")
    names = sorted(tp)
    y, _ = xl.mlstm_block(torch.from_numpy(x),
                          {k: tp[k].requires_grad_() for k in names}, tc)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                              [tp[k] for k in names])
    for name, g in zip(names, got):
        w = np.asarray(want[name])
        assert np.isfinite(w).all() and torch.isfinite(g).all(), name
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * max(
            np.abs(w).max(), 1e-30), name


def test_tree_unstack_gradients_equal_per_layer_indexing():
    """``core/tree.py`` ``tree_unstack`` (one ``unbind`` a leaf, as the
    forwards take their stacked layers) gives ``tree_index``'s layers, and
    the same gradient to the bit, with one backward node a leaf."""
    from repro_torch.core.tree import tree_index, tree_leaves, tree_unstack

    gen = torch.Generator().manual_seed(0)
    stacked = {"w": torch.randn((5, 4, 3), generator=gen),
               "b": [torch.randn((5, 3), generator=gen)]}
    x = torch.randn((2, 4), generator=gen)

    def loss(layers):
        h = x
        for lp in layers:
            h = torch.tanh(h[:, :3] @ lp["w"][:3] + lp["b"][0]).repeat(1, 2)
        return h.square().sum()

    grads = []
    for take in (lambda t: [tree_index(t, i) for i in range(5)],
                 tree_unstack):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(stacked)]
        tree = {"w": leaves[0], "b": [leaves[1]]}
        layers = take(tree)
        for i, lp in enumerate(layers):
            assert torch.equal(lp["w"], stacked["w"][i])
        grads.append(torch.autograd.grad(loss(layers), leaves))
    for a, b in zip(*grads, strict=True):
        assert torch.equal(a, b)
    w = torch.zeros((5, 2), requires_grad=True)
    (node,) = {t.grad_fn.name() for t in
                tree_leaves(tree_unstack({"w": w}))}
    assert node == "UnbindBackward0"
