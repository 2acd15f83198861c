"""The recurrent token-LM layers of repro_torch (``models/layers/mamba2.py``
and ``xlstm.py``) against the reference's on the CPU: ``_causal_conv``;
``mamba2_layer`` and ``mlstm_block`` in all three forms (chunked, with
``chunk`` dividing the sequence; sequential, with it not dividing; one
decode step from a prefill state) and each chunked form against the
port's own sequential form; ``slstm_block`` with ``spiking`` off and on,
its spikes teacher-forced step by step and its surrogate gradients against
``jax.grad``; a bf16 forward of each block; and ``core/tree.py``'s
``None`` subtree, which a hybrid cache with no tail holds.

Inputs are seeded numpy; parameters are the reference's own init (with
the zero-initialised decay and bias leaves drawn instead, so the test sees
them), carried across with ``params_from_numpy``.  float32 ``rtol = atol
= TOL``; bf16 within ``BF16_TOL`` of a tensor's largest magnitude."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import hybrid as j_hybrid
from repro.models import registry as j_registry
from repro.models.layers import mamba2 as j_m2
from repro.models.layers import xlstm as j_xl
from repro.serving.cache_utils import pad_cache as j_pad_cache
from repro_torch.core.tree import (tree_index, tree_leaves, tree_map,
                                   tree_map_with_name, tree_stack,
                                   tree_unflatten)
from repro_torch.models import hybrid
from repro_torch.models import registry
from repro_torch.models.layers import mamba2 as m2
from repro_torch.models.layers import xlstm as xl
from repro_torch.serving.cache_utils import pad_cache

TOL = 1e-4  # the port against the reference, float32
# bf16 blocks: both sides round each product and sum to bf16 (unit
# roundoff 2^-8 = 3.9e-3) at different points; four roundoffs of the
# tensor's largest magnitude
BF16_TOL = 4 * 2.0 ** -8
B, CHUNK = 2, 4
SEQ_CHUNKED, SEQ_SEQUENTIAL = 12, 10  # 12 = 3 chunks; 10 is not a multiple


def _cfgs(arch, **upd):
    """The reduced config of ``arch`` in both packages with ``chunk =
    CHUNK``, ``upd`` applied."""
    jc = j_registry.reduce_config(j_registry.get_model(arch).cfg)
    tc = registry.reduce_config(registry.get_model(arch).cfg)
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(jc.ssm, chunk=CHUNK),
                             **upd)
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm, chunk=CHUNK),
                             **upd)
    return jc, tc


def _impl(cfg, scan_impl):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, scan_impl=scan_impl))


def _ref(fn, *arrays, **static):
    """The reference's ``fn`` on ``arrays`` under ``jax.jit``, ``static``
    bound."""
    return jax.jit(functools.partial(fn, **static))(*arrays)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ported(tree):
    return registry.params_from_numpy(_np(tree), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(registry.params_to_numpy(got),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_bf16(got, want):
    """|got - want| <= BF16_TOL max |want|, elementwise."""
    got = registry.params_to_numpy(got)
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def _close_state(got, want, tol=TOL):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        _close(g, w, tol)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _mamba_params(cfg, seed=0):
    """``init_mamba2``'s tree with a_log, dt_bias and conv_b drawn."""
    p = _np(j_m2.init_mamba2(jax.random.PRNGKey(seed), cfg))
    heads = p["a_log"].shape[0]
    return dict(p, a_log=_normal(seed + 1, heads, scale=0.5),
                dt_bias=_normal(seed + 2, heads, scale=0.5),
                conv_b=_normal(seed + 3, *p["conv_b"].shape, scale=0.1))


def _mlstm_params(cfg, seed=0):
    p = _np(j_xl.init_mlstm(jax.random.PRNGKey(seed), cfg))
    return dict(p, conv_b=_normal(seed + 1, *p["conv_b"].shape, scale=0.1),
                b_if=p["b_if"] + _normal(seed + 2, *p["b_if"].shape))


def _slstm_params(cfg, seed=0, vth="drawn"):
    """``init_slstm``'s tree with b_gates drawn; ``vth`` at its init of 1
    (which never fires: |c / n| < 1, since n >= 1 and |tanh| < 1) or drawn
    around 0, where about a third of the units fire."""
    p = _np(j_xl.init_slstm(jax.random.PRNGKey(seed), cfg))
    p = dict(p, b_gates=_normal(seed + 1, *p["b_gates"].shape, scale=0.5))
    if vth == "drawn":
        p["vth"] = _normal(seed + 2, *p["vth"].shape, scale=0.3)
    return p


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,k", [(9, 4), (2, 4), (5, 1)])
def test_causal_conv(seq, k):
    x, w, b = _normal(0, B, seq, 24), _normal(1, k, 24), _normal(2, 24)
    got = m2._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, _ref(j_m2._causal_conv, x, w, b))


# ---------------------------------------------------------------------------
# Mamba2 and mLSTM: chunked, sequential, one decode step
# ---------------------------------------------------------------------------


BLOCKS = {
    "mamba2": ("zamba2-7b", _mamba_params, j_m2.mamba2_layer,
               m2.mamba2_layer),
    "mlstm": ("xlstm-350m", _mlstm_params, j_xl.mlstm_block,
              xl.mlstm_block),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("form,seq", [("chunked", SEQ_CHUNKED),
                                      ("sequential", SEQ_SEQUENTIAL),
                                      ("sequential", SEQ_CHUNKED)])
def test_block_prefill(block, form, seq):
    """The output and the prefill state, against the reference on the same
    form: ``scan_impl="chunked"`` takes the chunked form only where
    ``chunk`` divides the sequence (12), and the sequential one at 10."""
    arch, params, jfn, tfn = BLOCKS[block]
    jc, tc = _cfgs(arch)
    impl = "sequential" if (form, seq) == ("sequential", SEQ_CHUNKED) \
        else "chunked"
    jc, tc = _impl(jc, impl), _impl(tc, impl)
    p = params(jc)
    x = _normal(7, B, seq, jc.d_model)
    want_y, want_s = _ref(jfn, x, p, cfg=jc)
    got_y, got_s = tfn(torch.from_numpy(x), _ported(p), tc)
    _close(got_y, want_y)
    _close_state(got_s, want_s)


def test_mamba2_chunked_strong_decay():
    """a = -exp(5): a chunk's log-decay spans hundreds, so exp(cum_t -
    cum_s) overflows to inf above the diagonal; the mask must drop those
    entries (``torch.where``, as the reference's ``jnp.where``), where a
    0/1 product would give NaN."""
    jc, tc = _cfgs("zamba2-7b")
    p = _mamba_params(jc)
    p["a_log"] = p["a_log"] + 5.0
    x = _normal(10, B, SEQ_CHUNKED, jc.d_model)
    want_y, want_s = _ref(j_m2.mamba2_layer, x, p, cfg=jc)
    got_y, got_s = m2.mamba2_layer(torch.from_numpy(x), _ported(p), tc)
    assert torch.isfinite(got_y).all()
    _close(got_y, want_y)
    _close_state(got_s, want_s)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_decode_step(block):
    """One decode step from the reference's prefill state, output and new
    state against the reference's step."""
    arch, params, jfn, tfn = BLOCKS[block]
    jc, tc = _cfgs(arch)
    p = params(jc)
    x = _normal(8, B, SEQ_CHUNKED + 1, jc.d_model)
    _, state = _ref(jfn, x[:, :SEQ_CHUNKED], p, cfg=jc)
    want_y, want_s = jax.jit(lambda x_, p_, s_: jfn(x_, p_, jc, s_))(
        x[:, SEQ_CHUNKED:], p, state)
    got_y, got_s = tfn(torch.from_numpy(x[:, SEQ_CHUNKED:]), _ported(p), tc,
                       _ported(state))
    _close(got_y, want_y)
    _close_state(got_s, want_s)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_chunked_equals_sequential(block):
    """The port's chunked form against its own sequential form over 4
    chunks, output and state."""
    arch, params, _, tfn = BLOCKS[block]
    _, tc = _cfgs(arch)
    p = _ported(params(_cfgs(arch)[0]))
    x = torch.from_numpy(_normal(9, B, 4 * CHUNK, tc.d_model))
    y_c, s_c = tfn(x, p, _impl(tc, "chunked"))
    y_s, s_s = tfn(x, p, _impl(tc, "sequential"))
    torch.testing.assert_close(y_c, y_s, rtol=TOL, atol=TOL)
    for c, s in zip(s_c, s_s):
        torch.testing.assert_close(c, s, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# sLSTM, spiking off and on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spiking,vth", [(False, "drawn"), (True, "drawn"),
                                         (True, "init")])
def test_slstm_block(spiking, vth):
    jc, tc = _cfgs("xlstm-350m", spiking=spiking)
    p = _slstm_params(jc, vth=vth)
    x = _normal(3, B, SEQ_SEQUENTIAL, jc.d_model)
    want_y, want_s = _ref(j_xl.slstm_block, x, p, cfg=jc)
    got_y, got_s = xl.slstm_block(torch.from_numpy(x), _ported(p), tc)
    _close(got_y, want_y)
    _close_state(got_s, want_s)
    if spiking and vth == "init":
        assert not got_s.h.any()  # vth = 1 never fires


def test_slstm_spikes_teacher_forced():
    """Step by step from the reference's state: the spikes (h != 0, since
    sigmoid(o) > 0) equal the reference's except where its |membrane -
    vth| is within TOL (ROADMAP: a spike may differ only near the
    threshold), and the state within TOL elsewhere."""
    jc, tc = _cfgs("xlstm-350m", spiking=True)
    p = _slstm_params(jc)
    x = _normal(4, B, 16, jc.d_model)
    wx = x @ p["w_gates"] + p["b_gates"]
    jstep = jax.jit(j_xl._slstm_step_fn(jax.tree.map(jnp.asarray, p), jc))
    tstep = xl._slstm_step_fn(_ported(p), tc)
    state = j_xl.init_slstm_state(jc, B)
    vth = p["vth"].reshape(jc.num_heads, -1)
    fired = near = 0
    for t in range(x.shape[1]):
        want, _ = jstep(state, wx[:, t])
        got, _ = tstep(_ported(state), torch.from_numpy(wx[:, t]))
        membrane = np.asarray(want.c) / np.maximum(np.asarray(want.n), 1e-6)
        close = np.abs(membrane - vth) <= TOL
        got_spk, want_spk = got.h.numpy() != 0, np.asarray(want.h) != 0
        assert np.array_equal(got_spk[~close], want_spk[~close])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy()[~close],
                                       np.asarray(w)[~close], rtol=TOL,
                                       atol=TOL)
        fired += want_spk.sum()
        near += close.sum()
        state = want
    assert 0.1 < fired / (x.shape[1] * want_spk.size) < 0.9
    assert near == 0  # none this close at this seed: the check is exact


def test_slstm_spiking_gradients():
    """d/d(w_gates, r_gates, vth) of <block output, cotangent> with the
    spiking sLSTM, against ``jax.grad`` of the reference: the surrogate
    (``core/lif.py`` ``spike_fn``) is on the path, through the spikes'
    recurrent products too."""
    jc, tc = _cfgs("xlstm-350m", spiking=True)
    p = _slstm_params(jc)
    x = _normal(5, B, SEQ_SEQUENTIAL, jc.d_model)
    cot = _normal(6, B, SEQ_SEQUENTIAL, jc.d_model)
    names = ("w_gates", "r_gates", "vth")

    def j_loss(train, rest):
        y, _ = j_xl.slstm_block(jnp.asarray(x), dict(rest, **train), jc)
        return jnp.sum(y * cot)

    want = jax.jit(jax.grad(j_loss))(
        {k: p[k] for k in names}, {k: v for k, v in p.items()
                                   if k not in names})
    tp = _ported(p)
    for k in names:
        tp[k].requires_grad_(True)
    y, _ = xl.slstm_block(torch.from_numpy(x), tp, tc)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                              [tp[k] for k in names])
    for k, g in zip(names, got):
        assert g.abs().max() > 0, k
        _close(g, want[k])


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------


def _bf16(p, tree):
    """``tree`` (ported) with the leaves the reference holds in bf16 cast
    to bf16, the float32 ones (gates, decays) left."""
    return tree_map(lambda t, w: t.to(torch.bfloat16)
                    if w.dtype == jnp.bfloat16 else t, tree,
                    jax.tree.map(jnp.asarray, p))


@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_block_bf16(block):
    """The block at ``cfg.dtype = bf16`` in the chunked form (the sLSTM in
    its only one), its parameters the float32 draw rounded to bf16, as the
    reference's bf16 init holds them; the output and the state within
    ``BF16_TOL`` of each tensor's largest magnitude."""
    arch = "zamba2-7b" if block == "mamba2" else "xlstm-350m"
    jc, tc = _cfgs(arch, spiking=block == "slstm")
    jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    params, jfn, tfn = {
        "mamba2": (_mamba_params, j_m2.mamba2_layer, m2.mamba2_layer),
        "mlstm": (_mlstm_params, j_xl.mlstm_block, xl.mlstm_block),
        "slstm": (_slstm_params, j_xl.slstm_block, xl.slstm_block)}[block]
    p = jax.tree.map(jnp.asarray, params(dataclasses.replace(
        jc, dtype=jnp.float32)))
    p = {k: v.astype(jnp.bfloat16) if k.startswith(("w_", "conv_"))
         and k not in ("w_if", "w_gates") else v for k, v in p.items()}
    x = jnp.asarray(_normal(2, B, SEQ_CHUNKED, jc.d_model), jnp.bfloat16)
    want_y, want_s = _ref(jfn, x, p, cfg=jc)
    got_y, got_s = tfn(torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16), _bf16(p, _ported(p)), tc)
    assert got_y.dtype == torch.bfloat16
    _close_bf16(got_y, want_y)
    for g, w in zip(got_s, want_s):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        _close_bf16(g, w)


# ---------------------------------------------------------------------------
# core/tree.py: None is an empty subtree
# ---------------------------------------------------------------------------


def test_tree_none_is_an_empty_subtree():
    t = torch.arange(3.0)
    tree = {"a": t, "tail": None, "b": [t, None]}
    assert tree_leaves(None) == []
    assert len(tree_leaves(tree)) == 2
    assert tree_leaves(tree) == jax.tree.leaves(tree)
    got = tree_map(lambda x: x + 1, tree)
    assert got["tail"] is None and got["b"][1] is None
    torch.testing.assert_close(got["b"][0], t + 1)
    assert tree_unflatten(tree, iter([1, 2]))["tail"] is None
    assert tree_map_with_name(lambda n, x: n, tree) == \
        {"a": "a", "tail": None, "b": ["0", None]}
    assert registry.params_from_numpy({"x": None}, "cpu") == {"x": None}
    stacked = tree_stack([tree, tree])
    assert stacked["tail"] is None and stacked["a"].shape == (2, 3)
    assert tree_index(stacked, 1)["b"][1] is None


def test_hybrid_without_tail():
    """zamba2 at ``num_layers=4, attn_every=2``: no tail, so the cache's
    ``tail_states`` is ``None`` on both sides; prefill, ``pad_cache`` and
    two decode steps against the reference, and ``init_hybrid_cache``."""
    jc, tc = _cfgs("zamba2-7b", num_layers=4)
    assert j_hybrid._split(jc) == hybrid._split(tc) == (2, 2, 0)
    jp = jax.jit(functools.partial(j_hybrid.init_hybrid, cfg=jc))(
        jax.random.PRNGKey(0))
    assert "tail" not in jp
    tp = _ported(jp)
    toks = np.random.default_rng(1).integers(0, 503, (B, 10)).astype(
        np.int32)
    fwd = jax.jit(functools.partial(j_hybrid.hybrid_forward, cfg=jc),
                  static_argnames="mode")
    jl, jcache = fwd(jp, toks[:, :8], mode="prefill")
    tl, tcache = hybrid.hybrid_forward(tp, torch.from_numpy(toks[:, :8]), tc,
                                       mode="prefill")
    _close(tl, jl)
    assert jcache.tail_states is None and tcache.tail_states is None
    jcache, tcache = j_pad_cache(jcache, 8, 10), pad_cache(tcache, 8, 10)
    for t in (8, 9):
        jl, jcache = fwd(jp, toks[:, t:t + 1], cache=jcache)
        tl, tcache = hybrid.hybrid_forward(
            tp, torch.from_numpy(toks[:, t:t + 1]), tc, cache=tcache)
        _close(tl, jl)
    for g, w in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        _close(g, w)
    assert tcache.tail_states is None
    want = j_hybrid.init_hybrid_cache(jc, B, 16)
    got = hybrid.init_hybrid_cache(tc, B, 16, device="cpu")
    assert got.tail_states is None
    assert [tuple(g.shape) for g in tree_leaves(got)] == \
        [w.shape for w in jax.tree.leaves(want)]
