"""The token-LM layers of repro_torch (``models/layers/``) against the
reference's on the CPU: norms, RoPE (full and partial rotary), the three
MLPs, the bf16 embedding scale, attention (prefill, sliding window,
softcap, cross, decode at per-row positions with one row past the cache),
MLA (prefill and decode) and both MoE layers (dense dispatch at a capacity
that drops tokens, and the dropless ragged one).

Inputs are seeded numpy; parameters are the reference's own init, carried
across with ``params_from_numpy``.  float32 throughout, ``rtol = atol =
TOL``: the two sides sum in different orders; exact where nothing is
summed (the embedding, the cache rows a decode step leaves alone)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as j_registry
from repro.models.layers import attention as j_attn
from repro.models.layers import basic as j_basic
from repro.models.layers import mla as j_mla
from repro.models.layers import moe as j_moe
from repro_torch.models import registry
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import basic
from repro_torch.models.layers import mla
from repro_torch.models.layers import moe

TOL = 1e-4


def _cfgs(arch, **upd):
    """The reduced config of ``arch`` in both packages, ``upd`` applied."""
    jc = j_registry.reduce_config(j_registry.get_model(arch).cfg)
    tc = registry.reduce_config(registry.get_model(arch).cfg)
    return dataclasses.replace(jc, **upd), dataclasses.replace(tc, **upd)


def _ref(fn, *arrays, **static):
    """The reference's ``fn`` on ``arrays`` under ``jax.jit``, ``static``
    bound (its eager first call compiles op by op, ten times slower)."""
    return jax.jit(functools.partial(fn, **static))(*arrays)


def _ported(tree):
    return registry.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(registry.params_to_numpy(got),
                               np.asarray(want), rtol=tol, atol=tol)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("plus_one", [True, False])
def test_rmsnorm(plus_one):
    x, s = _normal(0, 2, 5, 64), _normal(1, 64)
    got = basic.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6,
                        plus_one)
    _close(got, _ref(j_basic.rmsnorm, x, s, eps=1e-6, plus_one=plus_one))


def test_layernorm():
    x, s, b = _normal(0, 2, 5, 64), _normal(1, 64), _normal(2, 64)
    got = basic.layernorm(*map(torch.from_numpy, (x, s, b)))
    _close(got, _ref(j_basic.layernorm, x, s, b))


@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
def test_apply_rope(rotary_pct):
    x = _normal(0, 2, 5, 4, 16)
    pos = np.random.default_rng(1).integers(0, 4096, (2, 5)).astype(np.int32)
    got = basic.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10000.0, rotary_pct)
    want = _ref(j_basic.apply_rope, x, pos, theta=10000.0,
                rotary_pct=rotary_pct)
    _close(got, want)
    # the pass-through features are the input's, bit for bit
    rot = int(16 * rotary_pct) // 2 * 2
    np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp(mlp_type):
    jc, tc = _cfgs("yi-6b", mlp_type=mlp_type)
    p = j_basic.init_mlp(jax.random.PRNGKey(0), jc, 64, 128)
    if mlp_type == "gelu":  # non-zero biases, so the test sees them
        p = dict(p, b_up=jnp.asarray(_normal(3, 128)),
                 b_down=jnp.asarray(_normal(4, 64)))
    x = _normal(1, 2, 5, 64)
    _close(basic.mlp(torch.from_numpy(x), _ported(p), tc),
           _ref(j_basic.mlp, x, p, cfg=jc))


def test_embed_tokens_bf16_scale_rounded():
    """gemma-7b's width: sqrt(3072) = 55.43 is 55.5 in bf16, and both sides
    multiply by the rounded scale."""
    jc, tc = _cfgs("gemma-7b", d_model=3072, dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    table = np.asarray(jnp.asarray(_normal(0, 16, 3072), jnp.bfloat16))
    toks = np.random.default_rng(1).integers(0, 16, (2, 7)).astype(np.int32)
    want = j_basic.embed_tokens(jnp.asarray(toks), {"tok": jnp.asarray(table)},
                                jc)
    got = basic.embed_tokens(
        torch.from_numpy(toks),
        registry.params_from_numpy({"tok": table}, "cpu", torch.bfloat16), tc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(registry.params_to_numpy(got),
                                  np.asarray(want, np.float32))
    scale = torch.tensor(3072 ** 0.5, dtype=torch.bfloat16).item()
    assert scale == 55.5


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def attn_setup():
    jc, tc = _cfgs("gemma2-2b")  # softcap 50, GQA 4/2, hd 16
    p = j_attn.init_attn(jax.random.PRNGKey(0), jc)
    return jc, tc, p, _ported(p)


@pytest.mark.parametrize("window,softcap", [(None, None), (None, 50.0),
                                            (3, 50.0), (3, None)])
def test_attention_prefill(attn_setup, window, softcap):
    jc, tc, jp, tp = attn_setup
    jc = dataclasses.replace(jc, attn_logit_softcap=softcap)
    tc = dataclasses.replace(tc, attn_logit_softcap=softcap)
    x = _normal(1, 2, 9, 64)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    want, jkv = _ref(j_attn.attention, x, jp, cfg=jc, positions=pos,
                     layer_window=window, return_kv=True)
    got, tkv = attn.attention(torch.from_numpy(x), tp, tc,
                              torch.from_numpy(pos), layer_window=window,
                              return_kv=True)
    _close(got, want)
    _close(tkv.k, jkv.k)
    _close(tkv.v, jkv.v)


def test_attention_cross(attn_setup):
    jc, tc, jp, tp = attn_setup
    x, kv_x = _normal(1, 2, 5, 64), _normal(2, 2, 7, 64)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    want, _ = _ref(lambda x, p, pos, kv_x: j_attn.attention(
        x, p, jc, pos, rope=False, kv_x=kv_x), x, jp, pos, kv_x)
    got, _ = attn.attention(torch.from_numpy(x), tp, tc,
                            torch.from_numpy(pos), rope=False,
                            kv_x=torch.from_numpy(kv_x))
    _close(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_attention_decode_per_row_positions(attn_setup, window):
    """Rows write at positions 0, 4 and 7 of an 8-row cache; the fourth
    row's position, 8, is past the cache: the reference drops that write,
    and the port leaves the row as it was."""
    jc, tc, jp, tp = attn_setup
    b, t = 4, 8
    k0, v0 = _normal(1, b, t, 2, 16), _normal(2, b, t, 2, 16)
    x = _normal(3, b, 1, 64)
    cpos = np.array([0, 4, 7, 8], np.int32)
    want, jc2 = _ref(lambda x, p, pos, cache, cpos: j_attn.attention(
        x, p, jc, pos, layer_window=window, cache=cache, cache_pos=cpos),
        x, jp, cpos[:, None], j_attn.KVCache(k0, v0), cpos)
    got, tc2 = attn.attention(
        torch.from_numpy(x), tp, tc, torch.from_numpy(cpos[:, None]),
        layer_window=window, cache=attn.KVCache(torch.from_numpy(k0),
                                                torch.from_numpy(v0)),
        cache_pos=torch.from_numpy(cpos))
    _close(got, want)
    _close(tc2.k, jc2.k)
    _close(tc2.v, jc2.v)
    np.testing.assert_array_equal(tc2.k[3].numpy(), k0[3])
    np.testing.assert_array_equal(tc2.v[3].numpy(), v0[3])
    untouched = np.ones((b, t), bool)
    untouched[np.arange(3), cpos[:3]] = False
    np.testing.assert_array_equal(tc2.k.numpy()[untouched], k0[untouched])


def test_causal_mask_window():
    got = attn.causal_mask(6, 6, 0, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_attn.causal_mask(6, 6, 0, 3)))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla_setup():
    jc, tc = _cfgs("deepseek-v3-671b")
    p = j_mla.init_mla(jax.random.PRNGKey(0), jc)
    p = dict(p, q_norm=jnp.asarray(_normal(5, 32)),
             kv_norm=jnp.asarray(_normal(6, 16)))
    return jc, tc, p, _ported(p)


def test_mla_prefill(mla_setup):
    jc, tc, jp, tp = mla_setup
    x = _normal(1, 2, 9, 64)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    want, jkv = _ref(j_mla.mla_attention, x, jp, cfg=jc, positions=pos,
                     return_kv=True)
    got, tkv = mla.mla_attention(torch.from_numpy(x), tp, tc,
                                 torch.from_numpy(pos), return_kv=True)
    _close(got, want)
    _close(tkv.kv_latent, jkv.kv_latent)
    _close(tkv.k_rope, jkv.k_rope)


def test_mla_decode_per_row_positions(mla_setup):
    jc, tc, jp, tp = mla_setup
    b, t = 3, 8
    lat, kr = _normal(1, b, t, 16), _normal(2, b, t, 8)
    x = _normal(3, b, 1, 64)
    cpos = np.array([2, 7, 8], np.int32)
    want, jc2 = _ref(lambda x, p, pos, cache, cpos: j_mla.mla_attention(
        x, p, jc, pos, cache=cache, cache_pos=cpos),
        x, jp, cpos[:, None], j_mla.MLACache(lat, kr), cpos)
    got, tc2 = mla.mla_attention(
        torch.from_numpy(x), tp, tc, torch.from_numpy(cpos[:, None]),
        cache=mla.MLACache(torch.from_numpy(lat), torch.from_numpy(kr)),
        cache_pos=torch.from_numpy(cpos))
    _close(got, want)
    _close(tc2.kv_latent, jc2.kv_latent)
    _close(tc2.k_rope, jc2.k_rope)
    np.testing.assert_array_equal(tc2.kv_latent[2].numpy(), lat[2])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_setup():
    """deepseek reduced (8 experts, top 2, one shared) at capacity factor
    0.5: capacity 8 for 16 expected choices an expert, so tokens drop."""
    jc, tc = _cfgs("deepseek-v3-671b")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=0.5, group_size=32))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=0.5, group_size=32))
    p = j_moe.init_moe(jax.random.PRNGKey(0), jc)
    x = _normal(1, 4, 16, 64)
    return jc, tc, p, _ported(p), x


def test_moe_layer_drops_as_reference(moe_setup):
    jc, tc, jp, tp, x = moe_setup
    want = _ref(j_moe.moe_layer, x, jp, cfg=jc)
    got = moe.moe_layer(torch.from_numpy(x), tp, tc)
    _close(got, want)
    # the capacity drops choices: the dense dispatch is not the dropless sum
    dropless = moe.moe_layer_ragged(torch.from_numpy(x), tp, tc)
    assert not torch.allclose(got, dropless, rtol=1e-3, atol=1e-3)


def test_moe_layer_ragged(moe_setup):
    jc, tc, jp, tp, x = moe_setup
    want = _ref(j_moe.moe_layer_ragged, x, jp, cfg=jc)
    _close(moe.moe_layer_ragged(torch.from_numpy(x), tp, tc), want)


def test_moe_dense_equals_ragged_without_drops(moe_setup):
    """At a capacity no expert fills, the two routings compute one sum."""
    _, tc, _, tp, x = moe_setup
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=64.0))
    _close(moe.moe_layer(torch.from_numpy(x), tp, tc),
           moe.moe_layer_ragged(torch.from_numpy(x), tp, tc).numpy())
