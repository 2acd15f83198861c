"""Token-LM serving in repro_torch (``serving/engine.py``,
``serving/cache_utils.py``, ``data/synthetic.py``'s LM stream) against the
reference on the CPU: ``MarkovLMStream`` batches bit-equal; ``pad_cache``
on the port's caches equal to the reference's on its own; ``sample``
(greedy equal, temperature + top-k drawing only from the top k);
``generate`` ids equal to the reference's on reduced ``yi-6b``,
``gemma2-2b``, ``deepseek-v3-671b``, ``whisper-base`` (frames through
``extra_inputs``), ``xlstm-350m`` and ``zamba2-7b``; ``pad_cache``
growing only the k/v leaves of the encoder-decoder, hybrid and xLSTM
caches; and the chunked prefill handing decode the sequential form's
state on xlstm and zamba2.  ``tests/test_torch_lm_decode_writes.py``
holds the reference's dropped decode writes and
``tests/test_torch_lm_serve_loop.py`` ``ServeLoop``, with the helpers of
this file.

The reference's parameters (``PRNGKey(0)``) are carried across with
``params_from_numpy``; float32 at ``reduce_config``.  Token ids exact,
caches within ``TOL``."""


import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_synthetic
from repro.models import registry as j_registry
from repro.serving import cache_utils as j_cache_utils
from repro.serving import engine as j_engine
from repro_torch.core.tree import tree_map_with_name
from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
from repro_torch.models import registry
from repro_torch.serving.cache_utils import pad_cache
from repro_torch.serving.engine import (SamplerConfig, generate,
                                        sample)

TOL = 1e-4


@pytest.fixture(scope="module")
def setups():
    """Each arch's APIs and parameters, one entry an arch, made on first
    use."""
    return {}


def _setup(setups, arch):
    """(reference API, its params, its forward under ``jax.jit``, port
    API, port params)."""
    if arch not in setups:
        jc = j_registry.reduce_config(j_registry.get_model(arch).cfg)
        tc = registry.reduce_config(registry.get_model(arch).cfg)
        japi = j_registry.get_model(arch, jc)
        jp = jax.jit(japi.init)(jax.random.PRNGKey(0))
        setups[arch] = (japi, jp,
                        jax.jit(japi.forward, static_argnames="mode"),
                        registry.get_model(arch, tc),
                        registry.params_from_numpy(
                            jax.tree.map(np.asarray, jp), "cpu"))
    return setups[arch]


def _prompts(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 503, (b, s)).astype(
        np.int32)


def _extra(api, b, seed=2):
    """The batch's inputs beside the tokens: whisper's seeded frames."""
    cfg = api.cfg
    if not cfg.encoder_layers:
        return {}
    return {"frames": np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _named(cache, names=("k", "v")) -> list:
    """The leaves of ``cache`` whose names are in ``names``, in order."""
    out = []
    tree_map_with_name(lambda n, x: out.append(x) if n in names else None,
                       cache)
    return out


@pytest.mark.parametrize("seed,vocab,batch,seq,step",
                         [(0, 503, 4, 32, 0), (3, 503, 2, 17, 5),
                          (1, 256000, 8, 64, 2)])
def test_markov_stream_bit_equal(seed, vocab, batch, seq, step):
    want = j_synthetic.MarkovLMStream(j_synthetic.LMDataConfig(
        vocab_size=vocab, seed=seed)).batch(batch, seq, step)
    got = MarkovLMStream(LMDataConfig(vocab_size=vocab, seed=seed)).batch(
        batch, seq, step)
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_pad_cache_named_leaves():
    """Sequence dims of leaves named k/v (ndim-3) and kv_latent/k_rope
    (ndim-2) grow, only where they equal the prompt length; other leaves
    and dims stay, as in the reference."""
    rng = np.random.default_rng(0)
    tree = {"k": rng.normal(size=(3, 2, 8, 2, 4)).astype(np.float32),
            "v": rng.normal(size=(2, 5, 2, 4)).astype(np.float32),
            "kv_latent": rng.normal(size=(2, 8, 6)).astype(np.float32),
            "k_rope": rng.normal(size=(3, 2, 8, 4)).astype(np.float32),
            "state": rng.normal(size=(2, 8, 3)).astype(np.float32),
            "pos": np.full((2,), 8, np.int32)}
    want = j_cache_utils.pad_cache(jax.tree.map(jnp.asarray, tree), 8, 13)
    got = pad_cache(registry.params_from_numpy(tree, "cpu"), 8, 13)
    for name in tree:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["k"].shape == (3, 2, 13, 2, 4)
    assert got["v"].shape == (2, 5, 2, 4)  # 5 != the prompt length
    assert got["state"].shape == (2, 8, 3)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b",
                                  "whisper-base", "xlstm-350m", "zamba2-7b"])
def test_pad_cache_on_prefill_caches(setups, arch):
    """Against the reference's padded cache; only the k/v (and MLA
    latent) leaves grow, and every other leaf (recurrent states,
    ``enc_out``, ``pos``) is the prefill's own tensor."""
    _, jp, jfwd, tapi, tp = _setup(setups, arch)
    toks = _prompts(2, 8)
    extra = _extra(tapi, 2)
    _, jcache = jfwd(jp, dict(extra, tokens=toks), mode="prefill")
    _, tcache = tapi.forward(tp, {k: torch.from_numpy(v) for k, v in dict(
        extra, tokens=toks).items()}, mode="prefill")
    want = jax.tree.leaves(j_cache_utils.pad_cache(jcache, 8, 20))
    padded = pad_cache(tcache, 8, 20)
    got = jax.tree.leaves(padded)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    seq = ("k", "v", "kv_latent", "k_rope")
    grown = _named(padded, seq)
    assert all(20 in g.shape for g in grown)
    assert bool(grown) == (arch != "xlstm-350m")  # xlstm: states only
    for before, after in zip(jax.tree.leaves(tcache), got):
        if not any(after is g for g in grown):
            assert after is before


def test_sample_greedy_equal():
    logits = np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32)
    logits[1, [3, 17]] = 9.0  # a tie: both pick the first maximum
    want = j_engine.sample(jnp.asarray(logits), j_engine.SamplerConfig(),
                           jax.random.PRNGKey(0))
    got = sample(torch.from_numpy(logits), SamplerConfig())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1]) == 3


def test_sample_temperature_topk():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]])
    scfg = SamplerConfig(temperature=1.0, top_k=2)
    gen = torch.Generator().manual_seed(0)
    draws = {int(sample(logits, scfg, gen)[0]) for _ in range(60)}
    assert draws == {1, 2}  # only the top-2 ids, and both of them


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "deepseek-v3-671b",
                                  "whisper-base", "xlstm-350m", "zamba2-7b"])
def test_generate_matches_reference(setups, arch):
    japi, jp, _, tapi, tp = _setup(setups, arch)
    prompts = _prompts(3, 8)
    extra = _extra(tapi, 3)
    want = j_engine.generate(japi, jp, jnp.asarray(prompts), 6,
                             extra_inputs={k: jnp.asarray(v)
                                           for k, v in extra.items()})
    got = generate(tapi, tp, prompts, 6, extra_inputs=extra)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        generate(tapi, tp, prompts, 6, extra_inputs=extra), got)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_generate_chunked_prefill_decode_consistency(setups, arch):
    """The reference's ``tests/test_serving.py``
    ``test_generate_ssm_chunked_prefill_decode_consistency``, on xlstm and
    zamba2: at ``chunk=4`` an 8-token prompt takes the chunked prefill,
    which hands decode the state the sequential form would; the ids equal
    the sequential form's and the reference's."""
    _, jp, _, tapi, tp = _setup(setups, arch)
    prompts = _prompts(2, 8, seed=3)
    out = {}
    for impl in ("chunked", "sequential"):
        cfg = dataclasses.replace(tapi.cfg, ssm=dataclasses.replace(
            tapi.cfg.ssm, chunk=4, scan_impl=impl))
        out[impl] = generate(registry.get_model(arch, cfg), tp, prompts, 5)
    np.testing.assert_array_equal(out["chunked"], out["sequential"])
    jc = j_registry.reduce_config(j_registry.get_model(arch).cfg)
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(
        jc.ssm, chunk=4, scan_impl="chunked"))
    want = j_engine.generate(j_registry.get_model(arch, jc), jp,
                             jnp.asarray(prompts), 5)
    np.testing.assert_array_equal(out["chunked"], want)

