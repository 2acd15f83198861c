"""Token-LM serving in repro_torch (``serving/engine.py``,
``serving/cache_utils.py``, ``data/synthetic.py``'s LM stream) against the
reference on the CPU: ``MarkovLMStream`` batches bit-equal; ``pad_cache``
on the port's caches equal to the reference's on its own; ``sample``
(greedy equal, temperature + top-k drawing only from the top k);
``generate`` ids equal to the reference's on reduced ``yi-6b``,
``gemma2-2b`` and ``deepseek-v3-671b``, with the reference's dropped decode
writes (the prefill cache is prompt-sized, so every decode write lands past
it); ``ServeLoop``'s finishing order and outputs equal to the reference's;
and the families not ported yet raising.

The reference's parameters (``PRNGKey(0)``) are carried across with
``params_from_numpy``; float32 at ``reduce_config``.  Token ids exact,
caches within ``TOL``."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_synthetic
from repro.models import registry as j_registry
from repro.serving import cache_utils as j_cache_utils
from repro.serving import engine as j_engine
from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
from repro_torch.models import registry
from repro_torch.serving.cache_utils import pad_cache
from repro_torch.serving.engine import (SamplerConfig, ServeLoop, generate,
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


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b"])
def test_pad_cache_on_prefill_caches(setups, arch):
    _, jp, jfwd, tapi, tp = _setup(setups, arch)
    toks = _prompts(2, 8)
    _, jcache = jfwd(jp, {"tokens": toks}, mode="prefill")
    _, tcache = tapi.forward(tp, {"tokens": torch.from_numpy(toks)},
                             mode="prefill")
    want = jax.tree.leaves(j_cache_utils.pad_cache(jcache, 8, 20))
    got = jax.tree.leaves(pad_cache(tcache, 8, 20))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    assert any(20 in g.shape for g in got)


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


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "deepseek-v3-671b"])
def test_generate_matches_reference(setups, arch):
    japi, jp, _, tapi, tp = _setup(setups, arch)
    prompts = _prompts(3, 8)
    want = j_engine.generate(japi, jp, jnp.asarray(prompts), 6)
    got = generate(tapi, tp, prompts, 6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(generate(tapi, tp, prompts, 6), got)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b"])
def test_generate_drops_decode_writes(setups, arch):
    """The reference's generate decodes into the prompt-sized prefill
    cache: the write at pos = S is past its end and dropped, on both
    sides, and only ``pos`` moves."""
    _, jp, jfwd, tapi, tp = _setup(setups, arch)
    toks = _prompts(2, 8)
    _, jpre = jfwd(jp, {"tokens": toks}, mode="prefill")
    _, jdec = jfwd(jp, {"tokens": toks[:, :1]}, cache=jpre)
    _, tpre = tapi.forward(tp, {"tokens": torch.from_numpy(toks)},
                           mode="prefill")
    _, tdec = tapi.forward(tp, {"tokens": torch.from_numpy(toks[:, :1])},
                           cache=tpre)
    for before, after in ((jpre, jdec), (tpre, tdec)):
        np.testing.assert_array_equal(np.asarray(after.pos), [9, 9])
        for b, a in zip(jax.tree.leaves((before.prefix, before.layers)),
                        jax.tree.leaves((after.prefix, after.layers))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _serve(loop_cls, api, params, scfg, requests):
    loop = loop_cls(api, params, batch_slots=2, scfg=scfg)
    for prompt, max_new in requests:
        loop.submit(prompt, max_new)
    return [(r.rid, [int(t) for t in r.out], r.done) for r in loop.run()]


def test_serve_loop_matches_reference(setups):
    """5 requests over 2 slots, prompts of 3-8 tokens and 2-5 new tokens,
    then again with an EOS id that cuts an output short."""
    japi, jp, _, tapi, tp = _setup(setups, "gemma2-2b")
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 503, size=rng.integers(3, 9)),
                 int(rng.integers(2, 6))) for _ in range(5)]
    want = _serve(j_engine.ServeLoop, japi, jp, j_engine.SamplerConfig(),
                  requests)
    got = _serve(ServeLoop, tapi, tp, SamplerConfig(), requests)
    assert got == want
    assert [len(out) for _, out, _ in got] == [m for _, m in requests]
    eos = got[0][1][1]
    want = _serve(j_engine.ServeLoop, japi, jp,
                  j_engine.SamplerConfig(eos_id=eos), requests)
    got = _serve(ServeLoop, tapi, tp, SamplerConfig(eos_id=eos), requests)
    assert got == want
    assert len(got[0][1]) == 2 and got[0][1][-1] == eos


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-350m", "zamba2-7b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.get_model(arch)
