"""The token LMs of repro_torch (``models/transformer.py``,
``encdec.py``, ``ssm.py`` and ``hybrid.py`` through ``models/registry.py``)
against the reference on the CPU, for every arch of ``list_archs()`` at
``reduce_config`` (whisper given seeded ``frames``): train and prefill
logits and the prefill cache; prefill, ``pad_cache`` and three
teacher-forced decode steps for the non-VLM archs (MoE at capacity factor
64, as the reference's ``tests/test_arch_smoke.py`` runs them); and, at
the FULL published configs, the port's ``init`` on the meta device against
the reference's ``jax.eval_shape`` of its ``init``: the same tree of leaf
names, shapes and dtypes, without allocating.

The reference's parameters (``PRNGKey(0)``) are carried across with
``params_from_numpy``.  float32, ``rtol = atol = TOL`` against the
reference; decode against the port's own full forward at the reference
test's 2e-3."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import registry as j_registry
from repro.serving.cache_utils import pad_cache as j_pad_cache
from repro_torch import configs
from repro_torch.configs import ALL_ARCHS
from repro_torch.models import registry
from repro_torch.serving.cache_utils import pad_cache

TOL = 1e-4
DECODE_TOL = 2e-3  # tests/test_arch_smoke.py's decode-vs-forward tolerance
B, S, N_PROMPT, STEPS = 2, 16, 8, 3
LM_ARCHS = registry.list_archs()
DECODE_ARCHS = [a for a in LM_ARCHS if ALL_ARCHS[a].family != "vlm"]
# the MLA + MoE archs and the VLM take the three cases of the reference's
# runs (``_run``) in tests/test_torch_lm_moe.py, the others here
SPLIT_ARCHS = ("deepseek-v3-671b", "internvl2-26b", "kimi-k2-1t-a32b")


# ModelConfig fields the port leaves out: weight_bits is read by neither
# package.
NOT_PORTED = ("weight_bits",)


@pytest.mark.parametrize("arch", sorted(j_configs.ALL_ARCHS))
def test_config_equals_reference(arch):
    """Every field of every arch's config and its reduced config, the
    dtype by name, less ``NOT_PORTED``; the alias module names the same
    config."""
    import importlib

    def fields(cfg):
        d = dataclasses.asdict(cfg)
        dt = d["dtype"]
        d["dtype"] = str(dt).removeprefix("torch.") \
            if isinstance(dt, torch.dtype) else np.dtype(dt).name
        for f in NOT_PORTED:
            d.pop(f, None)
        return d

    for j, t in ((j_configs.ALL_ARCHS[arch], ALL_ARCHS[arch]),
                 (j_registry.reduce_config(j_configs.ALL_ARCHS[arch]),
                  registry.reduce_config(ALL_ARCHS[arch]))):
        assert fields(t) == fields(j)
        assert (t.resolved_head_dim, t.padded_vocab) == \
            (j.resolved_head_dim, j.padded_vocab)
    module = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    assert module.CONFIG is ALL_ARCHS[arch]


@pytest.mark.parametrize("name", ["MoEConfig", "MLAConfig", "SSMConfig",
                                  "ModelConfig"])
def test_config_fields_are_the_reference_less_not_ported(name):
    """The same fields with the same defaults, in order, but for
    ``NOT_PORTED``: no field of the port is one it does not read."""
    def dtype_name(dt):
        return str(dt).removeprefix("torch.") \
            if isinstance(dt, torch.dtype) else np.dtype(dt).name

    def defaults(cls):
        return [(f.name, dtype_name(f.default) if f.name == "dtype"
                 else f.default)
                for f in dataclasses.fields(cls) if f.name not in NOT_PORTED]

    want = defaults(getattr(j_configs, name))
    assert defaults(getattr(configs, name)) == want


def _cfgs(arch, capacity_factor=None):
    jc = j_registry.reduce_config(j_registry.get_model(arch).cfg)
    tc = registry.reduce_config(registry.get_model(arch).cfg)
    if capacity_factor is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=capacity_factor))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=capacity_factor))
    return jc, tc


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(registry.params_to_numpy(got),
                               np.asarray(want), rtol=tol, atol=tol)


def _close_trees(got, want, tol=TOL):
    """The same nodes (NamedTuple types and fields, dict keys, list
    lengths, ``None`` where the reference has it) and each leaf within
    ``tol``."""
    if want is None or isinstance(want, (dict, list, tuple)):
        assert type(got).__name__ == type(want).__name__
        if isinstance(want, dict):
            assert list(got) == list(want)
            want, got = list(want.values()), list(got.values())
        elif want is not None:
            assert getattr(got, "_fields", None) == getattr(want, "_fields",
                                                            None)
            assert len(got) == len(want)
        for g, w in zip(got or (), want or ()):
            _close_trees(g, w, tol)
    else:
        _close(got, want, tol)


@pytest.fixture(scope="module")
def runs():
    """The reference's outputs and the carried parameters, one entry an
    arch, computed on first use."""
    return {}


def _run(runs, arch):
    if arch in runs:
        return runs[arch]
    jc, tc = _cfgs(arch)
    japi, tapi = j_registry.get_model(arch, jc), registry.get_model(arch, tc)
    jp = jax.jit(japi.init)(jax.random.PRNGKey(0))
    batch = _batch(jc)
    fwd = jax.jit(japi.forward, static_argnames="mode")
    logits, _ = fwd(jp, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :N_PROMPT])
    plog, pcache = fwd(jp, pre, mode="prefill")
    run = {"jp": jp, "tapi": tapi, "tp": registry.params_from_numpy(
        _np(jp), "cpu"), "batch": batch, "logits": np.asarray(logits),
        "plog": np.asarray(plog), "pcache": _np(pcache)}
    if arch in DECODE_ARCHS:
        cache = pcache
        run["tapi64"] = tapi
        if jc.moe is not None:
            jc64, tc64 = _cfgs(arch, 64.0)
            run["tapi64"] = registry.get_model(arch, tc64)
            fwd = jax.jit(j_registry.get_model(arch, jc64).forward,
                          static_argnames="mode")
            _, cache = fwd(jp, pre, mode="prefill")
        cache = j_pad_cache(cache, N_PROMPT, S)
        steps = []
        for t in range(N_PROMPT, N_PROMPT + STEPS):
            dlog, cache = fwd(jp, {"tokens": batch["tokens"][:, t:t + 1]},
                              cache=cache)
            steps.append(np.asarray(dlog))
        run["steps"], run["dcache"] = steps, _np(cache)
    runs[arch] = run
    return run


@pytest.mark.parametrize("arch", [a for a in LM_ARCHS
                                  if a not in SPLIT_ARCHS])
def test_train_logits(runs, arch):
    r = _run(runs, arch)
    got, cache = r["tapi"].forward(r["tp"], _torch(r["batch"]))
    assert cache is None
    assert got.shape == (B, S, r["tapi"].cfg.padded_vocab)
    _close(got, r["logits"])


@pytest.mark.parametrize("arch", [a for a in LM_ARCHS
                                  if a not in SPLIT_ARCHS])
def test_prefill_logits_and_cache(runs, arch):
    r = _run(runs, arch)
    pre = dict(_torch(r["batch"]), tokens=torch.from_numpy(
        r["batch"]["tokens"][:, :N_PROMPT]))
    got, cache = r["tapi"].forward(r["tp"], pre, mode="prefill")
    _close(got, r["plog"])
    _close_trees(cache, r["pcache"])  # integer leaves (pos) exact


@pytest.mark.parametrize("arch", [a for a in DECODE_ARCHS
                                  if a not in SPLIT_ARCHS])
def test_teacher_forced_decode(runs, arch):
    """prefill(prompt) + pad_cache + decode(token t) against the
    reference's steps and against the port's own full forward."""
    r = _run(runs, arch)
    api, batch = r["tapi64"], _torch(r["batch"])
    toks = batch["tokens"]
    full, _ = api.forward(r["tp"], batch)
    _, cache = api.forward(r["tp"], dict(batch, tokens=toks[:, :N_PROMPT]),
                           mode="prefill")
    cache = pad_cache(cache, N_PROMPT, S)
    for i, t in enumerate(range(N_PROMPT, N_PROMPT + STEPS)):
        dlog, cache = api.forward(r["tp"], {"tokens": toks[:, t:t + 1]},
                                  cache=cache)
        _close(dlog, r["steps"][i])
        _close(dlog[:, 0], full[:, t].numpy(), DECODE_TOL)
    _close_trees(cache, r["dcache"])


def _leaves(tree, path=""):
    """{path: (shape, dtype name)} of every leaf of a parameter tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{path}/{i}").items()}
    dtype = str(tree.dtype).removeprefix("torch.")
    return {path: (tuple(tree.shape), dtype)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_meta_init_matches_reference_shapes(arch):
    """The FULL published config: the port's tree on the meta device has
    the reference's leaf names, shapes and dtypes."""
    want = jax.eval_shape(j_registry.get_model(arch).init,
                          jax.random.PRNGKey(0))
    got = registry.get_model(arch).init(torch.Generator(), device="meta")
    assert all(t.device.type == "meta" for t in jax.tree.leaves(got))
    assert _leaves(got) == _leaves(want)
