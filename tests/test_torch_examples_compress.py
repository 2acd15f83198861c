"""The port's compression example against the reference's, on the CPU.

``examples/compress_pipeline_torch.py`` runs on ``yi-6b`` and one arch of
every other family at their reduced configs, from the reference's
parameters (``jax.jit(api.init)(PRNGKey(0))``, compiled fast;
``params_from_numpy``) and tokens: the same leaves selected (their paths,
as the reference's ``keystr``), the byte counts and the pruned count
equal, the logit drift within ``DRIFT_RTOL`` (the port's LM logits are
held to the reference's at 1e-4, ``tests/test_torch_lm.py``), and K2's
product within ``FP32_TOL`` of the reference's.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import pruning as j_pruning
from repro.core.compression import quantization as j_quant
from repro.kernels import ops as j_ops
from repro.models import registry as j_registry
from repro_torch.kernels import ops
from repro_torch.models import registry

ROOT = Path(__file__).resolve().parents[1]
FP32_TOL = 1e-5  # tests/test_torch_kernels.py: |d| <= FP32_TOL (1 + |y|)
DRIFT_RTOL = 1e-4
# the reference's init compiles in a third of the time, and its values
# only have to be the same on both sides
FAST_COMPILE = {"xla_backend_optimization_level": 0}
COMPRESS_ARCHS = ("yi-6b", "deepseek-v3-671b", "internvl2-26b",
                  "whisper-base", "xlstm-350m", "zamba2-7b")


def _example():
    spec = importlib.util.spec_from_file_location(
        "compress_pipeline_torch",
        ROOT / "examples" / "compress_pipeline_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference_compress(params, prune: float):
    """``examples/compress_pipeline.py``'s loop, its arithmetic under one
    ``jax.jit`` (eager, it takes seconds an arch): (compressed params,
    fp32 bytes, int4+prune bytes, pruned count, selected keystrs)."""
    spec = j_quant.QuantSpec(bits=4)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    paths = [jax.tree_util.keystr(p) for p, _ in flat]
    sel = [leaf.ndim >= 2 and any(w in ks for w in (
        "w_gate", "w_up", "w_down", "w_q", "w_k", "w_v", "w_o"))
        for ks, (_, leaf) in zip(paths, flat)]

    @jax.jit
    def body(leaves):
        out, zeros = [], []
        for s, leaf in zip(sel, leaves):
            if s:
                mask = j_pruning.magnitude_prune_mask(
                    leaf.reshape(-1, leaf.shape[-1]), prune
                ).reshape(leaf.shape)
                leaf = j_quant.fake_quant(leaf * mask, spec)
                zeros.append((mask == 0).sum())
            out.append(leaf)
        return out, zeros

    new_leaves, zeros = body([leaf for _, leaf in flat])
    total_fp32 = sum(leaf.size * 4 for _, leaf in flat)
    quant_bytes = sum(leaf.size * (0.5 if s else 4)
                      for s, (_, leaf) in zip(sel, flat))
    return (jax.tree_util.tree_unflatten(treedef, new_leaves), total_fp32,
            quant_bytes, sum(int(z) for z in zeros),
            [ks for ks, s in zip(paths, sel) if s])


def _reference_batch(cfg) -> dict:
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                          cfg.vocab_size)}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = jnp.zeros(
            (2, cfg.num_patch_tokens, cfg.d_model), cfg.dtype)
    if cfg.family == "audio":
        batch["frames"] = jnp.zeros((2, cfg.encoder_seq, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", COMPRESS_ARCHS)
def test_compress_pipeline_matches_reference(arch):
    example = _example()
    j_cfg = j_registry.reduce_config(j_registry.get_model(arch).cfg)
    j_api = j_registry.get_model(arch, j_cfg)
    j_params = jax.jit(j_api.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0))
    j_cparams, fp32, qbytes, pruned, paths = _reference_compress(j_params,
                                                                 0.4)
    t_params = registry.params_from_numpy(
        jax.tree.map(np.asarray, j_params), "cpu")
    cparams, rep = example.compress(t_params, 0.4)
    assert sorted(rep["paths"]) == sorted(paths) and paths
    assert (rep["fp32_bytes"], rep["quant_bytes"], rep["pruned"]) == \
        (fp32, qbytes, pruned)

    j_batch = _reference_batch(j_cfg)
    fwd = jax.jit(j_api.forward)
    lo, lc = fwd(j_params, j_batch)[0], fwd(j_cparams, j_batch)[0]
    j_drift = float(jnp.mean(jnp.abs(lo - lc)))
    j_scale = float(jnp.std(lo))
    api = registry.get_model(arch, registry.reduce_config(
        registry.get_model(arch).cfg))
    tokens = torch.from_numpy(np.array(j_batch["tokens"]))
    drift, scale = example.drift(api, t_params, cparams,
                                 example.make_batch(api.cfg, tokens))
    assert drift > 0
    np.testing.assert_allclose((drift, scale), (j_drift, j_scale),
                               rtol=DRIFT_RTOL)


def test_int4_check_matches_reference():
    example = _example()
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (128, 256)),
                   np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (128, 128)),
                   np.float32)
    qw, scale = j_quant.quantize_to_int(jnp.asarray(w), j_quant.QuantSpec(
        bits=4))
    y_j = np.asarray(j_ops.int4_matmul(jnp.asarray(x), j_quant.pack_int4(qw),
                                       scale[0]))
    err_j = float(np.abs(y_j - np.asarray(
        jnp.asarray(x) @ (qw.astype(jnp.float32) * scale))).max())
    before = ops.launch_counts()
    err, y = example.int4_check(torch.from_numpy(w), torch.from_numpy(x))
    assert ops.launch_counts() == before
    y = y.numpy()
    assert np.all(np.abs(y - y_j) <= FP32_TOL * (1.0 + np.abs(y_j)))
    assert err <= FP32_TOL * (1.0 + np.abs(y_j).max())
    assert err_j <= FP32_TOL * (1.0 + np.abs(y_j).max())


def test_compress_pipeline_main_prints_the_reference_lines(capsys):
    example = _example()
    assert example.main(["--arch", "yi-6b", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert re.fullmatch(r"yi-6b: fp32 [\d.]+ MB -> int4\+prune [\d.]+ MB "
                        r"\([\d.]+% smaller, \d+ weights pruned\)", out[0])
    assert re.fullmatch(r"logit drift after compression: [\d.]+ "
                        r"\(scale [\d.]+\)", out[1])
    assert re.fullmatch(r"int4 CUDA matmul max err vs dequant ref: \S+",
                        out[2])
