"""The token-LM train path of repro_torch against the reference on the
CPU: ``launch/steps.py`` ``ce_next_token_loss`` and its gradient; for
every arch of ``list_archs()`` at ``reduce_config`` (whisper given seeded
``frames``, internvl2 seeded ``patch_embeds``), and xlstm with the
spiking sLSTM, the train-mode loss and every gradient leaf against
``jax.value_and_grad`` of the reference's loss; and ``batch_shapes``
for ten archs and four shapes (``remat`` and the scans' gradients:
``tests/test_torch_lm_remat.py``; the train step and the trainer:
``tests/test_torch_trainer.py``).

Parameters are the port's seeded init, carried to the reference as numpy
leaves (``params_to_numpy``) and back with ``params_from_numpy``.  float32; the loss within ``LOSS_RTOL``, each
gradient leaf within ``GRAD_TOL`` of the leaf's largest magnitude (the
two packages sum in different orders: the largest deviation seen over
the eleven cases is 3.9e-6 of it)."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro_torch import configs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import steps
from repro_torch.models import registry

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's largest |gradient|
B, S = 2, 16
ARCHS = registry.list_archs()
# the MLA + MoE, encoder-decoder and hybrid archs take their loss-and-
# gradient case in tests/test_torch_lm_training_moe.py, the others here
SPLIT_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b", "whisper-base",
               "zamba2-7b")
# the spiking sLSTM's thresholds: at their init of 1 no unit fires, so
# they are drawn from N(0, SPIKE_VTH_STD^2), as chip_smoke.py's phase 7b
SPIKE_VTH_STD = 0.3


def _cfgs(arch, **upd):
    jc = dataclasses.replace(
        j_registry.reduce_config(j_registry.get_model(arch).cfg), **upd)
    tc = dataclasses.replace(
        registry.reduce_config(registry.get_model(arch).cfg), **upd)
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


def _params(arch, cfg, spiking: bool):
    """The port's seeded init as numpy leaves, dicts in the reference's
    sorted key order (drawn by the port: the reference's own init takes
    seconds an arch on the CPU); with ``spiking`` each sLSTM block's vth
    drawn from N(0, ``SPIKE_VTH_STD``^2)."""
    p = registry.get_model(arch, cfg).init(torch.Generator().manual_seed(0),
                                           device="cpu")
    p = jax.tree.map(np.asarray, registry.params_to_numpy(p))
    if spiking:
        rng = np.random.default_rng(2)
        for i in cfg.ssm.slstm_layers:
            vth = p["layers"][i]["block"]["vth"]
            p["layers"][i]["block"]["vth"] = (rng.normal(size=vth.shape)
                                              * SPIKE_VTH_STD).astype(
                                                  np.float32)
    return p


@functools.lru_cache(maxsize=None)
def _reference(arch, remat="none", spiking=False):
    """(reduced port config, numpy params, numpy batch, the reference's
    loss, its gradient leaves) under ``jax.jit(jax.value_and_grad)``."""
    jc, tc = _cfgs(arch, remat=remat, **({"spiking": True} if spiking
                                         else {}))
    api = j_registry.get_model(arch, jc)
    params = _params(arch, tc, spiking)
    batch = _batch(jc)

    def loss_fn(p):
        logits, _ = api.forward(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, mode="train")
        return j_steps.ce_next_token_loss(logits, jnp.asarray(
            batch["tokens"]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    return (tc, params, batch, float(loss),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port(arch, tc, params, batch):
    api = registry.get_model(arch, tc)
    return steps.loss_and_grads(
        api, registry.params_from_numpy(params, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})


def _close_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), \
            (np.abs(g - w).max(), np.abs(w).max())


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,padded", [(503, 512), (256, 256)])
def test_ce_next_token_loss_matches_reference(vocab, padded):
    """Seeded logits over the padded vocab (the padding columns carry
    logits too), targets below ``vocab``: the loss and d loss / d logits
    against ``jax.value_and_grad``."""
    rng = np.random.default_rng(vocab)
    logits = (rng.normal(size=(3, 9, padded)) * 4.0).astype(np.float32)
    tokens = rng.integers(0, vocab, (3, 9)).astype(np.int32)
    want, want_g = jax.value_and_grad(j_steps.ce_next_token_loss)(
        jnp.asarray(logits), jnp.asarray(tokens))
    x = torch.from_numpy(logits).requires_grad_()
    got = steps.ce_next_token_loss(x, torch.from_numpy(tokens))
    (got_g,) = torch.autograd.grad(got, [x])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-7)
    assert float(got_g[:, -1].abs().max()) == 0.0  # no target after the last


# ---------------------------------------------------------------------------
# loss and gradients, every arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,spiking", [(a, False) for a in ARCHS
                                          if a not in SPLIT_ARCHS]
                         + [("xlstm-350m", True)])
def test_loss_and_grads_match_reference(arch, spiking):
    tc, params, batch, loss, want = _reference(arch, spiking=spiking)
    got_loss, got = _port(arch, tc, params, batch)
    np.testing.assert_allclose(float(got_loss), loss, rtol=LOSS_RTOL)
    _close_grads(got, want)
    if spiking:  # the surrogate reaches the thresholds
        for i in tc.ssm.slstm_layers:
            keys = list(_keys(params))
            g = got[keys.index(f"layers/{i}/block/vth")]
            assert float(g.abs().max()) > 0


def _keys(tree, prefix=""):
    """Leaf paths in ``jax.tree.leaves`` order (dicts sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keys(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _keys(x, f"{prefix}{i}/")
    else:
        yield prefix[:-1]


def test_grad_leaves_follow_the_parameter_tree():
    """``loss_and_grads`` returns one leaf a parameter leaf, in
    ``tree_leaves`` order, each of its parameter's shape and dtype."""
    tc, params, batch, _, _ = _reference("gemma2-2b")
    p = registry.params_from_numpy(params, "cpu")
    _, grads = steps.loss_and_grads(registry.get_model("gemma2-2b", tc), p,
                                    {"tokens": torch.from_numpy(
                                        batch["tokens"])})
    for g, t in zip(grads, tree_leaves(p), strict=True):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert not t.requires_grad


# ---------------------------------------------------------------------------
# input shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [s.name for s in j_configs.LM_SHAPES])
def test_batch_shapes_equal_reference(shape):
    """Every arch at its full config: the same keys, shapes and dtypes,
    the port's on the meta device."""
    tshape = configs.shape_by_name(shape)
    jshape = j_configs.shape_by_name(shape)
    assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
    for arch in ARCHS:
        want = j_steps.batch_shapes(j_configs.ALL_ARCHS[arch], jshape)
        got = steps.batch_shapes(configs.ALL_ARCHS[arch], tshape)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(want[k].dtype).name


def test_shape_grid_equals_reference():
    assert [dataclasses.asdict(s) for s in configs.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in j_configs.LM_SHAPES]
    with pytest.raises(KeyError):
        configs.shape_by_name("train_8k")


def test_new_modules_import_neither_jax_nor_reference():
    code = ("import sys, repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.training.trainer, repro_torch.data.pipeline, "
            "repro_torch.runtime.fault_tolerance; "
            "import importlib.util as u; "
            f"s = u.spec_from_file_location('e', {str(ROOT / 'examples' / 'serve_lm_torch.py')!r}); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
