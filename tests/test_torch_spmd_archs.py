"""The sharded token-LM train step on a (2, 2) mesh of four gloo ranks
(``tests/torch_spmd.py``): yi-6b, gemma2-2b, stablelm-3b, gemma-7b and
internvl2-26b (seeded ``patch_embeds``) at ``reduce_config``, one
``loss_and_grads`` and two AdamW steps against the port's one-device step
(losses and grad norms within ``LOSS_ATOL``, each gradient leaf within
``GRAD_RTOL`` of its largest magnitude, parameters within
``PARAM_ATOL_PER_LR`` of the rate), every parameter, gradient and
optimizer-state leaf placed as its spec says, and each rank's resident
bytes its ``with_shardings`` blocks; yi-6b's sharded loss and gradients
also against the reference's ``jax.value_and_grad`` on one JAX CPU
device, in this process (the reference's own test runs yi-6b on a (4, 2)
mesh).  The other archs: ``test_torch_spmd_moe.py`` and
``test_torch_spmd_recurrent.py``."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_spmd as h

from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.models import registry

ARCHS = ("yi-6b", "gemma2-2b", "stablelm-3b", "gemma-7b", "internvl2-26b")
WORLD, MESH = 4, "2x2"
REF_LOSS_RTOL = 1e-5
REF_GRAD_RTOL = 1e-4  # of the leaf's largest |gradient|, as the one-device
# comparison in tests/test_torch_lm_training.py


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_archs")
    h.run_ranks(tmp, WORLD, "archs", tmp / "out", MESH, ",".join(ARCHS))
    return tmp / "out"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(run, arch):
    h.check_arch(arch, run, WORLD)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_leaves_carry_their_specs(run, arch):
    h.check_placements(arch, run, WORLD)


def test_sharded_yi_loss_matches_reference(run):
    arch = "yi-6b"
    cfg, api = h.model(arch)
    params = registry.params_to_numpy(h.init_params(api))
    batch = h.batch(cfg)
    j_api = j_registry.get_model(arch, j_registry.reduce_config(
        j_registry.get_model(arch).cfg))

    def loss_fn(p):
        logits, _ = j_api.forward(p, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, mode="train")
        return j_steps.ce_next_token_loss(logits, jnp.asarray(
            batch["tokens"]))

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = np.load(run / f"{arch}.npz")
    np.testing.assert_allclose(float(got["loss0"]), float(want_loss),
                               rtol=REF_LOSS_RTOL)
    paths = [p for p, _ in tree_leaves_with_path(h.init_params(api))]
    assert sorted(paths) == sorted(want)
    for i, p in enumerate(paths):
        g, w = got[f"g{i}"], want[p]
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= REF_GRAD_RTOL * np.abs(w).max(), p
