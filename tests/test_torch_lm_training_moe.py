"""The loss and every gradient leaf of tests/test_torch_lm_training.py's
``SPLIT_ARCHS`` (the MLA + MoE archs ``deepseek-v3-671b`` and
``kimi-k2-1t-a32b``, the encoder-decoder ``whisper-base`` and the hybrid
``zamba2-7b``) against ``jax.value_and_grad`` of the reference's loss,
through that file's case, helpers and tolerances."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest

import test_torch_lm_training as lm_training


@pytest.mark.parametrize("arch,spiking", [(a, False) for a in
                                          lm_training.SPLIT_ARCHS])
def test_loss_and_grads_match_reference(arch, spiking):
    lm_training.test_loss_and_grads_match_reference(arch, spiking)
