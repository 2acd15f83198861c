"""The token-LM forwards of tests/test_torch_lm.py on its
``SPLIT_ARCHS`` (the MLA + MoE archs ``deepseek-v3-671b`` and
``kimi-k2-1t-a32b``, and the VLM ``internvl2-26b``): train and prefill
logits and caches, and teacher-forced decode, against the reference's at
that file's tolerances, through its cases and helpers."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest

import test_torch_lm as lm
from test_torch_lm import runs  # noqa: F401  (the reference's runs)


@pytest.mark.parametrize("arch", lm.SPLIT_ARCHS)
def test_train_logits(runs, arch):  # noqa: F811
    lm.test_train_logits(runs, arch)


@pytest.mark.parametrize("arch", lm.SPLIT_ARCHS)
def test_prefill_logits_and_cache(runs, arch):  # noqa: F811
    lm.test_prefill_logits_and_cache(runs, arch)


@pytest.mark.parametrize("arch", [a for a in lm.SPLIT_ARCHS
                                  if a in lm.DECODE_ARCHS])
def test_teacher_forced_decode(runs, arch):  # noqa: F811
    lm.test_teacher_forced_decode(runs, arch)
