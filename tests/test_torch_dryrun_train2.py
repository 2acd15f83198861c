"""The op counter against the reference's ``hlo.analyze``: the train steps
of the fifth to seventh archs (``test_torch_dryrun_train.py`` says how).

Measured ratios port / reference (on the CPU, torch 2.13): kimi-k2-1t-a32b
0.9811, stablelm-3b 0.9829, whisper-base 0.9585.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest

from test_torch_dryrun_flops import (  # noqa: F401  (reduced: a fixture)
    ARCHS, BATCH, check_against_reference, reduced)
from test_torch_dryrun_train import SEQ_TRAIN


@pytest.mark.parametrize("arch", ARCHS[4:7])
def test_train_flops_against_reference(arch):
    check_against_reference(arch, "train", SEQ_TRAIN, BATCH)
