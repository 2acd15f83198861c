"""The op counter against the reference's ``hlo.analyze``: the train steps
of the last three archs (``test_torch_dryrun_train.py`` says how).

Measured ratios port / reference (on the CPU, torch 2.13): xlstm-350m 0.9510,
yi-6b 0.9856, zamba2-7b 0.9389.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest

from test_torch_dryrun_flops import (  # noqa: F401  (reduced: a fixture)
    ARCHS, BATCH, check_against_reference, reduced)
from test_torch_dryrun_train import SEQ_TRAIN


@pytest.mark.parametrize("arch", ARCHS[7:])
def test_train_flops_against_reference(arch):
    check_against_reference(arch, "train", SEQ_TRAIN, BATCH)
