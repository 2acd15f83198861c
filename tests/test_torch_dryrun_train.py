"""The op counter against the reference's ``hlo.analyze``: the train steps
of the first four archs (``test_torch_dryrun_flops.py`` says how; the
other six: ``test_torch_dryrun_train2.py`` and ``_train3.py``).

Train over 2 x 32 tokens at ``reduce_config``, each arch's optimizer, the
state donated on both sides.  Measured ratios port / reference (on the
CPU, torch 2.13): deepseek-v3-671b 0.9811, gemma-7b 0.9749, gemma2-2b
0.9693, internvl2-26b 0.9383 (the matmul FLOPs alone are 0.794-0.918 of
the reference's count).
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest

from test_torch_dryrun_flops import (  # noqa: F401  (reduced: a fixture)
    ARCHS, BATCH, check_against_reference, reduced)

SEQ_TRAIN = 32


@pytest.mark.parametrize("arch", ARCHS[:4])
def test_train_flops_against_reference(arch):
    check_against_reference(arch, "train", SEQ_TRAIN, BATCH)
