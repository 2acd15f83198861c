"""The sharded token-LM train step on a (2, 2) mesh of four gloo ranks
(``tests/torch_spmd.py``) for the MLA + MoE archs, the MoE's dense GShard
dispatch over a batch split on ``data``: as
``tests/test_torch_spmd_archs.py``, one ``loss_and_grads`` and two AdamW
steps against the port's one-device step at ``reduce_config``, and every
leaf's placements and each rank's resident bytes.  Also a strict view that
DTensor refuses and no strategy of ``distributed/dtensor_ops.py`` takes
raises on every rank."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest
import torch_spmd as h

ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
WORLD, MESH = 4, "2x2"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_moe")
    h.run_ranks(tmp, WORLD, "archs", tmp / "out", MESH, ",".join(ARCHS))
    return tmp / "out"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(run, arch):
    h.check_arch(arch, run, WORLD)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_leaves_carry_their_specs(run, arch):
    h.check_placements(arch, run, WORLD)


def test_other_strict_view_refusals_raise(run):
    for r in range(WORLD):
        assert h.rank_report(run, r)["view_refusal"], r
