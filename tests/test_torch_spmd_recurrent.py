"""The sharded token-LM train step on a (2, 2) mesh of four gloo ranks
(``tests/torch_spmd.py``) for the encoder-decoder (seeded ``frames``),
the xLSTM (its log-sigmoid's backward written out for DTensors) and the
Mamba2 hybrid (its stacked ``groups`` leaves split over ``data`` on the
inner layer axis, gathered a layer at a time): as
``tests/test_torch_spmd_archs.py``, one ``loss_and_grads`` and two AdamW
steps against the port's one-device step at ``reduce_config``, and every
leaf's placements and each rank's resident bytes.  With remat "full"
zamba2's forward and backward hold one gathered layer at a time; with
none, every layer's stays saved for the backward pass, as the plain
step's unbound layers do."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest
import torch_spmd as h

ARCHS = ("whisper-base", "xlstm-350m", "zamba2-7b")
WORLD, MESH = 4, "2x2"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_recurrent")
    h.run_ranks(tmp, WORLD, "archs", tmp / "out", MESH, ",".join(ARCHS))
    return tmp / "out"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(run, arch):
    h.check_arch(arch, run, WORLD)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_leaves_carry_their_specs(run, arch):
    h.check_placements(arch, run, WORLD)


def test_zamba2_holds_one_gathered_layer_with_remat(run):
    for r in range(WORLD):
        g = h.rank_report(run, r)["zamba2-7b"]["gathered"]
        assert g["layer"] > 0 and g["full"] == g["layer"], (r, g)
        assert g["none"] > g["layer"], (r, g)  # the count sees saved layers
