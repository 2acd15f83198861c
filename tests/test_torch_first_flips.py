"""``chip_smoke.py``'s trace of the argmax flips against ``ref`` (phase
4), on the CPU.

``teacher_forced`` over every frame of streams of unequal lengths (a slot
masked once its stream has ended), ``first_flips`` (both engines
free-running, each stream's first differing spike and ``ref``'s |u - vth|
there) and ``check_first_flips``, over a small float model served by the
``ref`` backend against itself (nothing may differ) and against a copy
whose L0 feed-forward weights are perturbed by ``PERTURB``: its first
flips then lie farther from the threshold than the u rule allows, and
the check refuses them.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

from repro_torch.core.rsnn import RSNNConfig
from repro_torch.serving.stream import CompiledRSNN, StreamLoop
from test_torch_compression import _chip_smoke

CS = _chip_smoke()
CFG = RSNNConfig(hidden_dim=32, fc_dim=48)
PERTURB = 3e-6  # N(0, PERTURB^2) added to l0_wx: margins ~1e-4, rule 2e-5


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(utterances, ref engine, its twin, the perturbed twin) on the
    CPU."""
    utts = CS.utterances(0, 12, CFG)
    path = CS.write_float_artifact(tmp_path_factory.mktemp("f") / "a", 0,
                                   utts, CFG)
    ref, twin, off = (CompiledRSNN.from_artifact(path, backend="ref",
                                                 device="cpu")
                      for _ in range(3))
    g = torch.Generator().manual_seed(1)
    off._w["l0_wx"] += PERTURB * torch.randn(off._w["l0_wx"].shape,
                                             generator=g)
    return utts, ref, twin, off


def _serve(engine, utts):
    loop = StreamLoop(engine, batch_slots=8, pipeline_depth=0,
                      aot_warmup=False)
    for u in utts:
        loop.submit(u)
    return [r.stacked_logits() for r in loop.run()]


def test_padded_frames_masks_past_each_end():
    utts = [np.full((n, 3), n, np.float32) for n in (2, 5, 3)]
    x, lens = CS.padded_frames(utts, None)
    assert x.shape == (5, 3, 3) and lens.tolist() == [2, 5, 3]
    assert float(x[1, 0, 0]) == 2.0 and float(x[2, 0].abs().sum()) == 0.0
    x, lens = CS.padded_frames(utts, 3)
    assert x.shape == (3, 3, 3) and lens.tolist() == [2, 3, 3]


def test_identical_engines_agree_on_every_frame(engines, monkeypatch):
    utts, ref, twin, _ = engines
    assert len({len(u) for u in utts}) > 1  # unequal lengths
    assert CS.teacher_forced(twin, ref, utts, None) == (0.0, 0)
    disagree, flips = CS.first_flips(twin, ref, utts)
    assert disagree.tolist() == [0] * len(utts)
    assert flips == [None] * len(utts)
    monkeypatch.setattr(CS, "SLOTS", 5)  # three batches, the last ragged
    logits = _serve(twin, utts)
    CS.check_first_flips("twin", twin, ref, utts, logits, logits)


def test_perturbed_engine_flips_away_from_the_threshold(engines,
                                                        monkeypatch):
    """Each first flip: the frame and layer where the spikes first differ,
    its time step the earliest there, and ``ref``'s |u - vth| at the
    flipped neuron recomputed from ``ref``'s own free-running state."""
    utts, ref, _, off = engines
    disagree, flips = CS.first_flips(off, ref, utts)
    found = [(i, f) for i, f in enumerate(flips) if f is not None]
    assert found and disagree.sum() > 0
    x, lens = CS.padded_frames(utts, None)
    steps = []  # the batch's free-running steps, as first_flips takes them
    sa, sb = off.init_state(len(utts)), ref.init_state(len(utts))
    for t in range(x.shape[0]):
        xq = ref.quantize_features(x[t])
        na, _, _ = off.step(sa, xq)
        nb, _, _ = ref.step(sb, xq)
        steps.append((sb, xq, nb, [na.h0 != nb.h0, na.h1 != nb.h1]))
        sa, sb = na, nb
    for i, f in found:
        for t in range(f.frame):
            assert not any(bool(d[:, i].any()) for d in steps[t][3])
        sb, xq, nb, d = steps[f.frame]
        assert f.frame < lens[i]
        assert d[f.layer][:, i].any()
        assert f.layer == 0 or not d[0][:, i].any()
        assert int(d[f.layer][:, i].any(dim=1).nonzero()[0, 0]) == f.ts
        trace, vth = CS.ref_traces(ref, sb, xq, nb)[f.layer]
        n = d[f.layer][f.ts, i].nonzero()[:, 0]
        gap = (trace[f.ts, i, n] - vth[n]).abs()
        assert f.margin == float(gap.max()) > f.limit
        assert f.limit == pytest.approx(CS.U_ATOL + CS.U_RTOL * float(
            vth[n][int(gap.argmax())].abs()))
    with pytest.raises(AssertionError, match="teacher-forced frame 0"):
        CS.teacher_forced(off, ref, utts, None)  # u off by ~1e-3
    monkeypatch.setattr(CS, "teacher_forced", lambda *a: (0.0, 0))
    with pytest.raises(AssertionError, match="flip away from the threshold"):
        CS.check_first_flips("perturbed", off, ref, utts, _serve(off, utts),
                             _serve(ref, utts))
