"""The benchmark's reference held against the port's CPU path, and its
inputs held to their contract."""

import numpy as np
import pytest
import torch

from bench_tiny import CELLS, tiny_files, tiny_run

from bench import program, traffic
from bench.reference import compare, data
from bench.reference.model import Reference, quantize, to_tf32


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = tiny_run(cell)
    assert out["correct"] is True
    assert out["checks"]["diverged_decided_pct"]["value"] == 0.0
    assert out["checks"]["checked_streams"]["value"] >= 8
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS[:2])
def test_reference_matches_served_logits(cell, tmp_path):
    """Streams served through the program's loop on the CPU against the
    reference, directly: every frame within the comparison's tolerance."""
    _, cfg, mix, _ = tiny_files(cell)
    dev = torch.device("cpu")
    model = data.weights(cfg, 3, dev)
    pool = traffic.Pool(mix, cfg, 3, dev)
    scale = data.input_scale(pool.frames)
    loop = program.build(cfg, mix, model, scale, tmp_path, dev)
    xs = [pool.utterance(k) for k in range(12)]
    for x in xs:
        loop.submit(x)
    served = [r.stacked_logits() for r in loop.run()]
    got = compare.compare(Reference(cfg, model, "exact", dev), xs, served,
                          scale)
    assert got["diverged_frames"] == 0
    assert got["checked_frames"] == sum(len(x) for x in xs)
    assert got["macs_per_frame"] > 0


def test_missing_or_misshapen_answers_count_as_diverged():
    _, cfg, mix, _ = tiny_files(CELLS[0])
    dev = torch.device("cpu")
    model = data.weights(cfg, 4, dev)
    pool = traffic.Pool(mix, cfg, 4, dev)
    scale = data.input_scale(pool.frames)
    xs = [pool.utterance(k) for k in range(3)]
    ref = Reference(cfg, model, "exact", dev)
    good = [np.zeros((len(x), cfg["fc_dim"]), np.float32) for x in xs]
    for t, live, logits, _, _ in ref.frames(xs, scale):
        for i in np.flatnonzero(live.numpy()):
            good[i][t] = logits[i].numpy()
    assert compare.compare(ref, xs, good, scale)["diverged_frames"] == 0
    bad = [None, good[1][:-1], good[2]]
    got = compare.compare(ref, xs, bad, scale)
    assert got["missing_streams"] == 2
    assert got["diverged_frames"] == len(xs[0]) + len(xs[1])


def test_a_threshold_tie_marks_its_stream():
    """A membrane potential on its threshold marks the stream tied from
    that frame on; the other streams stay decided."""
    _, cfg, mix, _ = tiny_files(CELLS[0])
    dev = torch.device("cpu")
    model = data.weights(cfg, 8, dev)
    pool = traffic.Pool(mix, cfg, 8, dev)
    scale = data.input_scale(pool.frames)
    xs = [pool.utterance(k) for k in range(4)]
    ref = Reference(cfg, model, "exact", dev)
    first = [ref.tied.clone() for t, *_ in ref.frames(xs, scale) if t == 0]
    assert not first[0].any()
    # the first frame's first step: U0 = x_q W0x exactly; put neuron 0's
    # threshold on stream 2's value there
    u = quantize(torch.from_numpy(xs[2][:1]), scale).to(torch.float64) \
        @ ref.w["l0_wx"]
    ref.vth[0] = ref.vth[0].clone()
    ref.vth[0][0] = u[0, 0]
    marks = [ref.tied.clone() for _ in ref.frames(xs, scale)]
    assert all(m[2] for m in marks)
    assert not marks[0][[0, 1, 3]].any()


class _Frames:
    """A reference that yields given logits, with stream 1 tied from frame
    2 on."""

    def __init__(self, logits):
        self.cfg = {"fc_dim": logits.shape[2]}
        self.logits = torch.from_numpy(logits).to(torch.float64)

    def frames(self, streams, scale):
        b = len(streams)
        for t in range(self.logits.shape[0]):
            self.tied = torch.tensor([False, t >= 2])
            live = torch.tensor([t < len(x) for x in streams])
            yield (t, live, self.logits[t], torch.ones(b, self.cfg["fc_dim"],
                   dtype=torch.float64), torch.zeros(b))


def test_frames_after_a_tie_are_not_judged():
    logits = np.random.default_rng(0).normal(size=(5, 2, 3)).astype(
        np.float32)
    xs = [np.zeros((5, 1)), np.zeros((5, 1))]
    served = [logits[:, 0].copy(), logits[:, 1].copy()]
    served[1][3] += 1.0  # after stream 1's tie: counted only in all frames
    got = compare.compare(_Frames(logits), xs, served, 1.0)
    assert got["decided_frames"] == 5 + 2 and got["tied_streams"] == 1
    assert got["diverged_decided_pct"] == 0.0
    assert got["diverged_frames_pct"] == 100.0 / 10
    served[1][1] += 1.0  # before it: counted in both
    got = compare.compare(_Frames(logits), xs, served, 1.0)
    assert got["diverged_decided_pct"] == 100.0 / 7
    assert got["diverged_frames"] == 2


def test_quantize_matches_the_port():
    from repro_torch.core import spike_ops

    x = torch.randn(2000, 40, generator=torch.Generator().manual_seed(0)) * 3
    scale = data.input_scale(x.numpy())
    want, _ = spike_ops.quantize_input(x, 8, torch.tensor(scale))
    assert torch.equal(quantize(x, scale, 8), want)
    assert quantize(x, scale).abs().max() == 127


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 3 * 2 ** -11), 3.0e-3, 0.0])
    got = to_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0  # a tie rounds to even
    assert got[3] == 1.0 + 2 * 2 ** -10 and got[4] == -got[3]
    assert got[6] == 0.0
    y = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    r = to_tf32(y)
    assert ((r - y).abs() <= y.abs() * 2 ** -11).all()
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


def test_inputs_follow_the_seed():
    _, cfg, mix, _ = tiny_files(CELLS[0])
    dev = torch.device("cpu")
    a, b = data.weights(cfg, 5, dev), data.weights(cfg, 5, dev)
    c = data.weights(cfg, 6, dev)
    qa, sa, ka = a["layers"]["fc_w"]
    assert torch.equal(qa, b["layers"]["fc_w"][0])
    assert not torch.equal(qa, c["layers"]["fc_w"][0])
    assert qa.dtype == torch.int8 and int(qa.abs().max()) <= 8
    assert bool((qa[~ka] == 0).all())
    keep = float(ka.float().mean())
    assert abs(keep - (1 - cfg["fc_prune_fraction"])) < 0.1
    p1 = traffic.Pool(mix, cfg, 2 ** 40 + 1, dev)
    p2 = traffic.Pool(mix, cfg, 2 ** 40 + 1, dev)
    p3 = traffic.Pool(mix, cfg, 7, dev)
    assert np.array_equal(p1.frames, p2.frames)
    assert sorted(p1.lengths) == sorted(p3.lengths)
    assert not np.array_equal(p1.lengths, p3.lengths)
    assert p1.utterance(3).shape == (p1.lengths[3], cfg["input_dim"])


def test_float_model_lif_constants():
    _, cfg, _, _ = tiny_files(CELLS[1])
    ref = Reference(cfg, data.weights(cfg, 1, "cpu"), "exact", "cpu")
    assert torch.allclose(ref.beta[0], torch.full((16,), 0.9,
                                                  dtype=torch.float64))
    assert torch.allclose(ref.vth[1], torch.ones(16, dtype=torch.float64))
