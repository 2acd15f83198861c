"""repro_torch's delta gate (K8 ``delta_step``) and ``delta`` backend vs
the reference's, on the CPU.

Seeded numpy inputs go through ``repro.kernels.ops.delta_step`` (the Pallas
kernel in interpret mode) and the port's plain version on CPU tensors.
Tolerances: ``mask``, ``x_hat``, the cached ``pre`` rows (bit-equal to
``pre_prev``) and the delta counters are exact; a recomputed ``pre`` row
sums float32 dequantized weights in another order, within ``|d| <= TOL *
(1 + |y|)``.  Served frames follow ``test_torch_spike.assert_frames_match``.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serving import stream as S
from repro_torch.core.lif import LIFState
from repro_torch.core.rsnn import RSNNState
from repro_torch.kernels import _build
from repro_torch.kernels import delta_step as delta_kernel
from repro_torch.kernels import ops, ref
from repro_torch.serving import stream as TS
from test_torch_kernels import CSRC, c_signature
from test_torch_spike import TOL, _close, _engines, assert_frames_match
from test_torch_stream import pruned_path, small_path  # noqa: F401

WIDTHS = {"small": (8, 16, 4), "pruned": (40, 128, 8)}  # (D, H, B)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_delta_step_matches_reference(width, threshold):
    """Rows: 0 repeats x_prev exactly (held: cached row), 1 moves by at
    most 2 LSB (held at threshold 2, propagated at 0), the rest change."""
    d, h, b = WIDTHS[width]
    rng = np.random.default_rng(41)
    x = rng.integers(-128, 128, size=(b, d)).astype(np.float32)
    x_prev = rng.integers(-128, 128, size=(b, d)).astype(np.float32)
    x_prev[0] = x[0]
    x_prev[1] = x[1] + rng.integers(-2, 3, size=d)
    x_prev[1, 0] = x[1, 0] + 1  # row 1 changes at threshold 0
    pre_prev = rng.normal(size=(b, h)).astype(np.float32)
    w = (rng.normal(size=(d, h)) * 0.05).astype(np.float32)
    got = ops.delta_step(*map(torch.from_numpy, (x, x_prev, pre_prev, w)),
                         threshold)
    want = jops.delta_step(*map(jnp.asarray, (x, x_prev, pre_prev, w)),
                           jnp.float32(threshold))
    (xh, pre, mask), (xh_j, pre_j, mask_j) = got, map(np.asarray, want)
    np.testing.assert_array_equal(mask.numpy(), mask_j)
    np.testing.assert_array_equal(xh.numpy(), xh_j)
    held = ~mask_j.any(axis=1)
    assert held[0] and held[1] == (threshold >= 2.0) and not held[2:].any()
    np.testing.assert_array_equal(pre.numpy()[held], pre_prev[held])
    np.testing.assert_array_equal(pre_j[held], pre_prev[held])
    _close(pre.numpy()[~held], pre_j[~held])
    if threshold == 0.0:  # x_hat is x elementwise
        np.testing.assert_array_equal(xh.numpy(), x)


def test_delta_step_cpu_runs_plain_and_kernel_refuses_cpu():
    z = torch.zeros((4, 8))
    before = delta_kernel.launches
    x_hat, pre, mask = ops.delta_step(z, z, torch.ones((4, 16)),
                                      torch.ones((8, 16)), 0.0)
    assert torch.equal(pre, torch.ones((4, 16))) and not mask.any()
    assert delta_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        delta_kernel.delta_step(z, z, torch.ones((4, 16)),
                                torch.ones((8, 16)), 0.0)


def test_delta_step_launch_signature_matches_the_kernel_source():
    """K8's ctypes signature and the outputs a thread owns match the C
    source."""
    assert c_signature("delta_step.cu", "delta_step_launch") == \
        delta_kernel._ARGS
    src = (CSRC / "delta_step.cu").read_text()
    assert re.search(r"constexpr int kVec = (\d+);", src).group(1) == \
        str(delta_kernel.VEC)


@pytest.mark.parametrize("b", [256, 200, 1])
@pytest.mark.parametrize("d", [8, 40])
@pytest.mark.parametrize("h", [16, 100, 128, 256])
def test_delta_step_tile_plans_fit(b, d, h):
    """Every K8 plan at these shapes: tiles the launch takes (1-32 rows, a
    power of two, by 32, 64 or 128 columns, one to 32 warps of four
    outputs a thread), shared memory as ``DeltaLayout`` computes it (W's column
    tile, the rows' x_hat, a flag a row) and under 227 KB, and the grid;
    the picked plan is one of them."""
    plans = delta_kernel.tile_plans(b, d, h)
    assert delta_kernel.tile_plan(b, d, h) in plans
    for p in plans:
        assert p.rows in (1, 2, 4, 8, 16, 32)
        assert p.cols in (32, 64, 128)
        assert 32 <= p.rows * p.cols // 4 <= 1024
        assert p.shared_bytes == 4 * (d * p.cols + p.rows * d + p.rows)
        assert p.shared_bytes <= _build.MAX_SHARED_BYTES
        assert p.blocks == math.ceil(h / p.cols) * math.ceil(b / p.rows)


@pytest.mark.parametrize("h", [128, 256])
def test_delta_step_tile_plan_fills_the_card(h):
    """At the served shapes (B = 256, D = 40; PRUNED's H = 128 and
    BASELINE's 256) K8's grid puts a block on each of the 132 SMs."""
    plan = delta_kernel.tile_plan(256, 40, h)
    assert plan.blocks >= _build.SM_COUNT
    assert plan.shared_bytes <= _build.TWO_BLOCK_SHARED_BYTES


@pytest.mark.parametrize("width", ["small", "pruned"])
@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_delta_frames_teacher_forced_match_reference(small_path, pruned_path,
                                                     width, threshold):
    path = small_path if width == "small" else pruned_path
    ref_eng, port = _engines(path, "delta", delta_threshold=threshold)
    assert isinstance(port.init_state(2), TS.DeltaRSNNState)
    assert_frames_match(ref_eng, port, exact_logits=False)


def test_delta_streamloop_counters_match_reference(small_path, small_cfg):
    """Delta counters, profile and MMAC/s of a served run equal the
    reference loop's; propagated + skipped covers every input element."""
    rng = np.random.default_rng(7)
    utts = [rng.normal(size=(t, small_cfg.input_dim)).astype(np.float32)
            for t in (9, 5, 12)]
    runs = []
    for eng, loop_cls in zip(_engines(small_path, "delta",
                                      delta_threshold=2.0),
                             (S.StreamLoop, TS.StreamLoop)):
        loop = loop_cls(eng, batch_slots=2, pipeline_depth=0)
        for u in utts:
            loop.submit(u)
        runs.append((loop, loop.run()))
    (lj, dj), (lp, dp) = runs
    c = lp.counters
    assert c.delta_propagated + c.delta_skipped == \
        c.frames * small_cfg.input_dim
    assert 0 < c.delta_skipped
    assert dataclasses.asdict(lp.sparsity_profile()) == \
        dataclasses.asdict(lj.sparsity_profile())
    assert lp.mmac_per_second() == lj.mmac_per_second()
    assert lp.engine.fc_prune_frac == 0.4
    for a, b in zip(dp, dj):
        _close(a.stacked_logits(), b.stacked_logits())


def test_refill_resets_delta_carries(small_path, small_cfg):
    """A slot refilled mid-batch must not inherit the previous occupant's
    held inputs or pre-activations: at threshold 2 the second stream's
    logits equal serving it alone in a fresh loop."""
    rng = np.random.default_rng(8)
    u1, u2 = (rng.normal(size=(t, small_cfg.input_dim)).astype(np.float32)
              for t in (6, 8))
    _, eng = _engines(small_path, "delta", delta_threshold=2.0)
    loop = TS.StreamLoop(eng, batch_slots=1)
    loop.submit(u1)
    loop.submit(u2)
    shared = {r.sid: r.stacked_logits() for r in loop.run()}
    fresh = TS.StreamLoop(eng, batch_slots=1)
    sid = fresh.submit(u2)
    alone = {r.sid: r.stacked_logits() for r in fresh.run()}
    np.testing.assert_array_equal(shared[1], alone[sid])


def test_reset_slot_zeroes_delta_state():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(s, generator=g) + 0.5  # noqa: E731
    core = RSNNState(h0=r(2, 3, 4), h1=r(2, 3, 4),
                     lif0=LIFState(r(3, 4), r(3, 4)),
                     lif1=LIFState(r(3, 4), r(3, 4)))
    st = TS.DeltaRSNNState(rsnn=core, x_prev=r(3, 5), pre=r(3, 4))
    out = TS.reset_slot(st, 1)
    assert isinstance(out, TS.DeltaRSNNState)
    for a, b in ((out.x_prev, st.x_prev), (out.pre, st.pre),
                 (out.rsnn.lif0.u, core.lif0.u)):
        assert not a[1].any()
        assert torch.equal(a[[0, 2]], b[[0, 2]])
        assert b[1].all()  # the input state is untouched
    assert not out.rsnn.h0[:, 1].any()


def test_engine_config_threshold_validation():
    with pytest.raises(ValueError, match="delta"):
        TS.EngineConfig(backend="jnp", precision="int4", delta_threshold=1.0)
    with pytest.raises(ValueError, match=">= 0"):
        TS.EngineConfig(backend="delta", precision="int4",
                        delta_threshold=-0.5)
    TS.EngineConfig(backend="delta", precision="int4",
                    delta_threshold=2.0)  # ok
