"""repro_torch's ``benchmarks/loadgen.py`` ``run_workload`` against the
reference's on the CPU, with ``test_torch_loadgen.py``'s configuration.

The closed loop at the smoke config (20 -> 64 -> 192, TS 2, 2 slots)
through every (depth, chunk) loop, the port's five backends against the
reference's ``jnp`` (its other backends are bit-equal to it by its own
tests; each reference loop runs once a process): the counts equal, each
stream's logits within ``LOGIT_TOL`` (1 + |y|), and where they are not,
the reference's potential within the u rule of a threshold on that
stream before its first frame out of the tolerance
(``_reference_near_threshold``).  Also ``build_loop`` at ``mesh = 2``
(two CPU shards) against ``mesh = 1``.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as j_kref
from repro_torch.benchmarks import loadgen as t_loadgen
from test_torch_loadgen import (CFG, J_CFG, LOOPS, WL,  # noqa: F401
                                reference_draws)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import loadgen as j_loadgen  # noqa: E402

LOGIT_TOL = 1e-5  # |d| <= LOGIT_TOL (1 + |y|): ref backend, x @ (q s) orders
U_RTOL = U_ATOL = 1e-5  # chip_smoke.py's u rule around a threshold


# ---------------------------------------------------------- run_workload


_REFERENCE: dict = {}  # (depth, chunk) -> (reference RunResult, logits)


def _reference_run(depth: int, chunk: int):
    if (depth, chunk) not in _REFERENCE:
        eng = j_loadgen.build_engine(J_CFG, "csc", 0, "jnp")
        loop = j_loadgen.build_loop(eng, 2, depth, 1, WL["max_frames"],
                                    chunk)
        res = j_loadgen.run_workload(loop, j_loadgen.Workload(**WL))
        done = sorted(loop.finished, key=lambda r: r.sid)
        _REFERENCE[depth, chunk] = (res, eng, [np.asarray(
            r.stacked_logits()) for r in done])
    return _REFERENCE[depth, chunk]


def _reference_near_threshold(eng, frames: np.ndarray, upto: int) -> bool:
    """Whether the reference engine's potential comes within the u rule of
    a threshold, at some neuron and time step, over the first ``upto + 1``
    frames of one stream: its frame step replayed eagerly, each cell's
    chain recomputed beside ``rsnn_cell_ref``."""
    margins = []

    def cell(stim, s_prev, w, u0, h0, beta, vth):
        st = stim + jnp.einsum("tbh,hk->tbk", s_prev, w)
        u, h = u0, h0
        for ts in range(st.shape[0]):
            u = st[ts] + beta * u * (1.0 - h)
            h = (u >= vth).astype(st.dtype)
            margins.append(bool(jnp.any(jnp.abs(u - vth)
                                        <= U_ATOL + U_RTOL * jnp.abs(vth))))
        return j_kref.rsnn_cell_ref(stim, s_prev, w, u0, h0, beta, vth)

    ops = eng.ops
    eng.ops = ops._replace(rsnn_cell=cell)
    try:
        with jax.disable_jit():
            state = eng.init_state(1)
            for t in range(upto + 1):
                xq = eng.quantize_features(jnp.asarray(frames[t:t + 1]))
                state, _, _ = eng._frame_step(state, xq)
    finally:
        eng.ops = ops
    return any(margins)


@pytest.mark.parametrize("backend", t_loadgen.BACKENDS)
@pytest.mark.parametrize("depth,chunk", LOOPS)
def test_run_workload_equals_reference(reference_draws, backend, depth,
                                       chunk):
    """The closed loop: streams, frames, steps, dispatches and frames
    served equal; host syncs equal in the synchronous contract (v1: a logit
    fetch and a counter fetch a step) and, pipelined, the port's count
    (one transfer a harvested block and one a counter drain) equal to the
    reference's as well.  Each stream's logits within ``LOGIT_TOL``, or
    its argmax flips only after the reference came within the u rule of
    a threshold."""
    ref, j_eng, ref_logits = _reference_run(depth, chunk)
    eng = t_loadgen.build_engine(CFG, "csc", 0, backend, device="cpu")
    loop = t_loadgen.build_loop(eng, 2, depth, 1, WL["max_frames"], chunk)
    got = t_loadgen.run_workload(loop, t_loadgen.Workload(**WL))
    for f in ("streams", "frames", "steps", "dispatches", "frames_served",
              "host_syncs", "max_backlog"):
        assert getattr(got, f) == getattr(ref, f), f
    # a sample a step_once that made progress: a step, or pipelined, a
    # shutdown retirement without a dispatch
    assert len(got.step_us) == len(ref.step_us) >= got.steps
    assert len(got.completion_ms) == len(got.queue_wait_ms) == got.streams
    assert loop.pending_steps == 0
    utts, _ = t_loadgen.Workload(**WL).materialize(CFG.input_dim)
    done = sorted(loop.finished, key=lambda r: r.sid)
    for r, want, utt in zip(done, ref_logits, utts):
        lg = r.stacked_logits()
        assert lg.shape == want.shape == (len(utt), CFG.fc_dim)
        off = np.abs(lg - want) > LOGIT_TOL * (1.0 + np.abs(want))
        if off.any():
            first = int(np.flatnonzero(off.any(axis=1))[0])
            assert _reference_near_threshold(j_eng, utt, first), \
                f"stream {r.sid}: logits differ from frame {first} away " \
                f"from the threshold"


def test_sharded_loop_on_the_cpu_serves_like_one_device():
    """``mesh = 2``: two CPU shards of one slot each, the counts and the
    logits of the single-device loop."""
    eng = t_loadgen.build_engine(CFG, "nm", 0, "fused", device="cpu")
    runs = []
    for mesh in (1, 2):
        loop = t_loadgen.build_loop(eng, 2, 2, mesh, WL["max_frames"], 4)
        res = t_loadgen.run_workload(loop, t_loadgen.Workload(**WL))
        runs.append((res, [r.stacked_logits() for r in sorted(
            loop.finished, key=lambda r: r.sid)]))
    (a, la), (b, lb) = runs
    assert (a.streams, a.frames, a.steps, a.dispatches) == \
        (b.streams, b.frames, b.steps, b.dispatches)
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    with pytest.raises(ValueError, match="multiple"):
        t_loadgen.build_loop(eng, 3, 2, 2, WL["max_frames"], 1)
