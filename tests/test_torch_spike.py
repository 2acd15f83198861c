"""repro_torch's spike-event kernels (K9 ``spike_broadcast``, K10
``spike_cell``) and ``spike`` backend vs the reference's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels`` (the Pallas
kernels in interpret mode, and ``compact_spikes``/``gather_matmul``) and
``repro_torch.kernels`` on CPU tensors (the plain versions the CUDA
kernels are held against on the card).  Tolerances:

* the event lists (``compact_spikes`` indices and values, truncation
  included) are exact;
* ``spike_broadcast`` and K10's ``u`` sum float32 weights in an order that
  differs between the two (and, on this JAX build, between the reference's
  own gather and dense paths, by up to 1.9e-6), so they agree within
  ``|d| <= TOL * (1 + |y|)``; a K10 spike may differ only where the
  potential lies within that tolerance of the threshold;
* served frames: spikes and counters exact (these seeds put no potential
  within rounding of a threshold), ``u`` and logits within ``TOL``, and
  logits bit-equal where the readout is K4's integer sum.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artifact as j_artifact
from repro.core import complexity as j_complexity
from repro.kernels import ops as jops
from repro.kernels import spike_broadcast as jsb
from repro.serving import stream as S
from repro_torch.core import artifact as t_artifact
from repro_torch.core import complexity
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import spike_broadcast as sb_kernel
from repro_torch.serving import stream as TS
from test_torch_kernels import CSRC, c_signature
from test_torch_stream import _to_torch, pruned_path, small_path  # noqa: F401

TOL = 1e-5  # |d| <= TOL * (1 + |y|)

# (input_dim, hidden, fc_dim, batch): small_cfg's widths and PRUNED's
WIDTHS = {"small": (8, 16, 12, 4), "pruned": (40, 128, 1920, 8)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL * (1.0 + np.abs(want)))


def _spikes(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


# ------------------------------------------------------------- compaction


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("capacity", ["full", 5, "over"])
def test_compact_spikes_exact(width, density, capacity):
    """Indices ascending, padding clamped to K-1 with value 0, a row over
    capacity dropping its highest-index events: equal to the reference's
    cascade.  Merged {0, 1, 2} counts and a row of arbitrary magnitudes
    ride along (values are gathered, never assumed 1)."""
    _, h, _, b = WIDTHS[width]
    rng = np.random.default_rng(31)
    x = (_spikes(rng, (2, 2 * b, h), density).sum(axis=0)).astype(np.float32)
    x[0] *= rng.normal(size=h).astype(np.float32)
    cap = {"full": h, "over": h + 3}.get(capacity, capacity)
    idx, vals = ref.compact_spikes(_t(x), cap)
    idx_j, vals_j = jsb.compact_spikes(jnp.asarray(x), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))
    # the gather form over those lists is the dense oracle over kept events
    w = rng.normal(size=(h, 7)).astype(np.float32)
    _close(ref.gather_matmul(_t(x), _t(w), cap).numpy(),
           ref.spike_broadcast_ref(_t(x), _t(w), cap).numpy())
    _close(ref.gather_matmul(_t(x), _t(w), cap).numpy(),
           np.asarray(jsb.gather_matmul(jnp.asarray(x), jnp.asarray(w), cap)))


# -------------------------------------------------------- spike_broadcast


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("form", ["2d", "3d"])
@pytest.mark.parametrize("capacity", [None, 3])
def test_spike_broadcast_within_tolerance(width, form, capacity):
    """2-D: the L1 feedforward over TS*B spike rows; 3-D: the FC readout's
    merged-spike union (values in {0..TS}); lossless and truncating."""
    _, h, n, b = WIDTHS[width]
    rng = np.random.default_rng(32)
    if form == "2d":
        x = _spikes(rng, (2 * b, h), 0.38)
        n = h
    else:
        x = _spikes(rng, (2, b, h), 0.38)
    w = (rng.normal(size=(h, n)) * 0.1).astype(np.float32)
    got = ops.spike_broadcast(_t(x), _t(w), capacity=capacity).numpy()
    want = jops.spike_broadcast(jnp.asarray(x), jnp.asarray(w),
                                capacity=capacity)
    _close(got, want)
    if form == "3d":
        merged = x.sum(axis=0)
        assert set(np.unique(merged)) == {0.0, 1.0, 2.0}
        if capacity is None:
            _close(got, merged @ w)


def test_capacity_below_one_raises():
    x = torch.ones((2, 4))
    with pytest.raises(ValueError, match="capacity"):
        ops.spike_broadcast(x, torch.ones((4, 3)), capacity=0)
    with pytest.raises(ValueError, match="capacity"):
        sb_kernel.event_capacity(0, 4)
    assert sb_kernel.event_capacity(None, 4) == 4
    assert sb_kernel.event_capacity(9, 4) == 4


def test_cpu_tensor_runs_plain_version_without_launching():
    before = (sb_kernel.launches, sb_kernel.cell_launches)
    z = torch.zeros((2, 4, 16))
    ops.spike_broadcast(z, torch.ones((16, 12)))
    ops.spike_cell(z, z, torch.ones((16, 16)), z[0], z[0], torch.ones(16),
                   torch.ones(16), capacity=3)
    assert (sb_kernel.launches, sb_kernel.cell_launches) == before
    assert _build._lib is None  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        sb_kernel.spike_broadcast(z, torch.ones((16, 12)))


def test_launch_signatures_match_the_kernel_sources():
    """The ctypes signatures of K9 and K10, the lists a union holds (K9's
    row group, shared with K10 in common.cuh) and K10's warps a block
    match the C sources."""
    assert c_signature("spike_broadcast.cu", "spike_broadcast_launch") == \
        sb_kernel._SB_ARGS
    common = (CSRC / "common.cuh").read_text()
    assert re.search(r"constexpr int kUnionLists = (\d+);", common).group(1) \
        == str(sb_kernel.GROUP)
    assert "constexpr int kGroup = reprotorch::kUnionLists;" in \
        (CSRC / "spike_broadcast.cu").read_text()
    assert c_signature("spike_cell.cu", "spike_cell_launch") == \
        sb_kernel._CELL_ARGS
    cell = (CSRC / "spike_cell.cu").read_text()
    assert re.search(r"constexpr int kMaxWarps = (\d+);", cell).group(1) == \
        str(sb_kernel.CELL_MAX_WARPS)


# K9's main-path shapes (ts, R, K, N): the L1 feed-forward over TS * B
# spike rows and the FC union, at PRUNED's and BASELINE's widths, B = 256
K9_SHAPES = {"l1 pruned": (1, 512, 128, 128), "fc pruned": (2, 256, 128, 1920),
             "l1 baseline": (1, 512, 256, 256),
             "fc baseline": (2, 256, 256, 1920)}


@pytest.mark.parametrize("shape", K9_SHAPES)
def test_spike_broadcast_tile_plan_fills_the_card(shape):
    """At the main path's shapes K9's grid puts a block on each of the 132
    SMs, in tiles the launch takes (rows in groups of four), with the
    shared memory ``spike_broadcast_launch`` computes, room for two blocks
    an SM."""
    ts, r, k, n = K9_SHAPES[shape]
    plan = sb_kernel.tile_plan(ts, r, k, n)
    g = sb_kernel.GROUP
    assert plan.cols in (32, 64, 128) and plan.rows in (4, 8, 16, 32, 64)
    assert plan.rows % g == 0
    slots = -(-k // 4) * 4
    assert plan.shared_bytes == (4 * k * plan.cols
                                 + (4 * g + 4) * (plan.rows // g) * slots
                                 + 4 * (plan.rows // g))
    assert plan.blocks == math.ceil(n / plan.cols) * math.ceil(r / plan.rows)
    assert plan.blocks >= _build.SM_COUNT
    assert plan.shared_bytes <= _build.TWO_BLOCK_SHARED_BYTES


@pytest.mark.parametrize("k", [40, 128, 256])
@pytest.mark.parametrize("r,n", [(512, 128), (256, 1920), (400, 200),
                                 (1, 1920), (3, 5)])
def test_spike_broadcast_tile_plan_fits(k, r, n):
    """K in {40, 128, 256}, ragged and tiny shapes included: the plan's
    shared memory stays under 227 KB."""
    plan = sb_kernel.tile_plan(2, r, k, n)
    assert plan.shared_bytes <= _build.MAX_SHARED_BYTES
    assert plan.blocks == math.ceil(n / plan.cols) * math.ceil(r / plan.rows)


def test_spike_broadcast_tile_plan_over_shared_memory():
    """A K whose W column tile alone passes 227 KB has no plan that fits:
    the smallest goes to the launch, which refuses it (status -2)."""
    plan = sb_kernel.tile_plan(1, 512, 2048, 128)
    assert (plan.rows, plan.cols) == (sb_kernel.GROUP, 32)
    assert plan.shared_bytes > _build.MAX_SHARED_BYTES


# ------------------------------------------------------------- spike_cell


@pytest.mark.parametrize("ts", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [256, 200, 1])
@pytest.mark.parametrize("h", [40, 100, 128, 256])
def test_spike_cell_tile_plans_fit(ts, b, h):
    """Every K10 plan at these shapes: tiles the launch takes (1-32 rows in
    whole groups of ``group_rows(ts)``, at most eight groups, by 32, 64 or
    128 neurons), shared memory as ``CellLayout`` computes it (W's column
    tile, per group a union of H entries padded to 4 of a float4 and an
    offset each, the rows' trains) and under 227 KB, and the grid; the
    picked plan is one of them."""
    plans = sb_kernel.cell_tile_plans(ts, b, h)
    assert sb_kernel.cell_tile_plan(ts, b, h) in plans
    gr = {1: 4, 2: 2, 3: 1, 4: 1}[ts]
    kp = -(-h // 4) * 4
    for p in plans:
        assert p.rows in (1, 2, 4, 8, 16, 32) and p.cols in (32, 64, 128)
        assert p.rows % gr == 0 and p.rows // gr <= 8
        assert p.shared_bytes == (4 * h * p.cols + 20 * (p.rows // gr) * kp
                                  + 4 * p.rows * ts * kp)
        assert p.shared_bytes <= _build.MAX_SHARED_BYTES
        assert p.blocks == math.ceil(h / p.cols) * math.ceil(b / p.rows)


@pytest.mark.parametrize("h", [128, 256])
def test_spike_cell_tile_plan_fills_the_card(h):
    """At the served shapes (B = 256, TS = 2; PRUNED's H = 128 and
    BASELINE's 256) K10's grid puts a block on each of the 132 SMs and
    leaves room for a second."""
    plan = sb_kernel.cell_tile_plan(2, 256, h)
    assert plan.blocks >= _build.SM_COUNT
    assert plan.shared_bytes <= _build.TWO_BLOCK_SHARED_BYTES


def _near_threshold(stim, s_prev, w, u0, h0, beta, vth, capacity):
    """(B, H) elements whose membrane is within TOL of the threshold at
    some time step (float64 replay of the chain over the kept events)."""
    ts, b, h = s_prev.shape
    kept = ref.spike_broadcast_ref(
        _t(s_prev.reshape(ts * b, h)), torch.eye(h), capacity)
    s_kept = kept.numpy().reshape(ts, b, h).astype(np.float64)
    stim = np.broadcast_to(stim, s_prev.shape).astype(np.float64)
    u, hh, near = u0.astype(np.float64), h0, np.zeros(u0.shape, bool)
    for t in range(ts):
        u = stim[t] + s_kept[t] @ w + beta * u * (1.0 - hh)
        near |= np.abs(u - vth) <= TOL * (1.0 + np.abs(u))
        hh = (u >= vth).astype(np.float64)
    return near


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("broadcast", [True, False])
@pytest.mark.parametrize("capacity", [None, 4])
def test_spike_cell_within_tolerance(width, broadcast, capacity):
    """K10 plain vs the reference's ``spike_cell``.  ``broadcast`` feeds
    the L0 form: one (B, H) stimulus row expanded over TS (stride 0)."""
    _, h, _, b = WIDTHS[width]
    ts = 2
    rng = np.random.default_rng(33)
    if broadcast:
        row = rng.normal(size=(1, b, h)).astype(np.float32)
        stim_np = np.broadcast_to(row, (ts, b, h))
        stim_t = _t(row).expand(ts, b, h)
    else:
        stim_np = rng.normal(size=(ts, b, h)).astype(np.float32)
        stim_t = _t(stim_np)
    s_prev = _spikes(rng, (ts, b, h), 0.38)
    w = (rng.normal(size=(h, h)) * 0.1).astype(np.float32)
    u0 = rng.normal(size=(b, h)).astype(np.float32)
    h0 = _spikes(rng, (b, h), 0.5)
    beta = rng.choice([0.5, 0.75, 0.875], h).astype(np.float32)
    vth = rng.choice([0.5, 1.0, 2.0], h).astype(np.float32)
    args = (s_prev, w, u0, h0, beta, vth)
    sp, u = ops.spike_cell(stim_t, *map(_t, args), capacity=capacity)
    sp_j, u_j = jops.spike_cell(jnp.asarray(np.ascontiguousarray(stim_np)),
                                *map(jnp.asarray, args), capacity=capacity)
    sp_j, u_j = np.asarray(sp_j), np.asarray(u_j)
    near = _near_threshold(stim_np, *args, capacity)
    flipped = (sp.numpy() != sp_j).any(axis=0)
    assert not (flipped & ~near).any()
    ok = ~(flipped | near)
    _close(u.numpy()[ok], u_j[ok])
    if capacity is None:  # lossless: the plain cell is K1's plain cell
        sp1, u1 = ref.rsnn_cell_ref(stim_t, *map(_t, args))
        assert torch.equal(sp1, sp) and torch.equal(u1, u)


# ------------------------------------------------------ served frames


def _engines(path, backend, **kw):
    """The reference's and the port's engine on one artifact, with the
    same explicit engine config."""
    art_j = j_artifact.load_artifact(path)
    art_t = t_artifact.load_artifact(path)
    ref_eng = S.CompiledRSNN.from_artifact(path, S.EngineConfig(
        backend=backend, precision="int4", input_scale=art_j.input_scale,
        **kw))
    port = TS.CompiledRSNN.from_artifact(path, TS.EngineConfig(
        backend=backend, precision="int4", input_scale=art_t.input_scale,
        **kw), device="cpu")
    return ref_eng, port


def assert_frames_match(ref_eng, port, exact_logits: bool, frames: int = 3,
                        seed: int = 21):
    """Teacher-forced frames: both engines start each frame from the
    reference's state (a delta state's carries included)."""
    cfg, b = ref_eng.cfg, 4
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(frames, b, cfg.input_dim)).astype(np.float32)
    x[1, 0] = x[0, 0]  # a repeated frame: the delta gate holds the row
    active = np.array([True, True, False, True])
    state = ref_eng.init_state(b)
    for t in range(frames):
        xq_j = ref_eng.quantize_features(jnp.asarray(x[t]))
        xq_p = port.quantize_features(x[t])
        np.testing.assert_array_equal(xq_p.numpy(), np.asarray(xq_j))
        sj, lj, aj = ref_eng.step_masked(state, xq_j, jnp.asarray(active))
        sp, lp, ap = port.step_masked(_state_to_torch(state), xq_p,
                                      torch.from_numpy(active))
        core_j, core_p = getattr(sj, "rsnn", sj), getattr(sp, "rsnn", sp)
        for a, c in ((core_p.h0, core_j.h0), (core_p.h1, core_j.h1),
                     (core_p.lif0.spike, core_j.lif0.spike),
                     (core_p.lif1.spike, core_j.lif1.spike)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        _close(core_p.lif0.u.numpy(), core_j.lif0.u)
        _close(core_p.lif1.u.numpy(), core_j.lif1.u)
        if hasattr(sj, "x_prev"):
            np.testing.assert_array_equal(sp.x_prev.numpy(),
                                          np.asarray(sj.x_prev))
            _close(sp.pre.numpy(), sj.pre)
        if exact_logits:
            np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
        else:
            _close(lp.numpy(), lj)
        np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
        state = sj
    assert float(np.asarray(getattr(state, "rsnn", state).h1).mean()) > 0.0


def _state_to_torch(state):
    if isinstance(state, S.DeltaRSNNState):
        return TS.DeltaRSNNState(rsnn=_to_torch(state.rsnn),
                                 x_prev=_t(np.array(state.x_prev)),
                                 pre=_t(np.array(state.pre)))
    return _to_torch(state)


@pytest.mark.parametrize("width", ["small", "pruned"])
@pytest.mark.parametrize("sparse_fc", [True, False])
def test_spike_frames_teacher_forced_match_reference(small_path, pruned_path,
                                                     width, sparse_fc):
    """``sparse_fc``: the readout is K4's integer CSC sum, bit-equal;
    without it, K9's merged-spike union over the dequantized FC."""
    path = small_path if width == "small" else pruned_path
    ref_eng, port = _engines(path, "spike", sparse_fc=sparse_fc)
    assert_frames_match(ref_eng, port, exact_logits=sparse_fc)


def test_spike_streamloop_matches_reference_loop(small_path, small_cfg):
    """Per-request logits, measured sparsity and MMAC/s against the
    reference's synchronous loop, at a truncating capacity."""
    rng = np.random.default_rng(5)
    utts = [rng.normal(size=(t, small_cfg.input_dim)).astype(np.float32)
            for t in (7, 10, 4, 6)]
    loops = []
    for eng, loop_cls in zip(_engines(small_path, "spike", spike_capacity=3),
                             (S.StreamLoop, TS.StreamLoop)):
        loop = loop_cls(eng, batch_slots=2, pipeline_depth=0)
        for u in utts:
            loop.submit(u)
        loops.append((loop, loop.run()))
    (lj, dj), (lp, dp) = loops
    assert dataclasses.asdict(lp.sparsity_profile()) == \
        dataclasses.asdict(lj.sparsity_profile())
    assert lp.mmac_per_second() == lj.mmac_per_second()
    for a, b in zip(dp, dj):
        _close(a.stacked_logits(), b.stacked_logits())


# ---------------------------------------------------- config + complexity


def test_engine_config_capacity_validation():
    with pytest.raises(ValueError, match="spike_capacity must be >= 1"):
        TS.EngineConfig(backend="spike", precision="int4", spike_capacity=0)
    with pytest.raises(ValueError, match="event-queue knob"):
        TS.EngineConfig(backend="jnp", precision="int4", spike_capacity=8)
    TS.EngineConfig(backend="spike", precision="int4", spike_capacity=8)  # ok
    TS.EngineConfig(backend="delta", precision="int4", spike_capacity=8)  # ok


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("prune", [0.0, 0.4])
def test_complexity_equal_figures_for_equal_counters(merged, prune):
    """One counter vector through both packages' SparsityCounters:
    profile, accumulates, MMAC/s and the spike-broadcast report equal."""
    from repro.core.rsnn import RSNNConfig as JCfg
    from repro_torch.configs.rsnn_timit import PRUNED

    jcfg = JCfg(**{f.name: getattr(PRUNED, f.name)
                   for f in dataclasses.fields(PRUNED)})
    aux = {"spikes_l0": [410.0, 388.0], "spikes_l1": [301.0, 290.0],
           "union_l1": 402.0, "input_one_bits": 1234.0,
           "delta_propagated": 290.0, "delta_skipped": 30.0}
    kw = dict(num_ts=2, hidden_dim=128, input_dim=40, input_bits=8)
    cj, cp = j_complexity.SparsityCounters(**kw), \
        complexity.SparsityCounters(**kw)
    for c in (cj, cp):
        c.update(aux, active_frames=8.0)
        c.update(dict(aux, union_l1=380.0), active_frames=8.0)
    assert dataclasses.asdict(cp.profile()) == \
        dataclasses.asdict(cj.profile())
    prof_j, prof_p = cj.profile(), cp.profile()
    for sp_j, sp_p in ((None, None), (prof_j, prof_p)):
        kw = dict(merged_spike=merged, fc_prune_frac=prune)
        assert complexity.accumulates_per_frame(PRUNED, 2, sp_p, **kw) == \
            j_complexity.accumulates_per_frame(jcfg, 2, sp_j, **kw)
        assert complexity.mmac_per_second(PRUNED, 2, sparsity=sp_p, **kw) \
            == j_complexity.mmac_per_second(jcfg, 2, sparsity=sp_j, **kw)
        assert complexity.spike_broadcast_report(PRUNED, 2, sp_p, **kw) == \
            j_complexity.spike_broadcast_report(jcfg, 2, sp_j, **kw)
    assert cp.mmac_per_second(PRUNED, merged, prune) == \
        cj.mmac_per_second(jcfg, merged, prune)
