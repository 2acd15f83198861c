"""repro_torch kernels' plain versions vs the reference's Pallas kernels.

The same seeded numpy inputs go through ``repro.kernels.ops`` (the Pallas
kernels, interpret mode on the CPU) and ``repro_torch.kernels.ops`` on CPU
tensors (the plain PyTorch versions the CUDA kernels are held against on
the card).  K2-K4 sum integer-valued products and scale once, so they must
agree bit for bit; K1's recurrent sum of float32 weights depends on its
order, so u agrees within ``U_TOL`` and a spike may differ only where the
potential is within ``U_TOL`` of the threshold.  Widths: ``small_cfg``'s
and the paper's PRUNED model's.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import ctypes
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import int4_matmul as i4_kernel
from repro_torch.kernels import merged_spike_fc as mfc_kernel
from repro_torch.kernels import nm_fc as nm_kernel
from repro_torch.kernels import rsnn_cell as cell_kernel
from repro_torch.kernels import sparse_fc as sfc_kernel

U_TOL = 1e-5  # K1: |du| <= U_TOL * (1 + |u|)
# K2/K3 off the int8 domain (their fp32 path): |d| <= FP32_TOL * (1 + |y|),
# float32 sums in another order
FP32_TOL = 1e-5
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}

# (input_dim, hidden, fc_dim, batch): small_cfg's widths and PRUNED's
WIDTHS = {"small": (8, 16, 12, 4), "pruned": (40, 128, 1920, 8)}


def _packed(rng, k, n):
    return rng.integers(-128, 128, size=(k // 2, n)).astype(np.int8)


def _csc(rng, k, n, prune=0.4):
    keep = rng.random((k, n)) >= prune
    q = np.where(keep, rng.integers(-8, 8, size=(k, n)), 0)
    nnz = max(int(keep.sum(0).max()), 1)
    order = np.argsort(~keep, axis=0, kind="stable")[:nnz]
    taken = np.take_along_axis(keep, order, 0)
    vals = np.where(taken, np.take_along_axis(q, order, 0), 0)
    return (np.where(taken, order, 0).astype(np.int32),
            vals.astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def c_signature(source: str, name: str) -> list:
    """The ctypes of the parameters of ``extern "C" int name(...)`` in
    ``csrc/source``, in order: nothing else checks a wrapper's ctypes
    signature against the C one."""
    src = (CSRC / source).read_text()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src,
                    re.S).group(1)
    return [C_TYPES[" ".join(p.split()).rsplit(" ", 1)[0]]
            for p in sig.split(",")]


def _j(a):
    return jnp.asarray(a)


def test_unpack_int4_every_byte():
    """All 256 bytes: low nibble = even row, sign-extended, as the ref."""
    from repro.core.compression.quantization import unpack_int4 as j_unpack

    packed = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    got = ref.unpack_int4_ref(_t(packed)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_unpack(_j(packed))))
    assert got.dtype == np.int8 and got.min() == -8 and got.max() == 7


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("layer", ["l0", "l1"])
def test_int4_matmul_bitwise(width, layer):
    d, h, _, b = WIDTHS[width]
    rng = np.random.default_rng(11)
    if layer == "l0":  # 8-bit quantized inputs, M = B
        x = rng.integers(-128, 128, size=(b, d)).astype(np.float32)
    else:  # L0 spikes folded over TS, M = TS * B
        x = rng.integers(0, 2, size=(2 * b, h)).astype(np.float32)
    k = x.shape[1]
    packed = _packed(rng, k, h)
    scale = rng.uniform(0.001, 0.1, h).astype(np.float32)
    got = ops.int4_matmul(_t(x), _t(packed), _t(scale)).numpy()
    want = np.asarray(jops.int4_matmul(_j(x), _j(packed), _j(scale)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("ts", [1, 2])
def test_merged_spike_fc_bitwise(width, ts):
    _, h, n, b = WIDTHS[width]
    rng = np.random.default_rng(12 + ts)
    spikes = rng.integers(0, 2, size=(ts, b, h)).astype(np.float32)
    packed = _packed(rng, h, n)
    scale = rng.uniform(0.001, 0.1, n).astype(np.float32)
    got = ops.merged_spike_fc(_t(spikes), _t(packed), _t(scale)).numpy()
    want = np.asarray(jops.merged_spike_fc(_j(spikes), _j(packed),
                                           _j(scale)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("merged", [False, True])
def test_sparse_fc_bitwise(width, merged):
    _, h, n, b = WIDTHS[width]
    rng = np.random.default_rng(13)
    spikes = rng.integers(0, 2, size=(2, b, h)).astype(np.float32)
    if merged:  # a pre-merged (B, H) input is accepted too
        spikes = spikes.sum(axis=0)
    idx, vals = _csc(rng, h, n)
    scale = rng.uniform(0.001, 0.1, (1, n)).astype(np.float32)
    got = ops.sparse_fc(_t(spikes), _t(idx), _t(vals), _t(scale)).numpy()
    want = np.asarray(jops.sparse_fc(_j(spikes), _j(idx), _j(vals),
                                     _j(scale)))
    np.testing.assert_array_equal(got, want)


def test_sparse_fc_launch_signature_matches_the_kernel_source():
    assert c_signature("sparse_fc.cu", "sparse_fc_launch") == \
        sfc_kernel._ARGS


@pytest.mark.parametrize("h", [40, 128, 256])
@pytest.mark.parametrize("density", [0.6, 1.0])
@pytest.mark.parametrize("b,n", [(256, 1920), (200, 200), (1, 1920)])
def test_sparse_fc_tile_plan_fits(h, density, b, n):
    """K4's plan at hidden width ``h`` with ``density`` x h entries a
    column: tiles the launch takes, their shared memory as
    ``sparse_fc_launch`` computes it and under 227 KB, and the grid."""
    nnz = int(h * density)
    plan = sfc_kernel.tile_plan(2, b, h, nnz, n)
    assert plan.rows in (32, 64) and plan.cols in (32, 64, 128)
    assert plan.shared_bytes == 8 * nnz * plan.cols + 4 * h * (plan.rows + 1)
    assert plan.shared_bytes <= _build.MAX_SHARED_BYTES
    assert plan.blocks == math.ceil(n / plan.cols) * math.ceil(b / plan.rows)


@pytest.mark.parametrize("h,nnz", [(128, 95), (128, 128), (256, 154),
                                   (256, 256)])
def test_sparse_fc_tile_plan_fills_the_card(h, nnz):
    """At B = 256 and N = 1920 (PRUNED's FC at 40% pruning, lossless, and
    BASELINE's width) K4's grid puts a block on each of the 132 SMs and
    leaves room for a second."""
    plan = sfc_kernel.tile_plan(2, 256, h, nnz, 1920)
    assert plan.blocks >= _build.SM_COUNT
    assert plan.shared_bytes <= _build.TWO_BLOCK_SHARED_BYTES


def test_tile_plan_over_shared_memory_goes_to_the_launch_to_refuse():
    """No plan fits: the smallest goes to the launch function, which refuses
    it (status -2); there is no fallback."""
    plan = sfc_kernel.tile_plan(2, 256, 128, 4096, 1920)
    assert (plan.rows, plan.cols) == (32, 32)
    assert plan.shared_bytes > _build.MAX_SHARED_BYTES


def test_pick_tiles_order():
    """A block for every SM first, then two blocks an SM, then the fewest
    staged bytes, then the least shared memory, then the first listed."""
    P = _build.TilePlan
    few = P(1, 32, 100, 1024, 1, 0)
    full_big = P(2, 32, 200, 150 * 1024, 5, 0)
    full = P(3, 32, 200, 100 * 1024, 9, 0)
    lean = P(4, 32, 300, 100 * 1024, 7, 0)
    small = P(5, 32, 300, 50 * 1024, 7, 0)
    assert _build.pick_tiles([few, full_big]) is full_big
    assert _build.pick_tiles([few, full_big, full]) is full
    assert _build.pick_tiles([full, lean]) is lean
    assert _build.pick_tiles([lean, small]) is small
    assert _build.pick_tiles([small, P(6, 32, 300, 50 * 1024, 7, 0)]) is small
    assert _build.pick_tiles([few, P(7, 32, 120, 1024, 9, 0)]).rows == 7
    # a wavefront weighs WAVEFRONT_BYTES staged bytes
    w = _build.WAVEFRONT_BYTES
    assert _build.pick_tiles([P(8, 32, 200, 1024, 10 * w, 0),
                              P(9, 32, 200, 1024, 0, 9)]).rows == 9
    assert _build.pick_tiles([P(8, 32, 200, 1024, 10 * w, 0),
                              P(9, 32, 200, 1024, 0, 11)]).rows == 8


@pytest.mark.parametrize("source,name,module", [
    ("int4_matmul.cu", "int4_matmul_launch", i4_kernel),
    ("merged_spike_fc.cu", "merged_spike_fc_launch", mfc_kernel)])
def test_int4_launch_signatures_match_the_kernel_sources(source, name,
                                                         module):
    assert c_signature(source, name) == module._ARGS


@pytest.mark.parametrize("source,name,module", [
    ("rsnn_cell.cu", "rsnn_cell_launch", cell_kernel),
    ("nm_fc.cu", "nm_fc_launch", nm_kernel)])
def test_tiled_launch_signatures_match_the_kernel_sources(source, name,
                                                          module):
    assert c_signature(source, name) == module._ARGS


@pytest.mark.parametrize("ts", [1, 2, 4])
@pytest.mark.parametrize("b", [256, 200, 1])
@pytest.mark.parametrize("h", [40, 128, 256])
def test_rsnn_cell_tile_plans_fit(ts, b, h):
    """Every K1 plan at these shapes: tiles the launch takes (4-32 rows by
    16-64 neurons, at least one warp of 1 x 2 accumulator tiles), shared
    memory as ``CellLayout`` computes it (W's column tile and the rows'
    trains, k padded to 4, each train row 4 floats longer) and under 227
    KB, and the grid; the picked plan is one of them."""
    plans = cell_kernel.tile_plans(ts, b, h)
    assert cell_kernel.tile_plan(ts, b, h) in plans
    kp = -(-h // 4) * 4
    for p in plans:
        assert p.rows in (4, 8, 16, 32) and p.cols in (16, 32, 64)
        assert p.rows * p.cols // 2 >= 32
        assert p.shared_bytes == 4 * (kp * p.cols + ts * p.rows * (kp + 4))
        assert p.shared_bytes <= _build.MAX_SHARED_BYTES
        assert p.blocks == math.ceil(h / p.cols) * math.ceil(b / p.rows)


@pytest.mark.parametrize("h", [128, 256])
def test_rsnn_cell_tile_plan_fills_the_card(h):
    """At the served shapes (B = 256, TS = 2; PRUNED's H = 128 and
    BASELINE's 256) K1's grid puts a block on each of the 132 SMs and
    leaves room for a second."""
    plan = cell_kernel.tile_plan(2, 256, h)
    assert plan.blocks >= _build.SM_COUNT
    assert plan.shared_bytes <= _build.TWO_BLOCK_SHARED_BYTES


# K2's and K3's served shapes: (TS, rows, K, N) of the L0 and L1
# feed-forward, the FC at merged_spike=False (one train, K2) and the
# merged FC (K3, TS = 2)
INT4_SERVED = {"l0": (1, 256, 40, 128), "l1": (1, 512, 128, 128),
               "fc unmerged": (1, 256, 128, 1920),
               "fc merged": (2, 256, 128, 1920)}


def _int4_plans(ts, m, k, n):
    if ts == 1:
        return i4_kernel.tile_plans(m, k, n), i4_kernel.tile_plan(m, k, n)
    return (mfc_kernel.tile_plans(ts, m, k, n),
            mfc_kernel.tile_plan(ts, m, k, n))


@pytest.mark.parametrize("ts", [1, 2, 4])
@pytest.mark.parametrize("m,k,n", [(256, 40, 128), (512, 128, 128),
                                   (256, 128, 1920), (200, 128, 203),
                                   (1, 40, 1920)])
def test_int4_tile_plans_fit(ts, m, k, n):
    """Every K2/K3 plan at these shapes (up to TS = 4): tiles the launch
    takes, shared memory as ``Int4TileLayout`` computes it (float32
    trains, int8 rows and columns with K padded to 32 and 16 bytes a row,
    the packed tile) and under 227 KB, and the grid."""
    plans, picked = _int4_plans(ts, m, k, n)
    assert len(plans) == 15 and picked in plans
    kp = -(-k // 32) * 32
    for p in plans:
        assert p.rows in (16, 32, 64) and p.cols in (8, 16, 32, 64, 128)
        assert p.shared_bytes == (4 * ts * p.rows * kp
                                  + (p.rows + p.cols) * (kp + 16)
                                  + k // 2 * p.cols)
        assert p.shared_bytes <= _build.MAX_SHARED_BYTES
        assert p.blocks == math.ceil(m / p.rows) * math.ceil(n / p.cols)


@pytest.mark.parametrize("shape", INT4_SERVED)
def test_int4_tile_plan_fills_the_card(shape):
    """At every served shape the picked K2/K3 plan puts a block on each of
    the 132 SMs and leaves room for a second."""
    _, plan = _int4_plans(*INT4_SERVED[shape])
    assert plan.blocks >= _build.SM_COUNT
    assert plan.shared_bytes <= _build.TWO_BLOCK_SHARED_BYTES


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("domain", ["fraction", "out of range"])
def test_int4_matmul_off_the_int8_domain(width, domain):
    """The plain K2 against the reference's Pallas kernel on inputs the
    int8 tensor cores cannot take exactly, the domain of the CUDA kernel's
    fp32 path: non-integers, and integers outside [-128, 127] in one row
    (+-300), within ``FP32_TOL``."""
    d, h, _, b = WIDTHS[width]
    rng = np.random.default_rng(21)
    x = rng.integers(-128, 128, size=(b, d)).astype(np.float32)
    if domain == "fraction":
        x = x * np.float32(0.37) + rng.standard_normal((b, d)).astype(
            np.float32)
    else:
        x[1] = np.where(np.arange(d) % 2, -300.0, 300.0)
    packed = _packed(rng, d, h)
    scale = rng.uniform(0.001, 0.1, h).astype(np.float32)
    got = ops.int4_matmul(_t(x), _t(packed), _t(scale)).numpy()
    want = np.asarray(jops.int4_matmul(_j(x), _j(packed), _j(scale)))
    assert np.all(np.abs(got - want) <= FP32_TOL * (1.0 + np.abs(want)))


@pytest.mark.parametrize("width", WIDTHS)
def test_merged_spike_fc_off_the_int8_domain(width):
    """The plain K3 against the reference's Pallas kernel on trains that
    are not spikes (N(0, 1) values, merged far from integers), within
    ``FP32_TOL``."""
    _, h, n, b = WIDTHS[width]
    rng = np.random.default_rng(22)
    trains = rng.standard_normal((2, b, h)).astype(np.float32)
    packed = _packed(rng, h, n)
    scale = rng.uniform(0.001, 0.1, n).astype(np.float32)
    got = ops.merged_spike_fc(_t(trains), _t(packed), _t(scale)).numpy()
    want = np.asarray(jops.merged_spike_fc(_j(trains), _j(packed),
                                           _j(scale)))
    assert np.all(np.abs(got - want) <= FP32_TOL * (1.0 + np.abs(want)))


def _near_threshold(stim, s_prev, w, u0, h0, beta, vth):
    """(B, H) elements whose membrane is within U_TOL of the threshold at
    some time step (numpy float64 replay of the chain)."""
    stim = np.broadcast_to(stim, s_prev.shape).astype(np.float64)
    u, h, near = u0.astype(np.float64), h0, np.zeros(u0.shape, bool)
    for t in range(s_prev.shape[0]):
        u = stim[t] + s_prev[t] @ w + beta * u * (1.0 - h)
        near |= np.abs(u - vth) <= U_TOL * (1.0 + np.abs(u))
        h = (u >= vth).astype(np.float64)
    return near


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("broadcast", [True, False])
def test_rsnn_cell_within_tolerance(width, broadcast):
    """K1 plain vs the Pallas kernel.  ``broadcast`` feeds the L0 form: one
    (B, H) stimulus row expanded over TS as a stride-0 view."""
    _, h, _, b = WIDTHS[width]
    ts = 2
    rng = np.random.default_rng(14)
    if broadcast:
        row = rng.normal(size=(1, b, h)).astype(np.float32)
        stim_np = np.broadcast_to(row, (ts, b, h))
        stim_t = _t(row).expand(ts, b, h)
    else:
        stim_np = rng.normal(size=(ts, b, h)).astype(np.float32)
        stim_t = _t(stim_np)
    s_prev = rng.integers(0, 2, (ts, b, h)).astype(np.float32)
    w = (rng.normal(size=(h, h)) * 0.1).astype(np.float32)
    u0 = rng.normal(size=(b, h)).astype(np.float32)
    h0 = rng.integers(0, 2, (b, h)).astype(np.float32)
    beta = rng.choice([0.5, 0.75, 0.875], h).astype(np.float32)
    vth = rng.choice([0.5, 1.0, 2.0], h).astype(np.float32)
    args = (s_prev, w, u0, h0, beta, vth)
    sp, u = ops.rsnn_cell(stim_t, *map(_t, args))
    sp_j, u_j = jops.rsnn_cell(_j(np.ascontiguousarray(stim_np)),
                               *map(_j, args))
    sp_j, u_j = np.asarray(sp_j), np.asarray(u_j)
    near = _near_threshold(stim_np, *args)
    flipped = (sp.numpy() != sp_j).any(axis=0)
    assert not (flipped & ~near).any()
    ok = ~(flipped | near)
    np.testing.assert_allclose(u.numpy()[ok], u_j[ok], rtol=U_TOL,
                               atol=U_TOL)


def test_cpu_tensor_runs_plain_version_without_launching():
    rng = np.random.default_rng(15)
    before = (cell_kernel.launches, sfc_kernel.launches)
    idx, vals = _csc(rng, 16, 12)
    spikes = _t(rng.integers(0, 2, (2, 4, 16)).astype(np.float32))
    out = ops.sparse_fc(spikes, _t(idx), _t(vals), torch.ones(12))
    assert out.shape == (4, 12)
    assert (cell_kernel.launches, sfc_kernel.launches) == before
    assert _build._lib is None  # nothing was built


def test_other_device_and_cpu_operands_to_kernel_raise():
    """A tensor on neither CPU nor CUDA has no version to run, and a CUDA
    wrapper refuses CPU operands instead of computing on the host."""
    meta = torch.empty((2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.merged_spike_fc(meta, meta, meta)
    z = torch.zeros((2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        cell_kernel.rsnn_cell(z, z, torch.zeros(16, 16), z[0], z[0],
                              torch.ones(16), torch.ones(16))


def test_spike_ops_match_reference():
    """quantize_input (clipping included: the straight-through form need not
    equal q there), bitplanes and the merged-spike readout, bit for bit."""
    from repro.core import spike_ops as j_ops
    from repro_torch.core import spike_ops

    rng = np.random.default_rng(16)
    x = (rng.normal(size=(64, 40)) * 3).astype(np.float32)
    for scale in (None, np.float32(0.01)):  # 0.01 clips most values
        q, s = spike_ops.quantize_input(
            _t(x), 8, None if scale is None else torch.tensor(scale))
        qj, sj = j_ops.quantize_input(_j(x), 8,
                                      None if scale is None else _j(scale))
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(spike_ops.bitplanes(q).numpy(),
                                      np.asarray(j_ops.bitplanes(qj)))
    spikes = rng.integers(0, 2, (2, 8, 16)).astype(np.float32)
    w = rng.integers(-8, 8, (16, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        spike_ops.merged_spike_fc(_t(spikes), _t(w)).numpy(),
        np.asarray(j_ops.merged_spike_fc(_j(spikes), _j(w))))
