"""repro_torch's group-packed N:M layout (``core/layouts/nm.py``), K5
``nm_fc``, the ``nm`` mode of K6/K7 ``megastep`` and the backends over an
N:M artifact vs the reference's, on the CPU.

The same seeded numpy inputs go through ``repro`` (the Pallas kernels in
interpret mode, their oracles, the reference's packer and reader) and
``repro_torch`` on CPU tensors (the plain versions the CUDA kernels are
held against on the card).  Tolerances:

* nibble decoding, the loaded arrays and every N:M readout are exact: the
  products are integers and the sums stay below 2**24, so K5's plain
  version equals the reference's kernel and oracle, and the same mask
  packed as CSC and as N:M gives equal logits, bit for bit;
* the mega-step in ``nm`` mode: spikes, counters and logits exact, ``u``
  within ``|d| <= 1e-5 * (1 + |y|)`` (``_close``: float32 sums of
  dequantized weights in another order);
* served frames follow ``test_torch_spike.assert_frames_match`` with
  exact logits (every readout here is an N:M integer sum).

No case relies on the reference's own bit-identity claims between its
backends, some of which fail on this JAX build.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artifact as j_artifact
from repro.core import layouts as j_layouts
from repro.core import rsnn, sparse
from repro.core.compression import (CompressionConfig, PruneSpec,
                                    init_compression, pruning)
from repro.core.compression.quantization import quantize_to_int
from repro.core.rsnn import RSNNConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import stream as S
from repro_torch.core import artifact as t_artifact
from repro_torch.core.layouts import nm as t_nm
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import nm_fc as nm_kernel
from repro_torch.serving import stream as TS
from test_torch_fused import _assert_outputs, _operands, _to_jax, _to_port
from test_torch_spike import _engines, assert_frames_match

NMS = [(1, 4), (2, 4), (3, 8)]
TAIL_CFG = RSNNConfig(input_dim=8, hidden_dim=18, fc_dim=12, num_ts=2)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _packed(h, n_out, n, m, seed):
    """The reference's N:M packing of a seeded int4 matrix under its
    magnitude mask, and the same mask as padded CSC."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(h, n_out)), jnp.float32)
    q, scale = quantize_to_int(w)
    mask = pruning.nm_prune_mask(w, n, m)
    nm_t = j_layouts.nm.pack_nm_groups(q, scale, mask, n, m)
    csc_t = j_layouts.get_layout("csc").pack(q, scale, keep=mask)
    return nm_t, csc_t


def _write(tmp_path, cfg, specs, name):
    """A reference-written int4 artifact whose tensors in ``specs`` are
    N:M-pruned and packed ``nm_group``."""
    params = rsnn.init_params(jax.random.PRNGKey(0), cfg)
    ccfg = CompressionConfig(weight_bits=4, prune_specs=specs)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 10, cfg.input_dim)), jnp.float32)
    packed = sparse.pack_model(params, cfg, ccfg,
                               init_compression(params, ccfg))
    return j_artifact.save_artifact(
        tmp_path / name, cfg=cfg, packed=packed, ccfg=ccfg,
        input_scale=S.calibrate_input_scale(x, cfg.input_bits),
        backend="sparse", sparse_fc=True)


@pytest.fixture(scope="module")
def nm_path(tmp_path_factory):
    """small_cfg's widths, fc_w 2:4 in the nm_group layout."""
    cfg = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
    return _write(tmp_path_factory.mktemp("nm"), cfg,
                  (("fc_w", PruneSpec(kind="nm", n=2, m=4)),), "nm")


@pytest.fixture(scope="module")
def mixed_path(tmp_path_factory):
    """Mixed-level pruning: l0_wh and fc_w both 2:4 nm_group."""
    cfg = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
    spec = PruneSpec(kind="nm", n=2, m=4)
    return _write(tmp_path_factory.mktemp("mixed"), cfg,
                  (("l0_wh", spec), ("fc_w", spec)), "mixed")


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("nm", NMS, ids=lambda v: f"{v[0]}of{v[1]}")
def test_split_nibbles_and_loaded_arrays_equal_reference(tmp_path, nm):
    """A hidden width of 18 leaves a tail group (18 % m == 2): the loaded
    tensor, its decoded values and offsets, and its rows equal the
    reference's bit for bit, and the engine takes it."""
    n, m = nm
    path = _write(tmp_path, TAIL_CFG,
                  (("fc_w", PruneSpec(kind="nm", n=n, m=m)),), "tail")
    got = t_artifact.load_artifact(path).packed.sparse["fc_w"]
    want = j_artifact.load_artifact(path).packed.sparse["fc_w"]
    assert isinstance(got, t_nm.NMGroupPacked)
    assert (got.n, got.m, got.rows) == (want.n, want.m, want.rows) \
        == (n, m, 18)
    assert got.packed.shape[0] == -(-18 // m) * n
    for field in ("packed", "scale", "count"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    val, off = t_nm.split_nibbles(got.packed)
    val_j, off_j = j_layouts.nm.split_nibbles(want.packed)
    assert val.dtype == torch.float32 and off.dtype == torch.int32
    np.testing.assert_array_equal(val.numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_j))
    rows = t_nm.entry_rows(got).numpy()
    assert rows.max() < 18
    np.testing.assert_array_equal(
        rows, (np.arange(rows.shape[0]) // n)[:, None] * m
        + np.asarray(off_j))
    TS.CompiledRSNN.from_artifact(path, backend="sparse", device="cpu")


def test_nm_index_bits_and_megastep_binding():
    assert [t_nm.nm_index_bits(m) for m in (1, 2, 4, 8, 16)] == \
        [j_layouts.nm.nm_index_bits(m) for m in (1, 2, 4, 8, 16)] \
        == [1, 1, 2, 3, 4]
    p = torch.zeros((4, 3), dtype=torch.int8)
    t = t_nm.NMGroupPacked(p, torch.ones((1, 3)), None, 2, 4, 8)
    mode, operands, statics = t_nm.NM_GROUP.megastep_fc(t)
    assert (mode, statics) == ("nm", {"nm_n": 2, "nm_m": 4})
    assert operands[0] is t.packed and operands[1] is t.scale


# ------------------------------------------------------------------- K5


@pytest.mark.parametrize("nm", NMS, ids=lambda v: f"{v[0]}of{v[1]}")
@pytest.mark.parametrize("h,n_out,b", [(18, 12, 4), (128, 1920, 8)],
                         ids=["tail", "pruned"])
def test_nm_fc_ref_bit_equal_to_reference(nm, h, n_out, b):
    """The port's plain K5 against the reference's Pallas ``nm_fc``
    (interpret mode) and its oracle, on (TS, B, H) trains and on
    pre-merged spikes: bit for bit."""
    n, m = nm
    t, _ = _packed(h, n_out, n, m, seed=h + n + m)
    s = (np.random.default_rng(7).random((2, b, h)) < 0.4).astype(np.float32)
    for x in (s, s.sum(axis=0)):
        got = ops.nm_fc(_t(x), _t(np.asarray(t.packed)),
                        _t(np.asarray(t.scale)), n=n, m=m).numpy()
        xj = jnp.asarray(x)
        np.testing.assert_array_equal(
            got, np.asarray(jops.nm_fc(xj, t.packed, t.scale, n=n, m=m)))
        np.testing.assert_array_equal(
            got, np.asarray(jref.nm_fc_ref(xj, t.packed, t.scale, n=n, m=m)))
    assert np.abs(got).max() > 0


def test_cpu_tensor_runs_plain_version_without_launching():
    before = nm_kernel.launches
    t, _ = _packed(16, 12, 2, 4, seed=0)
    args = (torch.ones((2, 3, 16)), _t(np.asarray(t.packed)),
            _t(np.asarray(t.scale)))
    assert ops.nm_fc(*args, n=2, m=4).shape == (3, 12)
    assert nm_kernel.launches == before
    assert _build._lib is None  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        nm_kernel.nm_fc(*args, n=2, m=4)


def _entries(h, n, m):
    return -(-h // m) * n


@pytest.mark.parametrize("nm", NMS, ids=lambda v: f"{v[0]}of{v[1]}")
@pytest.mark.parametrize("ts", [1, 2, 4])
@pytest.mark.parametrize("b", [256, 200, 1])
@pytest.mark.parametrize("h", [40, 128, 256])
def test_nm_fc_tile_plans_fit(nm, ts, b, h):
    """Every K5 plan for ``h`` rows packed N:M (2:4 gives 64 entries a
    column at h = 128; 3:8 has a tail group at h = 40 and, over the rows,
    wherever h is not a multiple of 8) and N = 1920: K4's tiles (32 or 64
    rows by 32, 64 or 128 columns), shared memory as ``NmTileLayout``
    computes it (the packed tile, its decoded offsets and values, the
    merged rows transposed with one pad column) and under 227 KB, and the
    grid; the picked plan is one of them."""
    entries = _entries(h, *nm)
    plans = nm_kernel.tile_plans(ts, b, h, entries, 1920)
    assert nm_kernel.tile_plan(ts, b, h, entries, 1920) in plans
    assert len(plans) == 6
    for p in plans:
        assert p.rows in (32, 64) and p.cols in (32, 64, 128)
        assert p.shared_bytes == (9 * entries * p.cols
                                  + 4 * h * (p.rows + 1))
        assert p.shared_bytes <= _build.MAX_SHARED_BYTES
        assert p.blocks == -(-1920 // p.cols) * -(-b // p.rows)


@pytest.mark.parametrize("nm", NMS, ids=lambda v: f"{v[0]}of{v[1]}")
def test_nm_fc_tile_plan_fills_the_card(nm):
    """At the served shape (B = 256, TS = 2, PRUNED's H = 128, N = 1920)
    K5's grid puts a block on each of the 132 SMs and leaves room for a
    second, at every geometry."""
    plan = nm_kernel.tile_plan(2, 256, 128, _entries(128, *nm), 1920)
    assert plan.blocks >= _build.SM_COUNT
    assert plan.shared_bytes <= _build.TWO_BLOCK_SHARED_BYTES


def test_nm_fc_entries_of_a_tail_group():
    """3:8 over 18 rows: two full groups and a tail of 2 rows, 9 entries a
    column, as the reference packs them and K5's plans count them."""
    t, _ = _packed(18, 12, 3, 8, seed=1)
    assert np.asarray(t.packed).shape[0] == _entries(18, 3, 8) == 9
    plan = nm_kernel.tile_plan(2, 4, 18, 9, 12)
    assert plan.shared_bytes == 9 * 9 * plan.cols + 4 * 18 * (plan.rows + 1)


# ------------------------------------------------------------- megastep


def _nm_operands(width, ts, frames, seed=41):
    """``test_torch_fused._operands`` with the FC 2:4-packed by the
    reference (``fcargs`` = (packed, scale (1, N)))."""
    args = _operands(width, ts, "dense_int4", frames=frames, seed=seed)
    h, n = args[2].shape[1], args[-1][0].shape[1]
    t, _ = _packed(h, n, 2, 4, seed=seed)
    return (*args[:-1], (np.asarray(t.packed), np.asarray(t.scale)))


@pytest.mark.parametrize("spike", [False, True])
@pytest.mark.parametrize("width,frames", [("small", 1), ("small", 3),
                                          ("pruned", 1)])
def test_megastep_ref_nm_matches_reference(width, frames, spike):
    """The port's plain K6/K7 in ``nm`` mode against the reference's
    Pallas mega-step (interpret, same ``spike`` mode) and its oracle, over
    chunks of 1 and 3 frames (one at ``PRUNED``'s widths)."""
    args = _nm_operands(width, 2, frames)
    kw = dict(fc_mode="nm", input_bits=8, nm_n=2, nm_m=4)
    got = ref.megastep_ref(*_to_port(args), **kw, spike=spike)
    _assert_outputs(got, jref.megastep_ref(*_to_jax(args), precision="int4",
                                           **kw), exact_logits=True)
    _assert_outputs(got, jops.megastep(*_to_jax(args), precision="int4",
                                       **kw, spike=spike), exact_logits=True)
    assert 0.05 < float(got[2].numpy().mean()) < 0.95  # the layers fire


@pytest.mark.parametrize("h,n_out", [(18, 12), (128, 1920)],
                         ids=["tail", "pruned"])
def test_same_mask_as_csc_and_nm_bit_equal(h, n_out):
    """Inside the port: one 2:4 mask packed as CSC and as N:M gives equal
    readouts (K4's and K5's plain versions) and equal mega-step logits."""
    t, c = _packed(h, n_out, 2, 4, seed=5)
    nm_args = (_t(np.asarray(t.packed)), _t(np.asarray(t.scale)))
    csc_args = tuple(_t(np.asarray(a)) for a in (c.indices, c.values,
                                                  c.scale))
    s = _t((np.random.default_rng(9).random((2, 6, h)) < 0.4)
           .astype(np.float32))
    a = ref.nm_fc_ref(s, *nm_args, n=2, m=4)
    assert torch.equal(a, ref.sparse_fc_ref(s, *csc_args))
    assert a.abs().max() > 0
    if h != 128:  # the mega-step at PRUNED's widths only
        return
    base = _to_port(_nm_operands("pruned", 2, 2))
    outs = [ref.megastep_ref(*base[:-1], fc, fc_mode=mode, input_bits=8,
                             **kw)
            for fc, mode, kw in ((nm_args, "nm", dict(nm_n=2, nm_m=4)),
                                 (csc_args, "csc", {}))]
    for x, y in zip(*outs):
        assert torch.equal(x, y)


# -------------------------------------------------------- served frames


@pytest.mark.parametrize("backend", ["sparse", "spike", "delta", "fused",
                                     "fused_spike"])
def test_frames_teacher_forced_over_nm_artifact(nm_path, backend):
    """``sparse_fc`` over the N:M FC: K5's plain version for ``sparse`` and
    ``spike``, the layout oracle for ``delta`` (threshold 0), the
    mega-step's ``nm`` mode for ``fused*``; logits bit-equal."""
    ref_eng, port = _engines(nm_path, backend, sparse_fc=True)
    assert isinstance(port.packed.sparse["fc_w"], t_nm.NMGroupPacked)
    assert_frames_match(ref_eng, port, exact_logits=True)


@pytest.mark.parametrize("backend", ["sparse", "fused"])
def test_frames_teacher_forced_over_mixed_level_artifact(mixed_path,
                                                         backend):
    """l0_wh and fc_w both N:M: the recurrent weights serve from their
    masked dense copies, the FC from the N:M layout."""
    art = t_artifact.load_artifact(mixed_path)
    assert art.layouts == {"l0_wh": "nm_group", "fc_w": "nm_group"}
    ref_eng, port = _engines(mixed_path, backend, sparse_fc=True)
    assert_frames_match(ref_eng, port, exact_logits=True)


def test_nm_streamloop_matches_reference_loop(nm_path, small_cfg):
    """A v1 StreamLoop of ``fused`` over the N:M artifact against the
    reference's: logits bit-equal, counters equal; ``fc_prune_frac`` read
    from the N:M spec."""
    rng = np.random.default_rng(5)
    utts = [rng.normal(size=(t, small_cfg.input_dim)).astype(np.float32)
            for t in (7, 10, 4, 6)]
    loops = []
    for eng, loop_cls in zip(_engines(nm_path, "fused", sparse_fc=True),
                             (S.StreamLoop, TS.StreamLoop)):
        loop = loop_cls(eng, batch_slots=2, pipeline_depth=0)
        for u in utts:
            loop.submit(u)
        loops.append((loop, loop.run()))
    (lj, dj), (lp, dp) = loops
    assert lp.engine.fc_prune_frac == 0.5
    assert dataclasses.asdict(lp.sparsity_profile()) == \
        dataclasses.asdict(lj.sparsity_profile())
    assert lp.mmac_per_second() == lj.mmac_per_second()
    for a, b in zip(dp, dj):
        np.testing.assert_array_equal(a.stacked_logits(), b.stacked_logits())


# ------------------------------------------------------ engine refusals


def _malformed(t: t_nm.NMGroupPacked):
    """One malformed copy of ``t`` per geometry ``_check_packed`` refuses
    (fc_w of small_cfg: K = 16, 2:4, 8 entries a column)."""
    bad_row = t.packed.clone()
    bad_row[-1] = (bad_row[-1] & 0xF) | (15 << 4)  # offset 15 in the last group
    return {
        "n=0": t._replace(n=0),
        "n>m": t._replace(n=5, m=4),
        "m>16": t._replace(n=2, m=17),
        "rows!=K": t._replace(rows=12),
        "entries": t._replace(packed=t.packed[:-2]),
        "row>=K": t._replace(packed=bad_row),
    }


@pytest.mark.parametrize("case", ["n=0", "n>m", "m>16", "rows!=K",
                                  "entries", "row>=K"])
def test_check_packed_refuses_malformed_geometry(nm_path, case):
    art = t_artifact.load_artifact(nm_path)
    t = art.packed.sparse["fc_w"]
    TS._check_packed(art.cfg, art.packed)  # the well-formed one passes
    packed = art.packed._replace(sparse={"fc_w": _malformed(t)[case]})
    with pytest.raises(ValueError, match="N:M"):
        TS._check_packed(art.cfg, packed)
    with pytest.raises(ValueError, match="N:M"):
        TS.CompiledRSNN(art.cfg, None, TS.EngineConfig(
            backend="sparse", precision="int4"), packed=packed, device="cpu")
