"""repro_torch's sharded serving (``serving/sharded.py``) on the CPU.

The slot batch split over a list of ``cpu`` devices stands in for the
reference's virtual devices.  Against the reference, in one process: the
port's ``ShardedStreamLoop`` over ``[cpu]`` and the reference's over a
1-device ``stream_mesh``, on one reference-written artifact, give the same
schedule, frame counts, densities and MMAC/s (``rtol=1e-6``) and logits
(``pallas`` bit-equal; ``ref`` within ``LOGIT_TOL``, a dequantized-weight
order).  Within the port: 8 ``cpu`` shards at 8 slots against the port's
single-device v1 ``StreamLoop``, over every backend of
``test_torch_pipeline.py`` at both precisions and the v1, v2 and chunked
contracts: the CPU runs each kernel's plain version, deterministic and
row by row independent of the batch, so the logits are bit-equal.  Then
the placement of ``distributed/sharding.py`` against the reference's
specs, the async front end, ``place_weights``, the validation errors and
``bench_stream_sharded``'s row.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.core import artifact as j_artifact
from repro.core import rsnn, sparse
from repro.core.compression import CompressionConfig, init_compression
from repro.core.rsnn import RSNNConfig
from repro.distributed import sharding as j_shd
from repro.serving import sharded as JSH
from repro.serving import stream as S
from repro_torch.benchmarks import paper_tables as T
from repro_torch.core import lif
from repro_torch.data.featurize import AsyncFeaturizer, cpu_quantizer
from repro_torch.distributed import sharding as shd
from repro_torch.serving import sharded as SH
from repro_torch.serving import stream as TS

ROOT = Path(__file__).resolve().parents[1]
CFG = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
LOGIT_TOL = 1e-5  # ref backend: x @ (q * s) vs (x @ q) * s rounding
DENSITY_RTOL = 1e-6  # shard counter sums add in another order
LENS = (5, 9, 3, 7, 6, 12, 4, 8, 10, 6, 0, 1, 11)
# (backend, delta_threshold, artifact): test_torch_pipeline.py's ENGINES
ENGINES = [(b, 0.0, "int4") for b in
           ("ref", "pallas", "sparse", "spike", "delta", "fused",
            "fused_spike")] + [("delta", 2.0, "int4")] + [
    (b, 0.0, "float") for b in
    ("ref", "pallas", "spike", "delta", "fused", "fused_spike")]
# contracts of the 8-shard loop, each held against the port's v1 loop
LOOPS = [dict(pipeline_depth=0), dict(pipeline_depth=2),
         dict(pipeline_depth=0, chunk_frames=2),
         dict(pipeline_depth=2, chunk_frames=2, ring_frames=4),
         dict(pipeline_depth=3, ring_frames=4, track_sparsity=False)]
# contracts held against the reference's sharded loop
REF_LOOPS = [dict(pipeline_depth=0), dict(pipeline_depth=2),
             dict(pipeline_depth=2, chunk_frames=2)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """Reference-written artifacts at ``CFG``'s widths: int4 with a
    40%-pruned CSC FC, and float."""
    tmp = tmp_path_factory.mktemp("sharded")
    params = rsnn.init_params(jax.random.PRNGKey(0), CFG)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 10, CFG.input_dim)), jnp.float32)
    scale = S.calibrate_input_scale(x, CFG.input_bits)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    packed = sparse.pack_model(params, CFG, ccfg,
                               init_compression(params, ccfg))
    return {"int4": j_artifact.save_artifact(
                tmp / "int4", cfg=CFG, packed=packed, ccfg=ccfg,
                input_scale=scale),
            "float": j_artifact.save_artifact(
                tmp / "float", cfg=CFG, params=params, input_scale=scale)}


def _utts(lens=LENS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(t, CFG.input_dim)).astype(np.float32)
            for t in lens]


def _port(paths, backend="pallas", threshold=0.0, art="int4"):
    eng = TS.CompiledRSNN.from_artifact(paths[art], device="cpu")
    return TS.CompiledRSNN.from_artifact(
        paths[art], dataclasses.replace(
            eng.engine, backend=backend, delta_threshold=threshold),
        device="cpu")


def _serve(loop, utts):
    sids = [loop.submit(u) for u in utts]
    done = {r.sid: r for r in loop.run()}
    return [done[s].stacked_logits() for s in sids]


def _flat(tree) -> list:
    """The leaves of a (nested) NamedTuple of specs, in field order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree for x in _flat(f)]
    return [tree]


# ------------------------------------------------ against the reference


@pytest.mark.parametrize("kw", REF_LOOPS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_one_shard_matches_reference_sharded_loop(paths, backend, kw):
    """The port's loop over ``[cpu]`` against the reference's over a
    1-device mesh: sid order, steps, host syncs, frame counts, densities
    and MMAC/s (``DENSITY_RTOL``), logits (``pallas`` bit-equal, ``ref``
    within ``LOGIT_TOL``)."""
    utts = _utts()
    ref = JSH.ShardedStreamLoop(
        S.CompiledRSNN.from_artifact(paths["int4"], backend=backend),
        batch_slots=3, mesh=JSH.stream_mesh(jax.devices()[:1]),
        max_frames=16, **kw)
    port = SH.ShardedStreamLoop(_port(paths, backend), batch_slots=3,
                                devices=["cpu"], max_frames=16, **kw)
    runs = []
    for loop in (ref, port):
        for u in utts:
            loop.submit(u)
        runs.append(loop.run())
    (dj, dp) = runs
    assert [r.sid for r in port.finished] == [r.sid for r in ref.finished]
    assert [r.sid for r in dp] == [r.sid for r in dj]
    assert (port.steps, port.dispatches, port.host_syncs) == \
        (ref.steps, ref.dispatches, ref.host_syncs)
    assert port.counters.frames == ref.counters.frames == sum(LENS)
    pj, pp = ref.sparsity_profile(), port.sparsity_profile()
    for field in ("l0_density", "l1_density", "input_bit_density",
                  "fc_union_density"):
        np.testing.assert_allclose(getattr(pp, field), getattr(pj, field),
                                   rtol=DENSITY_RTOL, err_msg=field)
    assert port.mmac_per_second() == pytest.approx(ref.mmac_per_second(),
                                                   rel=DENSITY_RTOL)
    for a, b in zip(dp, dj):
        if backend == "ref":
            np.testing.assert_allclose(a.stacked_logits(), b.stacked_logits(),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        else:
            np.testing.assert_array_equal(a.stacked_logits(),
                                          b.stacked_logits())


# ------------------------------------------------------- within the port


@pytest.mark.parametrize("backend,threshold,art", ENGINES)
def test_eight_shards_bit_equal_to_v1(paths, backend, threshold, art):
    """8 ``cpu`` shards at 8 slots, every contract of ``LOOPS``, against
    the port's single-device v1 loop: logits bit-equal, frames served,
    frame counts and densities (``DENSITY_RTOL``); each loop captures one
    step a shard, none during the serve, and leaves no step in flight."""
    eng = _port(paths, backend, threshold, art)
    utts = _utts()
    v1 = TS.StreamLoop(eng, batch_slots=8, pipeline_depth=0)
    want = _serve(v1, utts)
    prof = v1.sparsity_profile()
    for kw in LOOPS:
        before = eng.capture_count
        loop = SH.ShardedStreamLoop(eng, batch_slots=8, devices=["cpu"] * 8,
                                    max_frames=16, **kw)
        assert eng.capture_count == before + 8, kw
        got = _serve(loop, utts)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b, err_msg=str(kw))
        assert eng.capture_count == before + 8
        assert loop.pending_steps == 0
        assert loop.frames_served == v1.frames_served == sum(LENS)
        if loop.chunk_frames == 1:
            assert loop.steps == v1.steps
        if loop.track_sparsity:
            assert loop.counters.frames == v1.counters.frames
            got_prof = loop.sparsity_profile()
            for field in ("l0_density", "l1_density", "input_bit_density",
                          "fc_union_density", "delta_input_density"):
                np.testing.assert_allclose(
                    getattr(got_prof, field), getattr(prof, field),
                    rtol=DENSITY_RTOL, err_msg=f"{field} {kw}")


@pytest.mark.parametrize("backend", ["pallas", "delta"])
def test_placement_follows_reference_specs(paths, backend):
    """Each shard's leaves hold slots / 8 rows on the dimension that
    ``stream_state_specs`` names, which is where the reference's spec puts
    ``"data"``, for ``RSNNState`` and (``delta``) ``DeltaRSNNState``; the
    rings and frame buffers split on dimension 0; ``gather_state`` joins
    ``shard_state``'s parts back."""
    eng = _port(paths, backend)
    loop = SH.ShardedStreamLoop(eng, batch_slots=16, devices=["cpu"] * 8,
                                max_frames=8, pipeline_depth=2)
    ref_state = S.CompiledRSNN.from_artifact(paths["int4"],
                                             backend=backend).init_state(16)
    ref_specs = jax.tree.leaves(
        j_shd.stream_state_specs(ref_state),
        is_leaf=lambda s: isinstance(s, PartitionSpec))
    want = [list(s).index("data") if "data" in s else None
            for s in ref_specs]
    specs = shd.stream_state_specs(eng.init_state(16))
    assert _flat(specs) == want
    assert type(specs) is type(eng.init_state(16))
    for state in loop.shard_states:
        for leaf, dim in zip(TS._leaves(state), _flat(specs)):
            assert leaf.shape[dim] == 2 and leaf.device.type == "cpu"
    assert shd.stream_ring_spec() == list(j_shd.stream_ring_spec()).index(
        "data")
    for ring in loop.shard_rings:
        assert ring.shape == (2, 8, CFG.fc_dim)
    assert [sh.buf.shape for sh in loop._shards] == \
        [(2, 8, CFG.input_dim)] * 8
    g = torch.Generator().manual_seed(0)
    state = TS._tree_map(lambda t: torch.rand(t.shape, generator=g),
                         eng.init_state(16))
    parts = shd.shard_state(state, ["cpu"] * 4)
    assert all(TS._leaves(p)[0].shape == (CFG.num_ts, 4, CFG.hidden_dim)
               for p in parts)
    back = shd.gather_state(parts)
    for a, b in zip(TS._leaves(back), TS._leaves(state)):
        assert torch.equal(a, b)
    assert TS._leaves(parts[0])[0].data_ptr() != \
        TS._leaves(state)[0].data_ptr()  # copies
    with pytest.raises(ValueError, match="does not split"):
        shd.shard_state(state, ["cpu"] * 3)


@pytest.mark.parametrize("kw", [dict(pipeline_depth=2),
                                dict(pipeline_depth=2, chunk_frames=2)])
def test_async_front_end_bit_equal_to_raw_submit(paths, kw):
    """``AsyncFeaturizer.for_loop`` + ``submit_stream(quantized=True)``
    gives the logits of raw ``submit``, and the CPU quantizer equals the
    engine's ``quantize_features`` bit for bit."""
    eng = _port(paths, "pallas")
    utts = _utts()
    make = lambda: SH.ShardedStreamLoop(  # noqa: E731
        eng, batch_slots=4, devices=["cpu"] * 2, max_frames=16, **kw)
    want = _serve(make(), utts)
    loop = make()
    feat = AsyncFeaturizer.for_loop(loop, utts)
    sids = loop.submit_stream(feat, quantized=True)
    done = loop.run()
    assert sids == [r.sid for r in done]
    for a, r in zip(want, done):
        np.testing.assert_array_equal(a, r.stacked_logits())
    quant = cpu_quantizer(eng)
    for u in utts:
        assert np.array_equal(quant(u), eng.quantize_features(u).numpy())


def test_submit_stream_closes_the_featurizer_on_error(paths):
    def boom(u):
        raise RuntimeError("featurization failed")

    loop = SH.ShardedStreamLoop(_port(paths), batch_slots=2, devices=["cpu"],
                                max_frames=16)
    feat = AsyncFeaturizer(_utts(), boom, depth=2)
    with pytest.raises(RuntimeError, match="featurization failed"):
        loop.submit_stream(feat, quantized=True)
    feat._thread.join(timeout=5.0)
    assert not feat._thread.is_alive()


def test_place_weights_keeps_logits_and_places_every_tensor(paths):
    for art in ("int4", "float"):
        eng = _port(paths, "pallas", art=art)
        x = _utts((6, 6), seed=2)
        x = np.stack(x)
        want = eng.run(x)[0]
        eng.place_weights("cpu")
        assert eng.device == torch.device("cpu")
        leaves = []
        TS._tree_map(leaves.append, {
            "packed": eng.packed or {}, "dense": eng._ctx.dense,
            "quant": eng._ctx.quant, "sparse": eng._ctx.sparse,
            "lif": eng._lif, "scale": eng._input_scale})
        assert len(leaves) > 8
        assert all(t.device.type == "cpu" for t in leaves)
        assert torch.equal(eng.run(x)[0], want)
    with pytest.raises(RuntimeError, match="is_available"):
        eng.place_weights("cuda")


def test_validation_errors(paths):
    eng = _port(paths)
    loop = SH.ShardedStreamLoop(eng, batch_slots=2, devices=["cpu"],
                                max_frames=8)
    with pytest.raises(ValueError, match="input_dim"):
        loop.submit(np.zeros((5, CFG.input_dim + 1), np.float32))
    with pytest.raises(ValueError, match="input_dim"):
        loop.submit(np.zeros((CFG.input_dim,), np.float32))
    with pytest.raises(ValueError, match="max_frames"):
        loop.submit(np.zeros((9, CFG.input_dim), np.float32))
    for slots in (0, 3):
        with pytest.raises(ValueError, match="multiple"):
            SH.ShardedStreamLoop(eng, batch_slots=slots,
                                 devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="nonempty"):
        SH.stream_mesh([])


def test_default_devices_are_cuda_and_raise_without_it(paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        SH.stream_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        SH.ShardedStreamLoop(_port(paths), batch_slots=2)
    with pytest.raises(RuntimeError, match="is_available"):
        T.bench_stream_sharded()
    with pytest.raises(RuntimeError, match="is_available"):
        lif.init_lif(4)
    with pytest.raises(RuntimeError, match="is_available"):
        lif.init_lif_state(2, 4)
    assert lif.init_lif_state(2, 4, device="cpu").u.shape == (2, 4)


def _reference_row_keys() -> tuple[set, set]:
    """The keys of the reference's ``bench_stream_sharded`` row and of its
    ``sparsity_profile``, read from ``benchmarks/paper_tables.py``."""
    tree = ast.parse((ROOT / "benchmarks" / "paper_tables.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "bench_stream_sharded")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    row = ret.value.elts[1]
    prof = row.values[[k.value for k in row.keys].index("sparsity_profile")]
    return {k.value for k in row.keys}, {k.value for k in prof.keys}


def test_bench_stream_sharded_row_on_the_cpu():
    us, row = T.bench_stream_sharded(device="cpu")
    keys, prof_keys = _reference_row_keys()
    assert set(row) == keys and set(row["sparsity_profile"]) == prof_keys
    rng = np.random.default_rng(0)  # the reference's utterance draws
    lens = []
    for _ in range(8):
        lens.append(int(rng.integers(40, 101)))
        rng.normal(size=(lens[-1], T.PRUNED.input_dim))
    assert row["frames"] == sum(lens)
    assert (row["devices"], row["slots"]) == (1, 4)
    assert us > 0 and row["frames_per_s"] > 0
