"""repro_torch's ``benchmarks/loadgen.py`` against the reference's
``benchmarks/loadgen.py`` on the CPU.

* bit for bit: the nearest-rank percentiles and their summary (seeded
  samples, the edge cases, the errors); ``Workload.materialize`` closed
  and open; the saturation search under the reference test's
  deterministic stub of ``run_workload`` (``tests/test_loadgen.py``),
  patched into both modules; the int4 engine that ``build_engine`` packs
  (its draw hook ``_seeded_params`` replaced by the reference's
  ``rsnn.init_params(PRNGKey(seed))``, carried across as numpy arrays);
* ``run_cell``'s keys and deterministic fields, ``main``'s document (both
  packages' ``validate_doc`` accept it), the machine fingerprint and the
  refusal without a GPU (``test_torch_trajectory.py`` holds that neither
  module imports JAX).

Timings are the CPU's and are compared with nothing.
``test_torch_loadgen_loops.py`` holds ``run_workload`` through every loop
against the reference's, with this file's configuration.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import rsnn as j_rsnn
from repro_torch.benchmarks import loadgen as t_loadgen
from repro_torch.benchmarks import trajectory as t_traj
from repro_torch.core.rsnn import RSNNConfig
from test_torch_bench_rows import reference_params
from test_torch_compression import _assert_packed_equal

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import loadgen as j_loadgen  # noqa: E402
from benchmarks import trajectory as j_traj  # noqa: E402
from test_loadgen import _StubLoop  # noqa: E402

SMOKE = dict(input_dim=20, hidden_dim=64, fc_dim=192, num_ts=2)
CFG = RSNNConfig(**SMOKE)
J_CFG = j_rsnn.RSNNConfig(**SMOKE)
WL = dict(seed=3, num_streams=5, min_frames=3, max_frames=9)
LOOPS = [(0, 1), (0, 4), (2, 1), (2, 4)]  # (pipeline_depth, chunk_frames)


# ----------------------------------------------------------- percentiles


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentiles_equal_reference(seed, n):
    xs = np.random.default_rng(seed).exponential(100.0, n).tolist()
    for p in (0, 1, 25, 50, 75, 95, 99, 99.9, 100):
        assert t_loadgen.nearest_rank(xs, p) == j_loadgen.nearest_rank(xs, p)
    assert t_loadgen.latency_stats(xs) == j_loadgen.latency_stats(xs)


@pytest.mark.parametrize("samples", [[10.0, 20.0, 30.0, 40.0],
                                     [40.0, 10.0, 30.0, 20.0], [7.0],
                                     list(range(1, 101)), []])
def test_percentile_edges_equal_reference(samples):
    for p in (0, 50, 75, 95, 99, 100):
        if samples:
            assert t_loadgen.nearest_rank(samples, p) == \
                j_loadgen.nearest_rank(samples, p)
    assert t_loadgen.latency_stats(samples) == \
        j_loadgen.latency_stats(samples)


@pytest.mark.parametrize("samples,p,match", [([1.0], 101, "percentile"),
                                             ([1.0], -1, "percentile"),
                                             ([], 50, "no samples")])
def test_percentile_errors_equal_reference(samples, p, match):
    for mod in (t_loadgen, j_loadgen):
        with pytest.raises(ValueError, match=match):
            mod.nearest_rank(samples, p)


# -------------------------------------------------------------- workload


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("rate", [None, 3.0, 250.0])
def test_workload_materialize_bit_equal(seed, rate):
    kw = dict(seed=seed, num_streams=6, min_frames=4, max_frames=11,
              rate=rate)
    (ut, ot), (uj, oj) = (mod.Workload(**kw).materialize(20)
                          for mod in (t_loadgen, j_loadgen))
    assert len(ut) == len(uj) == 6
    for a, b in zip(ut, uj):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ot, oj)
    tw, jw = t_loadgen.Workload(**kw), j_loadgen.Workload(**kw)
    assert tw.identity() == jw.identity()
    assert tw.mean_frames == jw.mean_frames


def test_constants_equal_reference():
    assert t_loadgen.BACKENDS == j_loadgen.BACKENDS
    assert t_loadgen.LAYOUT_TAGS == j_loadgen.LAYOUT_TAGS
    assert t_loadgen.INPUT_SCALE == j_loadgen.INPUT_SCALE
    assert [f.name for f in dataclasses.fields(t_loadgen.RunResult)] == \
        [f.name for f in dataclasses.fields(j_loadgen.RunResult)]
    ab = t_loadgen.deque_refill_ab(n=500)
    assert ab.keys() == j_loadgen.deque_refill_ab(n=500).keys()
    assert ab["queued_streams"] == 500 and ab["speedup"] > 0


# ----------------------------------------------------- saturation search


def _stub(mod, capacity: float):
    """The reference test's timing-free ``run_workload``, built on
    ``mod``'s ``RunResult``: arrivals beyond ``capacity`` streams/s pile
    up linearly."""

    def fake(loop, wl):
        backlog = int(max(0.0, wl.rate - capacity)) + 1
        return mod.RunResult(
            streams=wl.num_streams, frames=wl.num_streams * 4, wall_s=1.0,
            step_us=[10.0], completion_ms=[float(backlog)],
            queue_wait_ms=[0.0], max_backlog=backlog, steps=4, host_syncs=1,
            dispatches=4, frames_served=wl.num_streams * 4)

    return fake


@pytest.mark.parametrize("capacity,service,iters,slots", [
    (10.0, 10.0, 4, 2), (1e9, 10.0, 3, 2), (3.0, 10.0, 3, 2),
    (10.0, 10.0, 0, 2), (55.5, 40.0, 5, 8), (0.0, 7.0, 2, 1)])
def test_find_saturation_equals_reference(monkeypatch, capacity, service,
                                          iters, slots):
    """Equal probes (rates, backlogs, verdicts, p99s) and results: the
    bracket, the lower bracket's fallback and the bisection."""
    for mod in (t_loadgen, j_loadgen):
        monkeypatch.setattr(mod, "run_workload", _stub(mod, capacity))
    wl_kw = dict(seed=0, num_streams=8)
    got = t_loadgen.find_saturation(_StubLoop(slots), t_loadgen.Workload(
        **wl_kw), service, iters)
    want = j_loadgen.find_saturation(_StubLoop(slots), j_loadgen.Workload(
        **wl_kw), service, iters)
    assert got == want
    assert got["backlog_bound"] == max(2 * slots, 4)


# ---------------------------------------------------------------- engine


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's engines on the reference's ``init_params`` draws."""
    monkeypatch.setattr(t_loadgen, "_seeded_params", reference_params)


@pytest.mark.parametrize("layout", ["csc", "nm"])
@pytest.mark.parametrize("seed", [0, 5])
def test_build_engine_packs_like_reference(reference_draws, layout, seed):
    """The int4 layers, the 2:4 FC as CSC or N:M and the LIF constants
    bit-equal to the reference's in-process engine."""
    port = t_loadgen.build_engine(CFG, layout, seed, "jnp", device="cpu")
    ref = j_loadgen.build_engine(J_CFG, layout, seed, "jnp")
    _assert_packed_equal(port.packed, ref.packed)
    assert port.fc_prune_frac == ref.fc_prune_frac
    assert port.engine.sparse_fc and port.engine.precision == "int4"
    assert port._input_scale.item() == np.float32(j_loadgen.INPUT_SCALE)


def test_seeded_params_draw_on_the_cpu_generator():
    a, b = (t_loadgen._seeded_params(CFG, 0) for _ in range(2))
    for k in CFG.layer_shapes:
        assert a[k].device.type == "cpu" and torch.equal(a[k], b[k])
    assert not torch.equal(a["l0_wx"], t_loadgen._seeded_params(
        CFG, 1)["l0_wx"])


# ------------------------------------------------------ run_cell and main


def test_run_cell_fields_equal_reference(reference_draws):
    """One cell at ``sat_iters=0`` and one repetition: the reference's keys,
    and its deterministic fields equal (identity, counts, dispatches and
    host syncs a frame, sample counts, the measured sparsity and MMAC/s,
    the backlog bound)."""
    wl_kw = dict(WL, num_streams=4)
    got = t_loadgen.run_cell(
        t_loadgen.build_engine(CFG, "csc", 0, "jnp", device="cpu"), "csc",
        "jnp", 2, 0, 1, t_loadgen.Workload(**wl_kw), 0, 1, 1)
    want = j_loadgen.run_cell(
        j_loadgen.build_engine(J_CFG, "csc", 0, "jnp"), "csc", "jnp", 2, 0,
        1, j_loadgen.Workload(**wl_kw), 0, 1, 1)
    assert list(got) == list(want)
    assert list(got["saturation"]) == list(want["saturation"])
    for k in ("key", "slots", "pipeline_depth", "layout", "backend",
              "chunk_frames", "mesh", "streams", "frames",
              "dispatches_per_frame", "host_syncs_per_frame", "sparsity",
              "measured_mmac_per_s"):
        assert got[k] == want[k], k
    for k in ("frame_latency_us", "stream_completion_ms", "queue_wait_ms"):
        assert list(got[k]) == list(want[k])
        assert got[k]["n"] == want[k]["n"], k
    assert got["saturation"]["backlog_bound"] == \
        want["saturation"]["backlog_bound"]


def test_main_writes_a_document_both_packages_accept(tmp_path, capsys):
    out = tmp_path / "sub" / "BENCH_1.json"
    assert t_loadgen.main([
        "--device", "cpu", "--slots", "2", "--depths", "2", "--layouts",
        "nm", "--backends", "fused", "--chunks", "4", "--streams", "3",
        "--min-frames", "3", "--max-frames", "6", "--sat-iters", "0",
        "--hidden", "16", "--fc-dim", "32", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert t_traj.validate_doc(doc) == j_traj.validate_doc(doc) == []
    assert doc["bench"] == f"BENCH_{t_loadgen.BENCH_INDEX}"
    assert [c["key"] for c in doc["cells"]] == \
        ["slots2-depth2-nm-fused-chunk4-mesh1"]
    assert doc["model"] == {"input_dim": 40, "hidden_dim": 16, "fc_dim": 32,
                            "num_ts": 2, "precision": "int4",
                            "fc_prune": "2:4"}
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        t_loadgen.main(["--device", "cpu", "--backends", "fused_spike"])


def test_machine_fingerprint_names_the_device():
    fp = t_loadgen.machine_fingerprint("cpu")
    assert fp["device_platform"] == "cpu" and fp["device_count"] == 1
    assert fp["torch"] == torch.__version__ and "jax" not in fp
    assert {"platform", "python", "cpu_count", "cuda"} <= fp.keys()
    assert "device_name" not in fp and "power_limit" not in fp


def test_no_gpu_raises_without_falling_back():
    assert not torch.cuda.is_available()  # the CPU tests' machine
    with pytest.raises(RuntimeError, match="is_available"):
        t_loadgen.build_engine(CFG, "csc")
    with pytest.raises(RuntimeError, match="is_available"):
        t_loadgen.main(["--smoke"])
