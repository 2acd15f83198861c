"""repro_torch's paper tables vs the reference's ``benchmarks/paper_tables.py``.

The nine analytic tables read the same ``results.json`` in both packages
(the reference's through its ``RESULTS`` global, the port's through its
``results`` argument) and must agree ``==``, rows and derived dicts alike,
and as the JSON line ``benchmarks/run.py`` prints: the port's accelerator
model is held ``==`` to the reference's in ``test_torch_training.py``.
Three files: none at all, a payload made with numpy from a seed, and the
one ``examples/train_rsnn_timit_torch.py`` writes on the CPU at a tiny
size.  ``bench_rsnn_forward`` runs on the CPU only when asked to.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import complexity as J
from repro_torch.benchmarks import paper_tables as T
from repro_torch.core import complexity as C
from repro_torch.data.synthetic import SpeechDataConfig
from repro_torch.training.rsnn_pipeline import run_pipeline

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import paper_tables as j_tables  # noqa: E402
from benchmarks import run as bench_run  # noqa: E402

TABLES = [t.__name__ for t in T.ANALYTIC]
STAGES = ("baseline", "structured", "unstructured", "qat4")


def _seeded_payload(seed: int = 0) -> list[dict]:
    """Four stages with seeded metrics and densities, and a TS sweep; each
    profile serialized by both packages' ``SparsityProfile``."""
    rng = np.random.default_rng(seed)
    payload = []
    for name in STAGES:
        fields = dict(
            input_bit_density=float(rng.uniform(0.3, 0.6)),
            l0_density=tuple(float(d) for d in rng.uniform(0.05, 0.6, 2)),
            l1_density=tuple(float(d) for d in rng.uniform(0.05, 0.6, 2)),
            fc_density=tuple(float(d) for d in rng.uniform(0.05, 0.6, 2)),
            fc_union_density=float(rng.uniform(0.3, 0.7)),
            delta_input_density=float(rng.uniform(0.5, 1.0)))
        sparsity = dataclasses.asdict(C.SparsityProfile(**fields))
        assert sparsity == dataclasses.asdict(J.SparsityProfile(**fields))
        payload.append({
            "name": name, "error_rate": float(rng.uniform(0.8, 1.0)),
            "loss": float(rng.uniform(5.0, 8.0)),
            "size_bytes": float(rng.integers(10_000, 3_000_000)),
            "mmac_dense": float(rng.uniform(10.0, 150.0)),
            "mmac_skip": float(rng.uniform(1.0, 10.0)),
            "sparsity": sparsity})
    payload[-1]["ts_sweep"] = [
        {"time_steps": ts, "frame_error_rate": round(float(
            rng.uniform(0.8, 1.0)), 4)} for ts in (1, 2, 4)]
    return payload


@pytest.fixture(scope="module")
def example_results(tmp_path_factory) -> Path:
    """The example's results.json, as ``test_example_runs_on_the_cpu``
    runs the example: two steps a stage, widths 16/8, 4 frames, 48
    classes."""
    spec = importlib.util.spec_from_file_location(
        "train_rsnn_timit_torch",
        ROOT / "examples" / "train_rsnn_timit_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    small = SpeechDataConfig(frames=4, num_classes=48)
    example.SpeechDataConfig = lambda: small
    example.run_pipeline = lambda **kw: run_pipeline(
        hidden_base=16, hidden_pruned=8, data_cfg=small, **kw)
    out = tmp_path_factory.mktemp("example")
    assert example.main(["--steps", "2", "--batch", "2", "--device", "cpu",
                         "--out", str(out)]) == 0
    return out / "results.json"


@pytest.fixture(params=["none", "seeded", "example"])
def results_file(request, tmp_path, monkeypatch) -> Path:
    """A results path, and the reference's ``RESULTS`` pointed at it."""
    if request.param == "example":
        path = request.getfixturevalue("example_results")
    else:
        path = tmp_path / "results.json"
        if request.param == "seeded":
            path.write_text(json.dumps(_seeded_payload(), indent=1))
    monkeypatch.setattr(j_tables, "RESULTS", path)
    return path


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_reference(name, results_file):
    rows, derived = getattr(T, name)(results_file)
    want_rows, want_derived = getattr(j_tables, name)()
    assert rows == want_rows
    assert derived == want_derived
    assert json.dumps({"rows": rows, **derived}, default=str) == \
        json.dumps({"rows": want_rows, **want_derived}, default=str)
    payload = T._pipeline_results(results_file)
    if payload is not None:  # the loaded payload, passed as a list
        assert getattr(T, name)(payload) == (rows, derived)


def test_measured_sparsity_reads_either_packages_profile(results_file):
    got = T._measured_sparsity(results_file)
    want = j_tables._measured_sparsity()
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.delta_input_density == 1.0  # dropped, as the reference


def test_default_results_path_is_the_references():
    assert T.RESULTS == j_tables.RESULTS


def test_main_prints_run_py_lines(results_file, capsys):
    """``main`` prints what ``benchmarks/run.py`` prints for the analytic
    tables, then the ``bench_rsnn_forward`` row."""
    assert T.main(["--results", str(results_file), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    bench_run.main("table")  # table1_dimensions, table2_..., table3_power
    for name in TABLES:
        if "table" not in name:
            rows, derived = getattr(j_tables, name)()
            bench_run._emit(name, 0.0, {"rows": rows, **derived})
    want = capsys.readouterr().out.splitlines()
    assert lines[0] == want[0] == "name,us_per_call,derived"
    assert sorted(lines[1:1 + len(TABLES)]) == sorted(want[1:])
    name, us, derived = lines[-1].split(",", 2)
    assert name == "bench_rsnn_forward" and float(us) > 0
    assert set(json.loads(derived)) == {"us_per_frame", "realtime_streams"}


def test_bench_rsnn_forward_on_the_cpu():
    """The reference's row, timed on the port's golden model; its
    ``realtime_streams_cpu`` is ``realtime_streams`` here, since the
    port's row is timed on the card."""
    us, derived = T.bench_rsnn_forward(device="cpu", iters=2)
    _, want = j_tables.bench_rsnn_forward()
    assert sorted(derived) == sorted(k.removesuffix("_cpu") for k in want)
    assert derived["us_per_frame"] == round(us / 800, 2)
    assert derived["realtime_streams"] == int(800 / (us / 1e6) / 100)


def test_raises_without_a_gpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        T.bench_rsnn_forward()
    with pytest.raises(RuntimeError, match="is_available"):
        T.main(["--results", str(tmp_path / "none.json")])
    assert capsys.readouterr().out == ""


def test_benchmarks_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch.benchmarks.paper_tables; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]; print(bad); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
