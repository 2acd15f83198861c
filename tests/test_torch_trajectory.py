"""repro_torch's ``benchmarks/trajectory.py`` against the reference's
``benchmarks/trajectory.py`` on the CPU.

Both packages' ``validate_doc`` and ``compare_docs`` get the same
documents: the reference test's ``_doc``/``_cell`` fixtures
(``tests/test_loadgen.py``: schema v1/v2/v3, the ``backend`` and
``chunk_frames`` identity cases, the regression directions) and the
committed ``BENCH_6..10.json``, which are only read.  The two must return
equal results.  The subcommands run over a ``tmp_path`` that stands for
each package's trajectory directory (the reference's repository root, the
port's ``results/loadgen_torch``) and must exit with equal codes.  Neither
port module may import JAX, the JAX package or the repository's
``benchmarks/`` (a child process imports them).  No result here is a
time: the documents' numbers are the fixtures'.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.benchmarks import loadgen as t_loadgen
from repro_torch.benchmarks import trajectory as t_traj

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import trajectory as j_traj  # noqa: E402
from test_loadgen import _cell, _doc  # noqa: E402

BENCH = {i: ROOT / f"BENCH_{i}.json" for i in range(6, 11)}


def _v1():
    doc = _doc()
    doc["schema_version"] = 1
    del doc["cells"][0]["backend"]
    del doc["cells"][0]["chunk_frames"]
    del doc["cells"][0]["dispatches_per_frame"]
    doc["model"]["backend"] = "jnp"  # v1 carried the backend in the model
    return doc


def _v2():
    doc = _doc()
    doc["schema_version"] = 2
    del doc["cells"][0]["chunk_frames"]
    del doc["cells"][0]["dispatches_per_frame"]
    return doc


def _without(*path):
    def make():
        doc = _doc()
        parent = doc
        for k in path[:-1]:
            parent = parent[k]
        del parent[path[-1]]
        return doc

    return make


def _edit(fn):
    def make():
        doc = _doc()
        fn(doc)
        return doc

    return make


# name -> a document factory: valid ones and one for each schema error
DOCS = {
    "valid": _doc,
    "v1": _v1,
    "v2": _v2,
    "no git_sha": _without("git_sha"),
    "schema 99": _edit(lambda d: d.update(schema_version=99)),
    "no cells": _edit(lambda d: d.update(cells=[])),
    "no p99": _without("cells", 0, "frame_latency_us", "p99"),
    "duplicate key": _edit(lambda d: d["cells"].append(_cell())),
    "v2 without backend": _edit(lambda d: (d.update(schema_version=2),
                                           d["cells"][0].pop("backend"))),
    "v3 without chunk_frames": _without("cells", 0, "chunk_frames"),
    "v3 without dispatches": _without("cells", 0, "dispatches_per_frame"),
    "cell not an object": _edit(lambda d: d["cells"].append("cell")),
    "wrong type": _edit(lambda d: d["cells"][0].update(slots="2")),
    "delta backend": lambda: _doc(key="slots2-depth0-csc-delta-mesh1",
                                  backend="delta"),
    "chunk 4": lambda: _doc(key="slots2-depth0-csc-jnp-chunk4-mesh1",
                            chunk=4),
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_validate_doc_equals_reference(name):
    doc = DOCS[name]()
    got = t_traj.validate_doc(json.loads(json.dumps(doc)))
    assert got == j_traj.validate_doc(doc)
    assert (got == []) == (name in ("valid", "v1", "v2", "delta backend",
                                    "chunk 4"))


def test_validate_doc_refuses_a_non_object():
    assert t_traj.validate_doc("nope") == j_traj.validate_doc("nope") == \
        ["document is not a JSON object"]


def _other_machine(doc):
    doc["machine"] = {"platform": "other", "cpu_count": 64}
    return doc


def _other_workload(doc):
    doc["workload"] = {"seed": 1}
    return doc


# name -> (new, base, threshold): the reference test's comparisons
PAIRS = {
    "within threshold": (lambda: _doc(p50=120.0, p99=240.0), _doc, 0.5),
    "p99 doubles": (lambda: _doc(p99=400.0), _doc, 0.5),
    "saturation falls": (lambda: _doc(sat=10.0), _doc, 0.5),
    "throughput rises": (lambda: _doc(sat=200.0, tput=9000.0), _doc, 0.5),
    "threshold 1.5": (lambda: _doc(p99=400.0), _doc, 1.5),
    "other machine": (lambda: _other_machine(_doc(p99=900.0)), _doc, 0.5),
    "other workload": (lambda: _other_workload(_doc(p99=900.0)), _doc, 0.5),
    "unmatched cells": (
        lambda: _doc(key="slots4-depth0-csc-jnp-chunk1-mesh1"), _doc, 0.5),
    "v2 against v1": (lambda: _doc(p50=120.0), _v1, 0.5),
    "v3 against v2": (lambda: _doc(p50=120.0), _v2, 0.5),
    "chunk 4 against chunk 1": (
        lambda: _doc(key="slots2-depth0-csc-jnp-chunk4-mesh1", chunk=4),
        _doc, 0.5),
    "delta against delta": (
        lambda: _doc(key="slots2-depth0-csc-delta-mesh1", backend="delta",
                     p50=110.0),
        lambda: _doc(key="slots2-depth0-csc-delta-mesh1", backend="delta"),
        0.5),
    "delta against jnp": (
        lambda: _doc(key="slots2-depth0-csc-delta-mesh1", backend="delta"),
        _doc, 0.5),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_compare_docs_equals_reference(name):
    new, base, threshold = PAIRS[name]
    got = t_traj.compare_docs(new(), base(), threshold)
    assert got == j_traj.compare_docs(new(), base(), threshold)
    assert got["comparable"] == (name not in ("other machine",
                                              "other workload"))


def test_schema_constants_equal_reference():
    assert t_traj.SCHEMA_VERSION == j_traj.SCHEMA_VERSION == 3
    assert t_traj.SUPPORTED_SCHEMA_VERSIONS == \
        j_traj.SUPPORTED_SCHEMA_VERSIONS
    assert t_traj.COMPARED_METRICS == j_traj.COMPARED_METRICS
    assert t_traj.BENCH_NAME.pattern == j_traj.BENCH_NAME.pattern
    assert t_traj._REQUIRED_TOP == j_traj._REQUIRED_TOP
    assert t_traj._REQUIRED_CELL == j_traj._REQUIRED_CELL


@pytest.mark.parametrize("index", sorted(BENCH))
def test_committed_bench_files_validate_alike(index):
    doc = json.loads(BENCH[index].read_text())
    assert t_traj.validate_doc(doc) == j_traj.validate_doc(doc) == []
    assert t_traj.load_doc(BENCH[index]) == j_traj.load_doc(BENCH[index])
    for cell in doc["cells"]:
        assert t_traj._cell_identity(cell) == j_traj._cell_identity(cell)
    assert t_traj._model_identity(doc) == j_traj._model_identity(doc)


@pytest.mark.parametrize("new,base", [(7, 6), (8, 7), (9, 8), (10, 9),
                                      (10, 6)])
@pytest.mark.parametrize("threshold", [0.1, 0.5])
def test_committed_bench_files_compare_alike(new, base, threshold):
    a, b = (json.loads(BENCH[i].read_text()) for i in (new, base))
    got = t_traj.compare_docs(a, b, threshold)
    assert got == j_traj.compare_docs(a, b, threshold)
    assert got["fingerprint_match"]  # one machine wrote all five


@pytest.fixture(scope="module")
def port_doc(tmp_path_factory):
    """A one-cell document of the port's load generator on the CPU."""
    out = tmp_path_factory.mktemp("port") / "BENCH_1.json"
    assert t_loadgen.main([
        "--device", "cpu", "--slots", "2", "--depths", "0", "--layouts",
        "csc", "--backends", "jnp", "--chunks", "1", "--streams", "3",
        "--min-frames", "3", "--max-frames", "5", "--sat-iters", "0",
        "--hidden", "16", "--fc-dim", "32", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_port_document_against_bench_10_is_not_comparable(port_doc):
    """The port's machine fingerprint (torch, the device) is not the
    reference's CPU run's: the comparison is informational."""
    base = json.loads(BENCH[10].read_text())
    got = t_traj.compare_docs(port_doc, base, 0.5)
    assert got == j_traj.compare_docs(port_doc, base, 0.5)
    assert not got["comparable"] and not got["fingerprint_match"]
    assert not got["workload_match"]  # another model and workload too
    assert "torch" in port_doc["machine"] and "jax" not in port_doc["machine"]


def test_bench_files_numeric_order(tmp_path):
    for name in ("BENCH_10.json", "BENCH_2.json", "BENCH_6.json",
                 "BENCH_x.json", "notes.txt"):
        (tmp_path / name).write_text("{}")
    got = t_traj.bench_files(tmp_path)
    assert got == j_traj.bench_files(tmp_path)
    assert [p.name for p in got] == \
        ["BENCH_2.json", "BENCH_6.json", "BENCH_10.json"]
    for exclude in (tmp_path / "BENCH_10.json", None):
        assert t_traj.latest_baseline(tmp_path, exclude) == \
            j_traj.latest_baseline(tmp_path, exclude)
    assert t_traj.latest_baseline(tmp_path, tmp_path / "BENCH_10.json") \
        .name == "BENCH_6.json"


def test_bench_files_of_a_missing_directory(tmp_path):
    """The port's directory is made by the first run: before it, ``show``
    and ``compare`` find no baseline."""
    assert t_traj.bench_files(tmp_path / "missing") == []
    assert t_traj.latest_baseline(tmp_path / "missing") is None


def _write(path: Path, doc) -> str:
    path.write_text(json.dumps(doc))
    return str(path)


def _same_machine_regression(d: Path) -> list[str]:
    _write(d / "BENCH_1.json", _doc())
    return ["compare", _write(d / "new.json", _doc(p99=900.0))]


def _cross_machine(strict: bool):
    def argv(d: Path) -> list[str]:
        _write(d / "BENCH_1.json", _doc())
        new = _write(d / "new.json", _other_machine(_doc(p99=900.0)))
        return ["compare", new] + (["--strict"] if strict else [])

    return argv


def _show(d: Path) -> list[str]:
    for i, doc in ((2, _doc()), (10, _doc(p50=90.0))):
        _write(d / f"BENCH_{i}.json", doc)
    _write(d / "BENCH_3.json", {"schema_version": 1})  # shown as INVALID
    return ["show"]


# name -> (argv factory over the trajectory directory, exit code)
COMMANDS = {
    "show, nothing yet": (lambda d: ["show"], 0),
    "show": (_show, 0),
    "validate ok": (lambda d: ["validate", _write(d / "a.json", _doc())], 0),
    "validate errors": (
        lambda d: ["validate", _write(d / "a.json", DOCS["wrong type"]())],
        1),
    "compare, no baseline": (
        lambda d: ["compare", _write(d / "new.json", _doc())], 0),
    "compare, within threshold": (
        lambda d: ["compare", _write(d / "new.json", _doc(p50=120.0)),
                   "--baseline", _write(d / "base.json", _doc())], 0),
    "compare, same-machine regression": (_same_machine_regression, 1),
    "compare, other machine": (_cross_machine(False), 0),
    "compare, other machine, strict": (_cross_machine(True), 1),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_subcommands_exit_like_reference(name, tmp_path, monkeypatch,
                                         capsys):
    """Each subcommand over a directory standing for both packages'
    trajectory directory (the reference's ``ROOT``, the port's
    ``RESULTS``) exits with the reference's code."""
    argv_of, want = COMMANDS[name]
    argv = argv_of(tmp_path)
    monkeypatch.setattr(j_traj, "ROOT", tmp_path)
    monkeypatch.setattr(t_traj, "RESULTS", tmp_path)
    assert j_traj.main(argv) == want
    ref_out = capsys.readouterr().out
    assert t_traj.main(argv) == want
    out = capsys.readouterr().out
    if name == "show":
        assert out.count("INVALID") == ref_out.count("INVALID") == 1
        assert out.index("BENCH_2.json") < out.index("BENCH_10.json")


def test_module_imports_no_jax_repro_or_benchmarks():
    code = ("import sys\n"
            "import repro_torch.benchmarks.loadgen\n"
            "import repro_torch.benchmarks.trajectory\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'repro', 'benchmarks')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
