"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the program.  Each check runs in a fresh interpreter:
this one shares its process with tests that load JAX."""

import json
import subprocess
import sys

from bench_tiny import ROOT

BANNED = ("jax", "jaxlib", "flax", "repro")

PROBE = r"""
import importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
what = sys.argv[2]
if what == "reference":
    import bench.reference.compare, bench.reference.counts
    import bench.reference.data, bench.reference.model
else:
    import runpy
    runpy.run_path(str(root / "bench" / "run.py"), run_name="bench_run")
    import bench.harness, bench.program, bench.control, bench.drive
    import bench.families.rsnn, bench.sweep, bench.slot_trace
    for path in sorted((root / "bench" / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location("m" + path.stem.replace(".", "_"), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(sys.modules)))
"""


def loaded(what: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT), what],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def tops(names) -> set[str]:
    return {n.split(".")[0] for n in names}


def test_the_run_loads_no_jax_and_no_jax_package():
    names = loaded("run")
    assert "repro_torch" in tops(names)  # the program, by its whole name
    assert not tops(names) & set(BANNED), sorted(
        n for n in names if n.split(".")[0] in BANNED)


def test_the_reference_loads_nothing_of_the_program():
    t = tops(loaded("reference"))
    assert "repro_torch" not in t and not t & set(BANNED)


def test_no_source_reads_the_jax_packages_benchmarks():
    for path in (ROOT / "bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path
