"""repro_torch's timed rows and ``run.py`` against the reference's
``benchmarks/`` on the CPU.

Each test replaces the port's two draw hooks (``_seeded_params``,
``_seeded_normal``) with the reference's draws (``rsnn.init_params(
PRNGKey(seed), cfg)``, ``jax.random.normal(PRNGKey(seed), shape)``,
carried across as numpy arrays), runs the reference's row and the port's
with ``device="cpu"`` on them and holds the deterministic fields equal.
Timings are ignored: both packages' ``time_us`` make one call.  On the CPU
the port runs the plain versions throughout, and each bit-identity a row
checks must hold there (the row raises otherwise; the tests assert the
reported values too).

This file: the kernel rows, the artifact round trip and ``run.py``;
``test_torch_bench_rows_serving.py`` the engine and loop rows,
``test_torch_bench_rows_megastep.py`` the mega-step row and
``test_torch_bench_rows_skip.py`` the delta and spike-broadcast rows.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rsnn as j_rsnn
from repro.kernels import ref as j_kref
from repro_torch.benchmarks import paper_tables as T
from repro_torch.benchmarks import roofline
from repro_torch.benchmarks import run as t_run
from repro_torch.core.lif import LIFParams
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import paper_tables as j_tables  # noqa: E402
from benchmarks import run as j_run  # noqa: E402


def reference_params(cfg, seed: int) -> dict:
    """The reference's ``init_params(PRNGKey(seed), cfg)`` as CPU
    tensors."""
    p = j_rsnn.init_params(jax.random.PRNGKey(seed),
                           j_rsnn.RSNNConfig(**dataclasses.asdict(cfg)))

    def t(a):
        return torch.from_numpy(np.array(a))

    return {k: LIFParams(*map(t, v)) if isinstance(v, tuple) else t(v)
            for k, v in p.items()}


def reference_normal(shape: tuple, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))


def one_call(fn, *args, iters: int = 20, **_kw) -> float:
    """``time_us`` for a test, which ignores timings: one call."""
    fn(*args)
    return 1.0


_REFERENCE: dict[str, dict] = {}  # a reference row's derived, by name


@pytest.fixture
def rows(monkeypatch):
    """``run(name) -> (port's derived, reference's derived)`` of one row
    on the reference's draws; the reference's row runs once a process."""
    monkeypatch.setattr(T, "_seeded_params", reference_params)
    monkeypatch.setattr(T, "_seeded_normal", reference_normal)
    monkeypatch.setattr(T, "time_us", one_call)
    monkeypatch.setattr(j_tables, "time_us", one_call)

    def run(name: str) -> tuple[dict, dict]:
        us, got = getattr(T, name)(device="cpu")
        assert us > 0
        if name not in _REFERENCE:
            _REFERENCE[name] = getattr(j_tables, name)()[1]
        return got, _REFERENCE[name]

    return run


def test_seeded_hooks_draw_on_the_cpu_generator():
    """The hooks' draws depend on the seed alone: the same on every call
    and CPU tensors whatever the caller's device."""
    cfg = T.SMALL
    a, b = T._seeded_params(cfg, 0), T._seeded_params(cfg, 0)
    assert a.keys() == b.keys() == {*cfg.layer_shapes, "lif0", "lif1"}
    for k in cfg.layer_shapes:
        assert a[k].device.type == "cpu" and torch.equal(a[k], b[k])
    assert not torch.equal(a["l0_wx"], T._seeded_params(cfg, 1)["l0_wx"])
    x = T._seeded_normal((4, 20), 1)
    assert x.device.type == "cpu" and torch.equal(x, T._seeded_normal(
        (4, 20), 1))


def test_bench_kernels_plain_version_equals_reference_oracle(rows):
    """``_merged_fc_inputs`` are the reference row's operands, and the
    port's K3 plain version gives its jnp oracle's output bit for bit."""
    got, want = rows("bench_kernels")
    assert got == {"kernel": "merged_spike_fc (plain PyTorch version on "
                             "the CPU)"}
    assert "merged_spike_fc" in want["kernel"]
    s, packed, scale = T._merged_fc_inputs()
    rng = np.random.default_rng(0)
    s_j = jnp.asarray(rng.integers(0, 2, (2, 128, 128)), jnp.float32)
    q = jnp.asarray(rng.integers(-8, 8, (128, 1920)), jnp.int8)
    packed_j = ((q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)).astype(jnp.int8)
    np.testing.assert_array_equal(s, np.asarray(s_j))
    np.testing.assert_array_equal(packed, np.asarray(packed_j))
    assert packed.dtype == np.int8 and scale.dtype == np.float32
    out = ops.merged_spike_fc(*map(torch.from_numpy, (s, packed, scale)))
    ref = j_kref.merged_spike_fc_ref(s_j, packed_j, jnp.ones((1920,)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bench_sparse_fc_profile_equals_reference(rows):
    got, want = rows("bench_sparse_fc")
    assert got["sparsity_profile"] == want["sparsity_profile"]
    assert got["sparsity_profile"]["fc_weight_density"] == 0.6
    assert got["kernel"] == "sparse_fc (plain PyTorch version on the CPU)"


def test_bench_nm_fc_bytes_and_bit_identity_equal_reference(rows):
    got, want = rows("bench_nm_fc")
    fields = ("nnz", "nm_group_bytes", "padded_csc_bytes",
              "bytes_saved_vs_csc", "bit_identical_to_csc")
    assert {f: got[f] for f in fields} == {f: want[f] for f in fields}
    assert (got["nnz"], got["nm_group_bytes"], got["padded_csc_bytes"]) \
        == (122880, 92160, 168960)
    assert got["bit_identical_to_csc"] is True


def test_bench_artifact_roundtrip_equals_reference(rows):
    """The artifact the port writes takes the reference's bytes on disk:
    the same arrays in ``tensors.npz`` and a manifest of the same length."""
    got, want = rows("bench_artifact_roundtrip")
    fields = ("broadcast_total_bytes", "schema_version",
              "bit_identical_vs_in_memory", "disk_bytes", "paper_fig12_bytes")
    assert {f: got[f] for f in fields} == {f: want[f] for f in fields}
    assert got["broadcast_total_bytes"] == 100864
    assert got["bit_identical_vs_in_memory"] is True


# ------------------------------------------------------------------ run.py


def test_all_names_equal_reference():
    assert t_run.all_names() == j_run.all_names()
    assert t_run.ANALYTIC == j_run.ANALYTIC
    assert t_run.TIMED == j_run.TIMED
    for _, fn in t_run.TIMED:
        assert callable(getattr(T, fn))


def test_list_entries_equal_reference(capsys):
    j_run.list_entries()
    want = capsys.readouterr().out
    t_run.list_entries()
    assert capsys.readouterr().out == want


def test_run_only_no_match_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as exc:
        t_run.main("zzz_no_such_bench", device="cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "matches no benchmark entry" in err
    for name in t_run.all_names():
        assert name in err  # the available names are listed for the fix


def test_run_only_single_analytic_entry(capsys):
    assert t_run.main("table1_dimensions", device="cpu") == 1
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln]
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 2 and lines[1].startswith("table1_dimensions,")
    assert "roofline_summary" not in out
    j_run.main("table1_dimensions")
    assert capsys.readouterr().out == out


def test_run_all_names_complete():
    names = t_run.all_names()
    assert "roofline_summary" in names
    assert "bench_stream_pipeline" in names
    assert len(names) == len(set(names))


def test_run_timed_entry_prints_its_row(monkeypatch, capsys):
    """A timed entry on the CPU: the CSV row of ``bench_kernels`` under
    the reference's entry name ``bench_merged_spike_fc``."""
    monkeypatch.setattr(T, "time_us", one_call)
    assert t_run.main("bench_merged_spike_fc", device="cpu") == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    name, us, derived = lines[1].split(",", 2)
    assert name == "bench_merged_spike_fc" and float(us) == 1.0
    assert json.loads(derived) == {
        "kernel": "merged_spike_fc (plain PyTorch version on the CPU)"}


def test_roofline_summary_reads_the_records(monkeypatch, capsys, tmp_path):
    """``roofline_summary`` goes over ``roofline.table("pod")``: one ok
    and one skipped single-pod record give 2 cells, 1 ok, and the ok
    one's fraction; a multi-pod record is not read."""
    rec = {"arch": "gemma2-2b", "shape": "train_4k", "ok": True,
           "num_devices": 256, "tripaware": {
               "flops": 2.5e13, "hbm_bytes": 1.2e12,
               "collective_total": None}}
    skip = {"arch": "gemma2-2b", "shape": "long_500k", "skipped": True,
            "reason": "full attention"}
    for name, r in (("a__train_4k__pod", rec), ("a__long_500k__pod", skip),
                    ("a__train_4k__multipod", rec)):
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)
    assert t_run.main("roofline", device="cpu") == 1
    lines = capsys.readouterr().out.splitlines()
    name, us, derived = lines[1].split(",", 2)
    frac = roofline.roofline_row(rec)["roofline_fraction"]
    assert (name, us) == ("roofline_summary", "0.00")
    assert json.loads(derived) == {
        "cells": 2, "ok": 1, "worst": [f"gemma2-2b/train_4k={frac:.4f}"]}


def test_run_cli_list_and_device(monkeypatch, capsys):
    """``--list`` prints the names; ``--device cuda`` with no GPU raises
    before any line is printed."""
    assert t_run.cli(["--list"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "table1_dimensions  [analytic]"
    assert "bench_spike_broadcast  [timed]" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        t_run.cli(["--device", "cuda", "--only", "bench_merged_spike_fc"])
    with pytest.raises(RuntimeError, match="is_available"):
        t_run.main("table1")  # the default device
    for row in ("bench_kernels", "bench_delta", "bench_spike_broadcast"):
        with pytest.raises(RuntimeError, match="is_available"):
            getattr(T, row)()
    assert capsys.readouterr().out == ""


def test_run_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch.benchmarks.run; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]; print(bad); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
