"""The port's dry run (``launch/dryrun.py``, ``launch/rsnn_cells.py``), its
op counter (``analysis/op_cost.py``) and the roofline that reads its
records (``benchmarks/roofline.py``, ``report.py``).

Here: ``cell_is_runnable`` against the reference's for every arch and
shape; the counter's peak of live bytes against peaks worked out by hand;
``run_cell`` / ``run_rsnn_cell`` writing the reference's tags and keys;
the roofline row against a hand computation at the H100 rates; the RSNN
tree and the ragged MoE on ``meta``; ``with_shardings`` against
``runtime/elastic.py`` ``shard_slices``.  The reference's
``launch/dryrun.py`` and ``launch/rsnn_cells.py`` are never imported: they
set ``XLA_FLAGS`` for 512 host devices at import, which would change the
device count of every later JAX test in the worker.  The counts against
the reference's ``hlo.analyze``: ``test_torch_dryrun_flops.py``,
``_train.py``, ``_rsnn.py``; meta against the CPU:
``test_torch_dryrun_meta.py``; bytes a device: ``test_torch_dryrun_bytes.py``.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as j_configs
from repro.analysis import hlo as j_hlo
from repro_torch import configs
from repro_torch.analysis.model_flops import model_flops
from repro_torch.analysis.op_cost import OpCost
from repro_torch.benchmarks import report, roofline
from repro_torch.core import rsnn
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, rsnn_cells
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.models.layers import moe
from repro_torch.models.layers.basic import ParamInit
from repro_torch.runtime.elastic import shard_slices
from test_torch_dryrun_flops import Reduced

ROOT = Path(__file__).resolve().parents[1]
ARCHS = registry.list_archs()
# the reference's record keys (launch/dryrun.py run_cell) but compile_s:
# the port traces and compiles nothing
RECORD_KEYS = {"arch", "shape", "mesh", "ok", "variant", "lower_s", "flops",
               "bytes_accessed", "cost_keys", "memory_analysis",
               "collectives", "tripaware", "num_devices", "hlo_size"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes"}


@pytest.fixture(autouse=True)
def no_registered_axes():
    shd.set_activation_axes(None)
    yield
    shd.set_activation_axes(None)


# ------------------------------------------------------- cell_is_runnable


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_is_runnable_equals_reference(arch):
    assert configs.LONG_CONTEXT_SKIP == j_configs.LONG_CONTEXT_SKIP
    for shape, j_shape in zip(configs.LM_SHAPES, j_configs.LM_SHAPES,
                              strict=True):
        assert configs.cell_is_runnable(arch, shape) == \
            j_configs.cell_is_runnable(arch, j_shape)


# --------------------------------------------------------- peak tracking


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_peak_of_a_hand_made_graph(dev):
    """Each step's live bytes worked out by hand (1 KiB float32 = 256
    elements); the argument ``x`` existed before and does not count."""
    k = 1024
    x = torch.ones(256, device=dev)
    with OpCost() as c:
        a = x * 2  # 1 KiB live
        b = a + 1  # 2
        del a  # 1
        v = b.view(16, 16)  # a view: 1
        del b  # the view holds the storage: 1
        y = torch.cat([v, v])  # 2 KiB more: 3 (the peak)
        del v  # b's storage freed: 2
        y.mul_(3)  # in place: 2
        s = y.sum()  # 4 B more
    r = c.result()
    assert r["peak_bytes"] == 3 * k
    assert r["live_bytes"] == 2 * k + 4
    assert r["ops"] == 6  # mul, add, view, cat, mul_, sum
    assert s.shape == ()


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_peak_holds_what_autograd_saved(dev):
    """``sigmoid`` saves its output for the backward: the 4 KiB tensor
    lives on after the caller drops it, until the gradient is taken."""
    k = 4096
    w = torch.ones(1024, device=dev, requires_grad=True)
    with OpCost() as c:
        y = w.sigmoid()  # 4 KiB, saved
        z = y * 2  # 8 (mul by a number saves nothing)
        del y  # saved: 8
        loss = z.sum()  # + 4 B
        del z  # 4 KiB + 4 B
        g, = torch.autograd.grad(loss, [w])
    r = c.result()
    # backward: ones_like (4 B), expand (a view), mul (4 KiB: the grad of
    # z), sigmoid_backward (4 KiB) beside the saved output and the loss
    assert r["peak_bytes"] == 3 * k + 8
    assert g.shape == w.shape


def test_flops_and_bytes_of_a_matmul_chain():
    x = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 16, device="meta")
    with OpCost() as c:
        y = (x @ w).relu()
        torch.exp(y)
    # mm 2 m n k, relu not in hlo.py's elementwise set, exp one an element
    assert c.flops == 2 * 64 * 16 * 32 + 64 * 16
    # mm reads x and w and writes y; relu and exp each read and write 64 x 16
    assert c.hbm_bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 + \
        2 * 2 * 64 * 16 * 4
    assert set(c.by_op) == {"mm", "relu", "exp"}


# --------------------------------------------------- meta allocation repairs


def test_rsnn_tree_on_meta():
    cfg = rsnn.RSNNConfig(hidden_dim=128)
    got = rsnn.init_params(torch.Generator(), cfg, device="meta")
    want = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
    for (p, a), (q, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(want), strict=True):
        assert a.device.type == "meta" and p == q
        assert (a.shape, a.dtype) == (b.shape, b.dtype), p
    st = rsnn.init_state(cfg, 8, device="meta")
    assert all(t.device.type == "meta" for t in (st.h0, st.h1, *st.lif0,
                                                 *st.lif1))
    assert st.h0.shape == (cfg.num_ts, 8, 128)
    with pytest.raises(ValueError):
        rsnn.init_state(cfg, 8, device="xpu")


@pytest.mark.parametrize("rows,e", [(256, 8), (7, 3), (2, 8), (0, 4)])
def test_even_expert_split(rows, e):
    sizes = moe._even_sizes(rows, e)
    assert len(sizes) == e and sum(sizes) == rows
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes,
                                                            reverse=True)


def test_ragged_moe_on_meta_splits_evenly(monkeypatch):
    cfg = registry.reduce_config(registry.get_model("deepseek-v3-671b").cfg)
    p = moe.init_moe(ParamInit(torch.Generator(), "meta"), cfg)
    seen = []
    real = moe._ragged_dot
    monkeypatch.setattr(moe, "_ragged_dot",
                        lambda xs, w, sizes: seen.append(sizes) or
                        real(xs, w, sizes))
    x = torch.empty(2, 5, cfg.d_model, dtype=cfg.dtype, device="meta")
    out = moe.moe_layer_ragged(x, p, cfg)
    assert out.shape == x.shape and out.device.type == "meta"
    m = cfg.moe
    assert seen == [moe._even_sizes(10 * m.top_k, m.num_experts)] * 3


# ------------------------------------------------------------ with_shardings


def test_with_shardings_blocks_are_shard_slices():
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    tree = {"w": torch.empty(8, 12, device="meta", dtype=torch.bfloat16),
            "b": torch.empty(6, device="meta"),
            "odd": torch.empty(10, 3, device="meta")}
    specs = {"w": shd.P("data", "model"), "b": shd.P("model"),
             "odd": shd.P(("data", "model"), None)}
    got = shd.with_shardings(tree, specs, mesh)
    for name in ("w",):
        blocks = {tuple(len(range(*s.indices(d))) for s, d in
                        zip(sl, tree[name].shape))
                  for sl in shard_slices(tuple(tree[name].shape),
                                         specs[name], mesh).values()}
        assert blocks == {got[name].block}
    assert got["w"].block == (4, 3) and got["w"].block_bytes == 24
    assert got["b"].block == (2,)  # 6 over 4 devices: the largest block
    assert got["odd"].block == (2, 3)  # 10 over 8: rounded up, as XLA pads
    assert (got["w"].shape, got["w"].dtype, got["w"].spec) == (
        (8, 12), torch.bfloat16, shd.P("data", "model"))


# -------------------------------------------------- records and the roofline


def test_run_cell_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "registry", Reduced)
    rec = dryrun.run_cell("gemma2-2b", "train_4k", False, tmp_path)
    assert rec["ok"], rec.get("traceback")
    saved = json.loads((tmp_path / "gemma2-2b__train_4k__pod.json")
                       .read_text())
    assert set(saved) == RECORD_KEYS
    assert set(saved["memory_analysis"]) == MEMORY_KEYS
    j_keys = set(j_hlo.analyze(
        "HloModule m\n\nENTRY %main () -> f32[] {\n"
        "  ROOT %c = f32[] constant(0)\n}\n"))
    t = saved["tripaware"]
    assert j_keys <= set(t)
    assert t["collective_total"] is None and saved["collectives"] is None
    n = saved["num_devices"]
    assert n == 256
    assert t["flops"] == t["flops_global"] / n == saved["flops"]
    assert t["hbm_bytes"] == t["hbm_bytes_global"] / n
    ma = saved["memory_analysis"]
    # the donated state comes back as the argument: aliased bytes are the
    # state's, the output its state and three replicated 0-d metrics
    assert ma["output_size_in_bytes"] == ma["alias_size_in_bytes"] + 12
    assert 0 < ma["alias_size_in_bytes"] < ma["argument_size_in_bytes"]
    assert t["hbm_bytes"] >= ma["argument_size_in_bytes"]
    assert "compile_s" not in saved and saved["lower_s"] >= 0


def test_skipped_cell_writes_nothing(tmp_path):
    rec = dryrun.run_cell("whisper-base", "long_500k", True, tmp_path)
    assert rec["skipped"] and rec["ok"]
    assert rec["reason"] == j_configs.cell_is_runnable(
        "whisper-base", j_configs.shape_by_name("long_500k"))[1]
    assert not list(tmp_path.iterdir())


def test_main_both_meshes_from_one_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "registry", Reduced)
    traces = []
    real = dryrun.trace
    monkeypatch.setattr(dryrun, "trace",
                        lambda step, args: traces.append(1) or
                        real(step, args))
    dryrun.main(["--arch", "zamba2-7b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path)])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert set(recs) == {"zamba2-7b__decode_32k__pod.json",
                         "zamba2-7b__decode_32k__multipod.json"}
    pod, multi = (recs[f"zamba2-7b__decode_32k__{m}.json"]
                  for m in ("pod", "multipod"))
    assert traces == [1]
    assert pod["tripaware"]["flops_global"] == \
        multi["tripaware"]["flops_global"]
    assert (pod["num_devices"], multi["num_devices"]) == (256, 512)
    assert multi["tripaware"]["flops"] * 2 == pod["tripaware"]["flops"]
    out = capsys.readouterr().out
    assert out.count(": ok") == 2
    dryrun.main(["--arch", "zamba2-7b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path),
                 "--skip-existing"])
    assert traces == [1]
    assert capsys.readouterr().out.count("[skip]") == 2


def test_run_rsnn_cell_record(tmp_path, monkeypatch):
    monkeypatch.setattr(rsnn_cells, "SERVE_BATCH", 512)
    rec = rsnn_cells.run_rsnn_cell("rsnn_serve", "paper_dp", True, tmp_path)
    assert rec["ok"], rec.get("traceback")
    saved = json.loads((tmp_path / "rsnn-timit__rsnn_serve__multipod__"
                        "paper_dp.json").read_text())
    assert set(saved) == RECORD_KEYS
    assert (saved["arch"], saved["variant"]) == ("rsnn-timit", "paper_dp")
    # paper_dp: parameters replicated, the 512 streams one a device
    ma = saved["memory_analysis"]
    cfg = rsnn_cells.RSNN_VARIANTS["paper_dp"]
    n_params = cfg.num_params + 4 * cfg.hidden_dim
    state = 2 * cfg.num_ts * cfg.hidden_dim + 4 * cfg.hidden_dim  # h, u, s
    assert ma["argument_size_in_bytes"] == 4 * (
        n_params + state + cfg.input_dim)


def _hand_row(rec: dict) -> dict:
    t, chips = rec["tripaware"], rec["num_devices"]
    mf = model_flops(rec["arch"], configs.shape_by_name(rec["shape"]))
    compute, memory = t["flops"] / 989e12, t["hbm_bytes"] / 3.35e12
    dom = "compute" if compute >= memory else "memory"
    return {"compute_s": compute, "memory_s": memory, "collective_s": None,
            "dominant": dom, "useful_fraction": mf / (t["flops"] * chips),
            "roofline_fraction": mf / chips / 989e12 / max(compute, memory)}


def test_roofline_and_report_read_the_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "registry", Reduced)
    for arch, shape in (("gemma2-2b", "train_4k"),
                        ("yi-6b", "decode_32k"), ("yi-6b", "long_500k")):
        dryrun.run_cells(arch, shape, [False], tmp_path / "dryrun_torch")
    monkeypatch.setattr(roofline, "RESULTS", tmp_path / "dryrun_torch")
    monkeypatch.setattr(report, "BASE", tmp_path)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    rows = roofline.table("pod")
    assert [(r["arch"], r["shape"]) for r in rows] == [
        ("gemma2-2b", "train_4k"), ("yi-6b", "decode_32k")]
    for row in rows:
        rec = json.loads((tmp_path / "dryrun_torch" / f"{row['arch']}__"
                          f"{row['shape']}__pod.json").read_text())
        want = _hand_row(rec)
        assert {k: row[k] for k in want} == pytest.approx(want, rel=1e-12)
        assert row["chips"] == 256
    md = roofline.markdown(rows).splitlines()
    assert md[0].startswith("| arch | shape | compute s | memory s | "
                            "collective s |")
    assert all(line.split(" | ")[4] == "—" for line in md[2:])
    out = report.dryrun_table("pod")
    assert "| gemma2-2b | train_4k | ok |" in out and "| — |" in out


@pytest.mark.parametrize("module", [
    "repro_torch.launch.dryrun", "repro_torch.launch.rsnn_cells",
    "repro_torch.analysis.op_cost", "repro_torch.benchmarks.roofline",
    "repro_torch.benchmarks.report"])
def test_imports_leave_jax_and_reference_out(module):
    code = (f"import os, sys, {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad; "
            "assert 'XLA_FLAGS' not in os.environ")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
