"""A second model family is added by new files alone, and the harness's
shared parts: the family found by name, the host's placement, the
set-up's timeline.

The toy family lives in a copy of ``bench/`` made for the test: a family
file, a configuration, a traffic file and a cell file, all new, and an
entry for each in a copy of ``BENCHMARK.json``, with ``tokens_per_s``
added for the toy cell as the first token cell adds it.  A run of its cell through ``harness.run`` on the
CPU gives a result line with ``tokens_per_s`` and ``setup_s``."""

import json
import shutil
import subprocess
import sys

import pytest

from bench_tiny import ROOT

from bench import families, harness

TOY_FAMILY = '''
"""A toy token family: a bigram table drawn from the seed answers each
prompt with greedy next tokens."""

import time

import torch


class Setup:
    def __init__(self, cfg, mix, seed, prompts, program):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.prompts, self.program = prompts, program


class Served:
    def __init__(self):
        self.e2e, self.attempted, self.failed = {}, 0, 0
        self.answers = []


def build(cfg, mix, seed, device, timeline):
    for key in ("prompt_tokens", "new_tokens", "requests"):
        if key not in mix:
            raise ValueError(f"toy traffic lacks {key}")
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(cfg["vocab"], cfg["vocab"], generator=g)
    prompts = torch.randint(0, cfg["vocab"],
                            (mix["requests"], mix["prompt_tokens"]),
                            generator=g)
    timeline.phase("weights")
    return Setup(cfg, mix, seed, prompts, table.to(device))


def greedy(table, prompt, n):
    out = [int(prompt[-1])]
    for _ in range(n):
        out.append(int(table[out[-1]].argmax()))
    return out[1:]


def serve(setup, window, spans, timeline):
    got = Served()
    mix, seconds = setup.mix, window.seconds
    window.settle()
    t0 = time.monotonic()
    window.open(t0, t0 + seconds)
    tokens = k = 0
    while time.monotonic() < t0 + seconds:
        i = k % len(setup.prompts)
        got.answers.append(
            (i, greedy(setup.program, setup.prompts[i], mix["new_tokens"])))
        tokens += mix["prompt_tokens"] + mix["new_tokens"]
        k += 1
    window.close()
    got.attempted = k
    got.e2e = {"tokens_per_s": tokens / seconds}
    return got


def check(setup, got, limits, device):
    g = torch.Generator().manual_seed(setup.seed)
    vocab = setup.cfg["vocab"]
    table = torch.randn(vocab, vocab, generator=g).tolist()
    wrong = 0
    for i, answer in got.answers[:limits["answers"]]:
        last = int(setup.prompts[i][-1])
        for token in answer:
            want = max(range(vocab), key=table[last].__getitem__)
            wrong += token != want
            last = want
    checks = {"wrong_tokens": {"value": wrong, "limit": 0}}
    return checks, wrong == 0, 0


def context(setup, got):
    return {}
'''

TOY_CONFIG = {"name": "toy-bigram", "source": "https://example.org/toy",
              "family": "toy", "vocab": 64, "reduced": []}
TOY_MIX = {"mode": "batch", "why": "one prompt after another",
           "prompt_tokens": 8, "new_tokens": 4, "requests": 16}
TOY_CELL = "toy-bigram.batch"

RUN = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from bench import harness
out = harness.run(sys.argv[3], 2 ** 31 + 7, 0.3, False, time.monotonic(),
                  device="cpu")
print(json.dumps(out))
"""


def toy_checkout(tmp_path):
    """A copy of the benchmark with the toy family added as new files."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "bench"
    new = {bench / "families" / "toy.py": TOY_FAMILY,
           bench / "configs" / "toy-bigram.json": json.dumps(TOY_CONFIG),
           bench / "traffic" / "batch.json": json.dumps(TOY_MIX),
           bench / "cells" / f"{TOY_CELL}.json":
               json.dumps({"limits": {"answers": 8}})}
    for path, text in new.items():
        assert not path.exists()
        path.write_text(text)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": TOY_CONFIG["name"], "source": TOY_CONFIG["source"],
        "file": "bench/configs/toy-bigram.json", "reduced": [],
        "why": "a toy token model"})
    manifest["workloads"].append({
        "name": TOY_CELL, "config": TOY_CONFIG["name"], "traffic": "batch",
        "chips": 1, "why": "prompts back to back"})
    manifest["end_to_end"].insert(0, {
        "name": "tokens_per_s", "unit": "tokens/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [TOY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def test_a_second_family_runs_from_new_files(tmp_path):
    root = toy_checkout(tmp_path)
    done = subprocess.run(
        [sys.executable, "-c", RUN, str(root), str(ROOT / "src"), TOY_CELL],
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    assert out["metrics"]["tokens_per_s"]["unit"] == "tokens/s"
    assert out["metrics"]["tokens_per_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["correct"] is True and out["attempted"] > 0
    assert out["checks"] == {"wrong_tokens": {"value": 0, "limit": 0}}
    assert list(out)[-1] == "checks"
    assert {"host_cpus", "host_node"} <= set(out["device"])
    # the numbers compared close standard error; set-up's phases come first
    err = done.stderr.strip().splitlines()
    assert err[-1] == "wrong_tokens: 0 (limit 0)"
    assert any(line.startswith("set-up phases (s): imports") and
               "weights" in line for line in err)


def test_tokens_per_s_waits_for_its_first_cell():
    """A metric's ``workloads`` may not be empty, so ``tokens_per_s``
    enters ``BENCHMARK.json`` with the first cell that reports it."""
    e2e = {m["name"]: m for m in harness.manifest()["end_to_end"]}
    assert "tokens_per_s" not in e2e
    for w in harness.manifest()["workloads"]:
        names = {m["name"] for m in
                 harness.cell_metrics(harness.manifest(), w["name"], False)}
        assert "tokens_per_s" not in names


@pytest.mark.parametrize("name", ["", "rsnn.x", "../rsnn", "1rsnn", None])
def test_a_family_is_found_by_module_name_only(name):
    with pytest.raises(ValueError):
        families.load(name)


def test_a_configuration_without_a_family_is_refused():
    with pytest.raises(harness.RunError, match="no family"):
        harness.family({"name": "x"})


@pytest.mark.parametrize("text, cpus", [
    ("0-3,8,10-11", {0, 1, 2, 3, 8, 10, 11}), ("5", {5}), ("", set()),
    ("0-7\n", set(range(8)))])
def test_cpulists(text, cpus):
    assert harness.parse_cpulist(text) == cpus
    assert harness.parse_cpulist(harness.cpulist(cpus)) == cpus


def test_host_reads_the_nodes_and_the_card(tmp_path, monkeypatch):
    for node, cpus in ((0, "0-3"), (1, "4-7")):
        d = tmp_path / "devices/system/node" / f"node{node}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpus + "\n")
    pci = tmp_path / "bus/pci/devices/0000:18:00.0"
    pci.mkdir(parents=True)
    (pci / "numa_node").write_text("1\n")
    monkeypatch.setattr(harness.os, "sched_getaffinity",
                        lambda pid: {2, 3, 4})
    got = harness.host("00000000:18:00.0", tmp_path)
    assert got == {"host_cpus": "2-4",
                   "host_node": {"cpus": [0, 1], "card": 1}}
    assert harness.host(None, tmp_path)["host_node"]["card"] is None
    assert harness.host("00000000:3B:00.0", tmp_path)["host_node"] == {
        "cpus": [0, 1], "card": None}


def test_timeline_durations_run_from_the_process_start(monkeypatch):
    now = iter([1.5, 4.0, 4.25])
    monkeypatch.setattr(harness.time, "monotonic", lambda: next(now))
    t = harness.Timeline(1.0)
    for name in ("imports", "weights", "warmup"):
        t.phase(name)
    got = t.durations(5.0)
    assert [n for n, _ in got] == ["imports", "weights", "warmup",
                                   "to_window"]
    assert [s for _, s in got] == pytest.approx([0.5, 2.5, 0.25, 0.75])


@pytest.fixture
def thaw():
    """Undo a settled window's ``gc.freeze``, as ``harness.run`` does."""
    yield
    harness.gc.unfreeze()


def _window():
    return harness.Window(0.1, harness.torch.device("cpu"), None,
                          harness.Timeline(0.0))


@pytest.mark.parametrize("steps", [(), ("settle",), ("settle", "open")])
def test_a_window_left_unfinished_is_refused(steps, thaw):
    w = _window()
    for step in steps:
        if step == "open":
            w.open(1.0, 1.1)
        else:
            getattr(w, step)()
    with pytest.raises(harness.RunError, match="unfinished"):
        w.verify()


def test_a_window_opened_before_set_up_settled_is_refused():
    w = _window()
    with pytest.raises(harness.RunError, match="before set-up settled"):
        w.open(1.0, 1.1)
    with pytest.raises(harness.RunError, match="before it opened"):
        w.close()


def test_a_settled_window_marks_set_up_and_verifies(thaw):
    w = _window()
    w.settle()
    w.open(1.0, 1.1)
    w.close()
    w.verify()
    assert [n for n, _ in w.timeline.phases] == ["settle"]
    assert (w.t0, w.t1) == (1.0, 1.1)


@pytest.mark.parametrize("mix, ok", [
    ({"mode": "batch", "requests": 3}, True), ({"mode": ""}, False),
    ({"rate": 1.0}, False), ({"mode": 7}, False)])
def test_traffic_load_checks_only_the_mode(tmp_path, monkeypatch, mix, ok):
    from bench import traffic

    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "m.json").write_text(json.dumps(mix))
    monkeypatch.setattr(traffic, "HERE", tmp_path)
    if ok:
        assert traffic.load("m") == mix
    else:
        with pytest.raises(ValueError, match="no mode"):
            traffic.load("m")


def test_a_run_whose_family_never_opens_the_window_is_refused(monkeypatch,
                                                              thaw):
    """The harness, not the family, sees that ``serve`` skipped the
    window's steps, and the run gives no result."""
    import types

    calls = []
    fam = types.SimpleNamespace(
        build=lambda cfg, mix, seed, device, timeline: types.SimpleNamespace(
            program=None),
        serve=lambda setup, window, spans, timeline: (
            window.settle(), types.SimpleNamespace(
                e2e={"tokens_per_s": 1.0}, attempted=1, failed=0))[1],
        check=lambda *a: calls.append("check"),
        context=lambda *a: {})
    monkeypatch.setattr(harness, "family", lambda cfg: fam)
    bench = {"end_to_end": [], "per_layer": []}
    cell = {"name": "x", "chips": 1}
    with pytest.raises(harness.RunError, match="unfinished"):
        harness.run("x", 1, 0.1, False, 0.0, device="cpu",
                    files=(cell, {"family": "x"}, {"mode": "m"}, {}),
                    bench=bench)
    assert calls == []
