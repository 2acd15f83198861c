"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it against the files that the harness finds by that name."""

import json
import re

import pytest

from bench_tiny import ROOT

from bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1] == "bench/run.py"
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_whys():
    everything = BENCH["configs"] + BENCH["workloads"] + \
        BENCH["end_to_end"] + BENCH["per_layer"]
    for item in everything:
        assert NAME.match(item["name"]), item["name"]
        for key in ("why", "layer", "source"):
            if key in item:
                assert 1 <= len(item[key]) <= 200 and "\n" not in item[key]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_configs_are_files_of_their_own_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and c["file"] not in files
        files.add(c["file"])
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        # a key cut from the source is a key of the configuration's file
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg, key
        assert cfg["reduced"] == c["reduced"]
        assert harness.family(cfg)


def test_each_cell_finds_its_files():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        # the family checks the mix and the limits (its own test)
        cell, cfg, mix, limits = harness.cell_files(BENCH, w["name"])
        assert isinstance(mix["mode"], str) and isinstance(limits, dict)
        assert harness.family(cfg)
        assert len(harness.cell_metrics(BENCH, w["name"], False)) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_contract():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        # a list of cells, if given, names at least one
        assert m.get("workloads", cells) and \
            set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["workloads"]
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], 0)
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert "reprox" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert "repro.core" in harness.banned_modules()
