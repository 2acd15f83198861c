"""The RSNN family's own contract: the mixes and limits of its cells,
the keys it checks, and what its window records."""

import pytest

from bench_tiny import manifest

from bench import harness
from bench.families import rsnn

BENCH = manifest()  # BENCHMARK.json with the cells it leaves out put back
RSNN_CELLS = sorted(
    w["name"] for w in BENCH["workloads"]
    if harness.cell_files(BENCH, w["name"])[1]["family"] == "rsnn")


def test_the_benchmark_has_rsnn_cells():
    assert "rsnn-pruned-int4.dictation-backlog" in RSNN_CELLS


@pytest.mark.parametrize("cell", RSNN_CELLS)
def test_each_cell_has_a_mix_and_limits_the_family_takes(cell):
    _, cfg, mix, limits = harness.cell_files(BENCH, cell)
    assert harness.family(cfg) is rsnn
    rsnn.check_mix(mix)
    assert mix["mode"] in rsnn.MODES
    assert set(limits) == {"diverged_decided_pct", "min_checked_streams"}
    assert limits["diverged_decided_pct"] > 0
    assert limits["min_checked_streams"] >= 1


@pytest.mark.parametrize("mode", rsnn.MODES)
def test_a_mix_lacking_a_key_is_refused(mode):
    mix = {k: 1 for k in rsnn.MIX_KEYS + rsnn.MODE_KEYS[mode]}
    mix["mode"] = mode
    rsnn.check_mix(mix)
    for key in rsnn.MIX_KEYS + rsnn.MODE_KEYS[mode]:
        with pytest.raises(ValueError, match=key):
            rsnn.check_mix({k: v for k, v in mix.items() if k != key})


def test_a_mode_the_family_does_not_serve_is_refused():
    with pytest.raises(ValueError, match="mode"):
        rsnn.check_mix({"mode": "batch"})


def test_frames_by_second_counts_the_window_only():
    got = rsnn.Served()
    got.t0, got.t1 = 10.0, 13.0
    got.harvests = [(9.9, 100), (10.0, 5), (10.5, 7), (11.2, 11),
                    (12.99, 13), (13.0, 17), (13.1, 19)]
    assert got.frames_by_second() == [12, 11, 30]
    assert got.frames() == sum(got.frames_by_second())
