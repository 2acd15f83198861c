"""repro_torch's delta and spike-broadcast rows (``bench_delta``,
``bench_spike_broadcast``, the reduced 20 -> 64 -> 192 model) against the
reference's, on the CPU and on the reference's draws
(``test_torch_bench_rows.py`` says how).  The delta input densities and
the bit-identities are held equal; the MMAC/s, spike densities,
accumulates and argmax agreements, rounded to 4 decimals by the rows, are
held equal too: on these draws no potential lies near enough to a
threshold to flip a spike between the packages.  Eager loops
(``StreamLoop`` with ``aot_warmup=False``, as ``chip_smoke.py`` phase 12
runs the rows to hold each kernel launch) give the rows' fields
unchanged."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import functools

import pytest

from repro_torch.benchmarks import paper_tables as T
from repro_torch.serving.stream import StreamLoop
from test_torch_bench_rows import rows  # noqa: F401  (the fixture)

LOOPS = {"graphs": StreamLoop,
         "eager": functools.partial(StreamLoop, aot_warmup=False)}


def _untimed(d: dict) -> dict:
    """``d`` without its timings."""
    return {k: _untimed(v) if isinstance(v, dict) else v
            for k, v in d.items() if k != "p50_us"}


@pytest.mark.parametrize("loop", LOOPS)
def test_bench_delta_sweep_equals_reference(rows, monkeypatch,  # noqa: F811
                                            loop):
    monkeypatch.setattr(T, "StreamLoop", LOOPS[loop])
    got, want = rows("bench_delta")
    assert list(got["thresholds"]) == list(want["thresholds"]) \
        == ["thr_0", "thr_1", "thr_4", "thr_16"]
    for thr, w in want["thresholds"].items():
        g = got["thresholds"][thr]
        assert {k: g[k] for k in w} == w
    assert got["thresholds"]["thr_0"]["bit_identical"] is True
    assert got["thresholds"]["thr_0"]["max_abs_logit_diff"] == 0.0
    assert got["bit_identical_at_thr0"] is want["bit_identical_at_thr0"] \
        is True
    mmac = [t["mmac_per_s"] for t in got["thresholds"].values()]
    assert mmac == sorted(mmac, reverse=True)


@pytest.mark.parametrize("loop", LOOPS)
def test_bench_spike_broadcast_equals_reference(rows,  # noqa: F811
                                                monkeypatch, loop):
    monkeypatch.setattr(T, "StreamLoop", LOOPS[loop])
    got, want = rows("bench_spike_broadcast")
    for key in ("measured_density", "analytic_density",
                "accumulates_per_frame_measured",
                "accumulates_per_frame_analytic", "bit_identical_to_jnp"):
        assert got[key] == want[key], key
    assert got["bit_identical_to_jnp"] is True
    for backend in ("jnp", "spike", "fused", "fused_spike"):
        assert _untimed(got[backend]) == {
            "bit_identical": True, "max_abs_logit_diff": 0.0,
            "argmax_agreement": 1.0}
    m = got["accumulates_per_frame_measured"]
    assert m["gathered"] < m["dense"]
