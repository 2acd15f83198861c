"""The kernel yardstick: K6's bytes and operations, the peaks, and the
per-layer readers over a hand-made trace."""

import importlib.util
import json
from pathlib import Path

import pytest

from bench_tiny import ROOT

from bench.reference import counts
from bench.reference.model import dense_macs_per_frame

CONFIGS = ROOT / "bench" / "configs"


def config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FakeTrace:
    """Device operations (name, start_ns, end_ns) over a window."""

    def __init__(self, ops, t0, t1):
        self.ops, self.t0, self.t1 = ops, t0, t1

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    def busy_s(self):
        from bench.devtrace import DeviceTrace

        d = DeviceTrace()
        d.ops, d.t0, d.t1 = self.ops, self.t0, self.t1
        return d.busy_s()

    def time_s(self, sub):
        hit = [e - s for n, s, e in self.ops if sub in n]
        return sum(hit) / 1e9, len(hit)


def test_dense_macs_of_the_papers_models():
    # 40-128-128-1920 TS 2 with 60% of the FC kept; 40-256-256-1920 dense
    assert dense_macs_per_frame(config("rsnn-pruned-int4")) == pytest.approx(
        40 * 128 + 6 * 128 * 128 + 0.6 * 128 * 1920)
    assert dense_macs_per_frame(config("rsnn-baseline-float")) == \
        40 * 256 + 6 * 256 * 256 + 256 * 1920


def test_launch_bytes_by_hand():
    cfg = {"input_dim": 4, "hidden_dim": 8, "fc_dim": 16, "num_ts": 2,
           "precision": "int4", "fc_layout": "csc"}
    f, b, e = 3, 5, 6
    x = f * b * 4 * 4
    state_in = (2 * 2 * b * 8 + 4 * b * 8) * 4
    lif = 4 * 8 * 4
    w = (2 + 3 * 4) * 8 + 4 * 8 * 4 + e * 16 * 8 + 16 * 4
    out = (2 * 2 * b * 8 + 2 * b * 8) * 4 + f * b * 16 * 4 \
        + (2 * f * 2 * b + 2 * f * b) * 4
    assert counts.launch_bytes(cfg, b, f, e) == x + state_in + lif + w + out
    flt = dict(cfg, precision="float32", fc_layout="dense")
    assert counts.weight_bytes(flt, 0) == ((4 + 3 * 8) * 8 + 8 * 16) * 4
    with pytest.raises(ValueError):
        counts.weight_bytes(dict(cfg, fc_layout="nm"), 4)


def test_roofline_takes_the_larger_bound():
    cfg = {"precision": "int4"}
    assert counts.roofline_seconds(cfg, 2, 3.35e12, 0.0) == 2.0
    assert counts.roofline_seconds(cfg, 1, 0, 1979e12 * 3) == 3.0
    assert counts.roofline_seconds({"precision": "float32"}, 0, 0,
                                   67e12) == 1.0


def ctx_with(ops, frames=32768 * 10, dispatches=10, macs=1e5, seconds=1.0):
    cfg = config("rsnn-pruned-int4")
    mix = {"slots": 2048, "chunk_frames": 16}
    t = FakeTrace(ops, 0, int(seconds * 1e9))
    return {"cfg": cfg, "mix": mix, "trace": t,
            "open": {"dispatches": 0, "frames_served": 0, "host_syncs": 0,
                     "step_s": 0.0},
            "close": {"dispatches": dispatches, "frames_served": frames,
                      "host_syncs": 50, "step_s": 0.2},
            "macs_per_frame": macs, "fc_entries": 100}


def test_readers_on_a_hand_made_trace():
    k6 = "void megastep_kernel<2, 4, false>(Operands)"
    ops = [(k6, 0, 1_000_000), ("Memcpy DtoH", 500_000, 2_000_000),
           (k6, 5_000_000, 6_000_000)]
    ctx = ctx_with(ops)
    assert reader("device_idle_pct.backlog")(ctx) == pytest.approx(
        100 * (1 - 0.003))
    assert reader("device_ops_per_dispatch")(ctx) == pytest.approx(0.3)
    assert reader("loop_host_ms_per_dispatch.backlog")(ctx) == \
        pytest.approx(20.0)
    assert reader("host_syncs_per_kframe")(ctx) == pytest.approx(
        50e3 / 327680)
    cfg = ctx["cfg"]
    per_launch = counts.launch_bytes(cfg, 2048, 16, 100)
    ops_total = 2 * 1e5 * 32768 * 2
    bound = max(2 * per_launch / 3.35e12, ops_total / 1979e12)
    assert reader("k6_roofline")(ctx) == pytest.approx(
        100 * bound / 0.002)
    assert reader("mfu_pct")(ctx) == pytest.approx(
        100 * 2 * dense_macs_per_frame(cfg) * 327680 / 1979e12)


def test_readers_find_nothing_and_say_so():
    empty = ctx_with([], frames=0, dispatches=0)
    for name in ("device_idle_pct.open", "device_ops_per_dispatch",
                 "loop_host_ms_per_dispatch.open", "host_syncs_per_kframe",
                 "k6_roofline", "mfu_pct"):
        assert reader(name)(empty) is None
    no_k6 = ctx_with([("Memset (Device)", 0, 10)])
    assert reader("k6_roofline")(no_k6) is None
