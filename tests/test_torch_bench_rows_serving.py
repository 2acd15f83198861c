"""repro_torch's engine and loop rows at ``PRUNED`` against the
reference's, on the CPU and on the reference's draws
(``test_torch_bench_rows.py`` says how).  ``bench_stream_engine``: the
L1 spike density of the 800 served frames; ``bench_stream_pipeline``: the
host syncs and dispatches a frame of the v1, v2 and chunked v2 loops over
the same 390 frames (2.0, 0.018, 1.0 and 0.133)."""

import torch_test_env  # noqa: F401  (first: one torch thread)

from test_torch_bench_rows import rows  # noqa: F401  (the fixture)


def test_bench_stream_engine_density_equals_reference(rows):  # noqa: F811
    got, want = rows("bench_stream_engine")
    assert got["l1_spike_density"] == want["l1_spike_density"]
    assert 0.0 < got["l1_spike_density"] < 1.0
    assert got["fc_kernel"] == "sparse_fc (plain PyTorch version on the CPU)"
    assert set(want) - set(got) == {"realtime_streams_cpu"}
    assert set(got) - set(want) == {"realtime_streams", "fc_kernel"}


def test_bench_stream_pipeline_counters_equal_reference(rows):  # noqa: F811
    got, want = rows("bench_stream_pipeline")
    fields = ("workload", "sync_host_syncs_per_frame",
              "pipelined_host_syncs_per_frame", "host_syncs_saved_per_frame",
              "pipelined_dispatches_per_frame",
              "chunked_dispatches_per_frame")
    assert {f: got[f] for f in fields} == {f: want[f] for f in fields}
    assert (got["sync_host_syncs_per_frame"],
            got["pipelined_host_syncs_per_frame"],
            got["pipelined_dispatches_per_frame"],
            got["chunked_dispatches_per_frame"]) == (2.0, 0.018, 1.0, 0.133)
    assert got["workload"] == "6 streams / 390 frames, 1 slot, int4"
