"""repro_torch's ``bench_megastep`` against the reference's, on the CPU
and on the reference's draws (``test_torch_bench_rows.py`` says how): the
op-table dispatches a frame of ``jnp``, ``pallas`` and ``fused`` on the
reduced 20 -> 64 -> 192 model (5, 5 and 1)."""

import torch_test_env  # noqa: F401  (first: one torch thread)

from test_torch_bench_rows import rows  # noqa: F401  (the fixture)


def test_bench_megastep_dispatches_equal_reference(rows):  # noqa: F811
    got, want = rows("bench_megastep")
    for backend, n in (("jnp", 5), ("pallas", 5), ("fused", 1)):
        assert got[backend]["dispatches_per_frame"] \
            == want[backend]["dispatches_per_frame"] == n
        assert got[backend]["launches_per_step"] == {}  # plain versions
        assert got[backend]["p50_us"] > 0
    assert got["dispatch_collapse"] == want["dispatch_collapse"] \
        == "5 -> 1 per frame"
