"""The meta trace is the program: ``analysis/op_cost.py`` counts the same
reduced step on CPU tensors (seeded weights and tokens, the step computed)
and on ``meta`` tensors (nothing computed), and the FLOPs, the bytes and
the peak of live bytes must be equal.

The ragged MoE is the one step whose ops depend on the data: on ``meta``
``moe_layer_ragged`` splits the routed rows evenly over the experts
(``_even_sizes``), on the CPU the routing's counts decide.  Its FLOPs are
still equal (each product is 2 rows D F however the rows split); its
bytes may differ by the weight slices of the experts that got rows on one
side and none on the other (read in the forward product and in the
backward's input gradient, written by the weight gradient: at most three
times a slice a product), plus the routing count (``bincount``: N k
int64 in, E out) that ``meta`` skips.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.models.layers import moe
from test_torch_dryrun_flops import BATCH, port_cost  # noqa: F401
from test_torch_dryrun_flops import reduced  # noqa: F401  (a fixture)

ARCHS = registry.list_archs()
SEQ = 32


def both(arch: str, kind: str, variant: str | None = None):
    return (port_cost(arch, kind, SEQ, BATCH, dev, variant)[0]
            for dev in ("meta", "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_counts_equal_cpu_counts(arch, kind):
    meta, cpu = both(arch, kind)
    assert meta.flops == cpu.flops
    assert meta.hbm_bytes == cpu.hbm_bytes
    assert meta.peak_bytes == cpu.peak_bytes
    assert {k: v for k, v in meta.by_op.items() if v[2]} == \
        {k: v for k, v in cpu.by_op.items() if v[2]}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_ragged_moe_meta_against_cpu(kind, monkeypatch):
    arch = "deepseek-v3-671b"
    calls = {"meta": [], "cpu": []}
    real = moe._ragged_dot

    def spy(xs, w, sizes):
        calls[xs.device.type].append((sizes, w[0].numel() * w.element_size()))
        return real(xs, w, sizes)

    monkeypatch.setattr(moe, "_ragged_dot", spy)
    meta, cpu = both(arch, kind, "ragged_moe")
    assert meta.flops == cpu.flops
    assert len(calls["meta"]) == len(calls["cpu"]) > 0
    moved = sum(3 * abs(sum(n == 0 for n in a) - sum(n == 0 for n in b)) * s
                for (a, s), (b, _) in zip(calls["meta"], calls["cpu"],
                                          strict=True))
    cfg = dryrun.registry.get_model(arch).cfg
    rows = BATCH * (1 if kind == "decode" else SEQ) * cfg.moe.top_k
    layers = len(calls["cpu"]) // 3  # gate, up and down a MoE layer
    routing = layers * 8 * (rows + cfg.moe.num_experts)
    assert cpu.by_op["bincount"][::2] == [layers, routing]
    assert "bincount" not in meta.by_op
    assert abs(cpu.hbm_bytes - meta.hbm_bytes) <= moved + routing
