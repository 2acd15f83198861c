"""End-to-end behaviour of the port: the paper's compression pipeline
(``repro_torch.training.rsnn_pipeline.run_pipeline``) improves over
chance, shrinks the model by the paper's ratios, and the spiking dynamics
stay sparse but alive — ``tests/test_system.py``'s four pipeline claims,
with its thresholds, at its settings (90 steps a stage, batch 16, hidden
64/32, 40 frames, 1920 classes, temporal training, seed 0) on the CPU.

Measured on a CPU at these settings (error rates of baseline / structured
/ unstructured / qat4; chance - 0.02 = 0.9795):

* the reference: 0.8984 / 0.9453 / 0.9076 / 0.9037, qat4 20,608 B of the
  baseline's 550,912, L0 densities (0.372, 0.389), L1 (0.396, 0.427), FC
  union 0.509; 37.5 s;
* the port: 0.8973 / 0.9609 / 0.9154 / 0.9063, 20,608 B of 550,912, L0
  (0.395, 0.412), L1 (0.362, 0.387), FC union 0.476; 67.6 s.

The claims, not the numbers, are asserted: float rounding differs between
the two packages and between devices over 360 steps of surrogate
back-propagation.  ``chip_smoke.py`` holds the same claims at the paper's
widths (256/128) on the card.  Slow tier: run with ``--runslow``.
"""

import pytest

from repro_torch.data.synthetic import SpeechDataConfig
from repro_torch.training.rsnn_pipeline import run_pipeline

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def pipeline_results():
    return run_pipeline(steps=90, batch_size=16, hidden_base=64,
                        hidden_pruned=32,
                        data_cfg=SpeechDataConfig(frames=40, num_classes=1920),
                        temporal=True, device="cpu")


def test_stages_present_and_learning(pipeline_results):
    names = [r.name for r in pipeline_results]
    assert names == ["baseline", "structured", "unstructured", "qat4"]
    chance = 1.0 - 1.0 / 1920
    for r in pipeline_results:
        assert r.error_rate < chance - 0.02, (r.name, r.error_rate)


def test_compression_ratios(pipeline_results):
    base, _, _, qat = pipeline_results
    # 4-bit + pruning + structure: >90% size reduction (paper: 96.42%)
    assert qat.size_bytes < 0.1 * base.size_bytes
    assert qat.mmac_skip < qat.mmac_dense  # zero-skip accounting active


def test_quantization_cost_small(pipeline_results):
    _, _, unstruct, qat = pipeline_results
    # paper Fig. 14: quantization costs ~0.1pt; slack on synthetic data
    assert qat.error_rate < unstruct.error_rate + 0.1


def test_spike_sparsity_in_paper_band(pipeline_results):
    sp = pipeline_results[-1].sparsity
    for d in (*sp.l0_density, *sp.l1_density):
        assert 0.02 < d < 0.7, d  # firing rates sparse but alive
    assert sp.fc_union_density <= min(1.0, sum(sp.fc_density))
