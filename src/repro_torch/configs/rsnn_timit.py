"""The paper's own architecture: RSNN for TIMIT phoneme recognition.

``BASELINE`` is the uncompressed model of Table I: hidden 256, FC 1920,
two time steps, 698,368 float32 weights (2.79 MB).  ``PRUNED`` is the
deployed one: hidden 128 after structured pruning, the FC pruned 40%
unstructured and every weight stored at int4 (paper Table I, Fig. 12).
"""
from repro_torch.core.rsnn import RSNNConfig

BASELINE = RSNNConfig(input_dim=40, hidden_dim=256, fc_dim=1920, num_ts=2)
PRUNED = RSNNConfig(input_dim=40, hidden_dim=128, fc_dim=1920, num_ts=2)
CONFIG = PRUNED
