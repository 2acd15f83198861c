"""The paper's own deployed architecture: RSNN for TIMIT phoneme recognition.

Hidden 128 after structured pruning, FC 1920, two time steps; the FC is
pruned 40% unstructured and every weight stored at int4 (paper Table I,
Fig. 12).
"""
from repro_torch.core.rsnn import RSNNConfig

PRUNED = RSNNConfig(input_dim=40, hidden_dim=128, fc_dim=1920, num_ts=2)
