"""The token-LM families: the decoder LM (``transformer.py``, dense, MLA +
MoE and the VLM splice), whisper's encoder-decoder (``encdec.py``), the
xLSTM LM (``ssm.py``), zamba2's Mamba2 hybrid (``hybrid.py``) and
``registry.py``, which resolves an arch name to its ``ModelAPI``."""
