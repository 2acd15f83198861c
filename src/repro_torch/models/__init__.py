"""The token-LM families: the decoder LM (``transformer.py``, dense, MLA +
MoE and the VLM splice) and ``registry.py``, which resolves an arch name
to its ``ModelAPI``."""
