"""Layers of the token LMs: norms, RoPE, MLPs and embeddings
(``basic.py``), attention, MLA, MoE, Mamba2 and the xLSTM blocks."""
