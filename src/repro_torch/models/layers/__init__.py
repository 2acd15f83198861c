"""Layers of the token LMs: norms, RoPE, MLPs and embeddings
(``basic.py``), attention, MLA and MoE."""
