"""Training: the optimizers and the paper's compression recipe."""
