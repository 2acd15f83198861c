"""The useful-compute yardstick of the token-LM steps
(``model_flops.py``).  The reference's ``analysis/hlo.py`` parses XLA's
HLO text and has no PyTorch counterpart."""
