"""The useful-compute yardstick of the token-LM steps (``model_flops.py``)
and the op counter of the dry run (``op_cost.py``: FLOPs, eager bytes,
peak live bytes of a step, on ``meta`` or a device).  The reference's
``analysis/hlo.py`` parses XLA's HLO text and has no PyTorch counterpart;
``op_cost.py`` counts the same figures from the ops a step dispatches."""
