"""PyTorch + CUDA port of the streaming compressed-RSNN engine (``repro``).

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``serving/``) and imports only ``torch`` and ``numpy``: the JAX package is
the reference it is tested against, never a dependency.  Every Pallas
kernel on the served path is a hand-written CUDA C++ kernel under
``csrc/``, built for ``sm_90a`` at first use (``kernels/_build.py``).

Numerics: float32 matmuls run in full IEEE float32 — TF32 is switched off
for both cuBLAS and cuDNN here, so the plain PyTorch versions the kernels
are held against keep three more decimal digits than TF32 would give.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
