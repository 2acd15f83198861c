"""The device an entry point runs on: ``cuda`` unless the caller asks for
``cpu``, and a CUDA device with no GPU present raises instead of carrying
on on the CPU.  Functions that only allocate a tree (a parameter init, a
cache) also take ``meta``: shapes and dtypes, nothing allocated."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no GPU present
    raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch serves on a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use cuda or cpu")
    return device


def resolve_alloc_device(device: torch.device | str) -> torch.device:
    """``resolve_device`` for a function that only allocates: ``meta`` is
    also taken (the port's ``jax.eval_shape``)."""
    device = torch.device(device)
    return device if device.type == "meta" else resolve_device(device)
