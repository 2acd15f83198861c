"""The ``WeightLayout`` interface and registry.

A weight layout is how one packed 2-D weight is stored and executed at
deployment.  Each layout is one object owning its layout-specific
decisions:

  * ``pack`` / ``unpack``          — build the packed tensor from integer
    weights and their pruning mask, and dequantize it back to dense float;
  * ``matmul`` / ``fc_oracle``     — the plain PyTorch execution oracles;
  * ``fc_kernel``                  — the merged-spike readout through
    ``kernels/ops.py`` (a CUDA kernel on a CUDA tensor);
  * ``megastep_fc``                — the FC operands of the mega-step
    kernel (``kernels/megastep.py``, the ``fused`` backends);
  * ``stored_entries`` / ``size_bytes`` — the layout's part of
    ``sparse.packed_size_report`` (Fig. 12 accounting);
  * ``flatten`` / ``unflatten``    — the on-disk tensor codec of
    ``core/artifact.py``.

Layouts register by name; ``layout_of`` maps a packed tensor back to its
layout by type, so the packer, the serving op table and the artifact codec
resolve a tensor's layout from the tensor.  Three layouts are registered:
``dense``, ``csc`` and ``nm_group``.
"""

from __future__ import annotations

import abc

import numpy as np
import torch


class WeightLayout(abc.ABC):
    """One packed-weight storage format.  Stateless singletons: all
    per-tensor data lives in the packed tensor (``tensor_type``)."""

    name: str
    tensor_type: type

    @abc.abstractmethod
    def pack(self, q: torch.Tensor, scale: torch.Tensor, *, keep=None,
             spec=None):
        """Pack an int-quantized matrix ``q`` (K, N) with per-channel
        ``scale`` into this layout's tensor, on ``q``'s device.  ``keep``
        is the pruning mask deciding which entries are stored (storage
        follows the pruning decision even where a kept weight quantizes
        to 0); ``spec`` is the tensor's ``PruneSpec`` for layouts whose
        structure depends on it (the N:M group shape)."""

    @abc.abstractmethod
    def unpack(self, t, k_rows: int) -> torch.Tensor:
        """Dequantize back to the dense (k_rows, N) float32 matrix."""

    @abc.abstractmethod
    def matmul(self, x: torch.Tensor, t) -> torch.Tensor:
        """Plain oracle: ``x`` (B, K) @ packed -> (B, N) float32."""

    def fc_oracle(self, spikes_ts: torch.Tensor, t) -> torch.Tensor:
        """Merged-spike readout oracle: sum the (TS, B, H) spike trains
        over TS, then one layout matmul (paper §II-D2)."""
        merged = spikes_ts.sum(dim=0) if spikes_ts.dim() == 3 else spikes_ts
        return self.matmul(merged, t)

    @abc.abstractmethod
    def fc_kernel(self, spikes_ts: torch.Tensor, t) -> torch.Tensor:
        """Merged-spike readout through the layout's kernel."""

    def megastep_fc(self, t) -> tuple[str, tuple, dict]:
        """Operand binding for the mega-step kernel's FC stage:
        ``(fc_mode, operands, statics)``, where ``fc_mode`` selects the
        kernel's readout branch, ``operands`` are the tensors handed to it
        and ``statics`` extra keyword arguments.  A layout without a
        mega-step branch keeps this default, which leaves the ``fused``
        backends unavailable for the tensors it packs."""
        raise NotImplementedError(
            f"layout {self.name!r} has no mega-step FC binding; the "
            f"'fused' backend cannot serve this packed tensor")

    @abc.abstractmethod
    def stored_entries(self, t) -> float:
        """Entries the pruning decision stores (mask survivors): the
        Fig. 12 broadcast accounting, without index overhead."""

    @abc.abstractmethod
    def size_bytes(self, t, k_rows: int, bits: int = 4) -> float:
        """Deployed bytes of this layout, its index overhead included."""

    @abc.abstractmethod
    def flatten(self, t) -> dict[str, np.ndarray]:
        """Tensor -> named host arrays for ``tensors.npz`` (the inverse of
        ``unflatten``)."""

    @abc.abstractmethod
    def unflatten(self, fields: dict[str, torch.Tensor]):
        """Named arrays (as loaded from disk) -> the packed tensor."""


def host(t: torch.Tensor) -> np.ndarray:
    """A packed field as the host array ``flatten`` writes."""
    return t.detach().cpu().numpy()


_REGISTRY: dict[str, WeightLayout] = {}


def register_layout(layout: WeightLayout) -> WeightLayout:
    """Register a layout instance under ``layout.name`` (idempotent for the
    same instance; another instance under a taken name is an error —
    artifacts key tensors on these tags)."""
    existing = _REGISTRY.get(layout.name)
    if existing is not None and existing is not layout:
        raise ValueError(f"layout name {layout.name!r} is already "
                         f"registered by {type(existing).__name__}")
    _REGISTRY[layout.name] = layout
    return layout


def available_layouts() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_layout(name: str) -> WeightLayout:
    if name not in _REGISTRY:
        raise ValueError(f"unknown weight layout {name!r}; "
                         f"available: {available_layouts()}")
    return _REGISTRY[name]


def layout_of(t) -> WeightLayout:
    """The layout that owns packed tensor ``t`` (dispatch by type)."""
    for layout in _REGISTRY.values():
        if isinstance(t, layout.tensor_type):
            return layout
    raise TypeError(f"no registered weight layout packs {type(t).__name__}; "
                    f"available: {available_layouts()}")
