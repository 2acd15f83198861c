"""Deployment packer: float weights -> the packed-weight layouts.

The paper deploys a 0.1 MB model: structured pruning (256 -> 128), 40%
unstructured FC pruning and 4-bit weights, executed with zero-skipping
dataflows (§III-B).  ``pack_model`` turns a float parameter dict (with a
``CompressionConfig`` and its ``CompressionState``) into the
``PackedRSNN`` the serving engine runs, in torch on the device the
parameters lie on.  How each tensor is stored is owned by the
``core/layouts`` registry: every quantized weight gets the dense int4
layout (``QuantTensor``), and every masked weight also the sparse layout
its ``PruneSpec`` resolves to (padded CSC, or group-packed N:M).

Dequantization (``dequantize``) is bit-exact with the QAT fake-quant
(``compression.quantization.fake_quant``): ``round(w / s)`` held as int4
times the same scale.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.core import layouts
from repro_torch.core import lif as lif_lib
from repro_torch.core.compression import pruning
from repro_torch.core.compression.compress import (CompressionConfig,
                                                   CompressionState)
from repro_torch.core.compression.quantization import quantize_to_int
from repro_torch.core.layouts.csc import (SparseColumns, csc_size_bytes,
                                          csc_stored_entries, sparse_matmul,
                                          sparsify_columns)
from repro_torch.core.layouts.dense import QuantTensor, dequantize
from repro_torch.core.layouts.nm import NMGroupPacked
from repro_torch.core.rsnn import RSNNConfig

__all__ = [
    "QuantTensor", "SparseColumns", "NMGroupPacked", "PackedRSNN",
    "dequantize", "sparsify_columns", "sparse_matmul", "pack_model",
    "quant_size_bytes", "csc_stored_entries", "csc_size_bytes",
    "packed_size_report",
]


class PackedRSNN(NamedTuple):
    """Deployable compressed model.

    ``sparse`` maps each mask-pruned weight to its layout-resolved packed
    tensor; consumers dispatch on the tensor's type via
    ``layouts.layout_of``.
    """

    quant: dict  # name -> QuantTensor (every quantized 2-D weight)
    sparse: dict  # name -> layout tensor (pruned weights)
    lif: dict  # {beta0, vth0, beta1, vth1}: (H,) float32


def pack_model(params: dict, cfg: RSNNConfig, ccfg: CompressionConfig,
               cstate: CompressionState) -> PackedRSNN:
    """Pack a float model into the deployable compressed one, on the
    parameters' device.  Masks first, then quantization, as the QAT
    materializer does; each masked tensor's sparse layout comes from its
    ``PruneSpec`` (``layouts.resolve_for_spec``)."""
    spec = ccfg.quant_spec
    if spec is None:
        raise ValueError("pack_model needs weight_bits (e.g. 4) in ccfg")
    if spec.bits != 4:
        raise ValueError(
            f"packed format is nibble-int4; weight_bits={spec.bits} would be "
            f"silently truncated by pack_int4")
    p = pruning.apply_masks(params, cstate.masks)
    dense_layout = layouts.get_layout("dense")
    prune_specs = ccfg.resolved_prune_specs
    quant: dict[str, QuantTensor] = {}
    sparse: dict = {}
    for name in ccfg.quant_names:
        q, scale = quantize_to_int(p[name], spec)
        quant[name] = dense_layout.pack(q, scale)
        if name in cstate.masks:
            pspec = prune_specs.get(name)
            layout = layouts.resolve_for_spec(pspec)
            sparse[name] = layout.pack(q, scale, keep=cstate.masks[name],
                                       spec=pspec)
    lif = {}
    for i in (0, 1):
        beta, vth = lif_lib.inference_constants(params[f"lif{i}"],
                                                cfg.hw_rounded_lif)
        lif[f"beta{i}"] = beta
        lif[f"vth{i}"] = vth
    return PackedRSNN(quant=quant, sparse=sparse, lif=lif)


def quant_size_bytes(qt: QuantTensor, bits: int = 4) -> float:
    """Dense int4 storage (the paper's layout: no index overhead)."""
    k = qt.packed.shape[0] * 2
    return layouts.get_layout("dense").size_bytes(qt, k, bits)


def packed_size_report(packed: PackedRSNN, bits: int = 4) -> dict:
    """Per-tensor and total deployed bytes, dense int4 against the tensor's
    sparse layout (``<layout>_int4``, keyed by the layout tag).

    ``broadcast_total_bytes`` is the paper's Fig. 12 accounting: stored
    (mask-surviving) weights at ``bits`` each with no index overhead —
    100,864 B (0.1 MB) for the paper's pruned model.  It equals
    ``compression.compressed_size_bytes`` of the float model whenever
    every 2-D weight is quantized.
    """
    report: dict[str, dict] = {}
    total = 0.0
    broadcast_total = 0.0
    for name, qt in packed.quant.items():
        k_rows = qt.packed.shape[0] * 2
        dense = quant_size_bytes(qt, bits)
        entry = {"dense_int4": dense}
        nnz_bytes = dense
        layout_bytes = dense
        if name in packed.sparse:
            t = packed.sparse[name]
            layout = layouts.layout_of(t)
            layout_bytes = layout.size_bytes(t, k_rows, bits)
            entry["layout"] = layout.name
            entry[f"{layout.name}_int4"] = layout_bytes
            nnz_bytes = layout.stored_entries(t) * bits / 8.0
        entry["nnz_int4"] = nnz_bytes
        report[name] = entry
        total += min(dense, layout_bytes)
        broadcast_total += nnz_bytes
    report["total_bytes"] = total
    report["broadcast_total_bytes"] = broadcast_total
    return report
