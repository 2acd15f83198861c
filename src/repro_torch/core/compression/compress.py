"""Compression pipeline orchestration (paper §II-D3, Fig. 12).

The paper's flow: structured pruning (256 -> 128, train from scratch),
then unstructured magnitude pruning of the FC (40%), then 4-bit QAT.  This
module ties the pieces into a ``materializer`` that applies masks and
fake-quant to the weights, hands a model to the packer
(``pack_for_inference``) and accounts its compressed storage (Fig. 12's
2.79 MB -> 0.1 MB).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.compression import pruning, quantization
from repro_torch.core.compression.quantization import QuantSpec


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """One tensor's mask-level pruning recipe (see ``pruning.build_mask``).

    ``kind``: ``magnitude`` (global unstructured), ``nm`` (N:M
    semi-structured along the input dim), ``row`` / ``channel``
    (structured: whole input rows / output channels by L2 norm).  ``frac``
    is the pruned fraction (ignored by ``nm``, which keeps ``n`` of every
    ``m`` consecutive rows).

    ``layout`` names the storage layout the masked tensor packs to
    (``core/layouts`` registry): ``"auto"`` resolves to ``nm_group`` for
    N:M specs and padded ``csc`` otherwise; an explicit tag forces one
    (``layout="csc"`` keeps an N:M mask in CSC).
    """

    kind: str = "magnitude"
    frac: float = 0.0
    n: int = 2
    m: int = 4
    layout: str = "auto"

    def __post_init__(self):
        if self.kind not in ("magnitude", "nm", "row", "channel"):
            raise ValueError(f"unknown prune kind {self.kind!r}")
        if not 0.0 <= self.frac < 1.0:
            raise ValueError(f"prune frac must be in [0, 1), got {self.frac}")
        if self.kind == "nm" and not 1 <= self.n <= self.m:
            raise ValueError(
                f"N:M spec needs 1 <= n <= m, got n={self.n} m={self.m}")
        if self.layout != "auto":
            from repro_torch.core import layouts  # deferred: layouts is above

            if self.layout not in layouts.available_layouts():
                raise ValueError(
                    f"unknown weight layout {self.layout!r}; available: "
                    f"{('auto',) + layouts.available_layouts()}")
            if self.layout == "dense":
                raise ValueError(
                    "layout 'dense' stores every entry and would break the "
                    "mask-survivor size accounting; a masked tensor needs a "
                    "sparse layout (drop the spec to keep the tensor dense)")
            if self.layout == "nm_group":
                if self.kind != "nm":
                    raise ValueError(
                        "layout 'nm_group' stores fixed-nnz groups and "
                        "needs an N:M spec (kind='nm'); got "
                        f"kind={self.kind!r}")
                if self.m > 16:
                    raise ValueError(
                        "layout 'nm_group' packs the in-group offset into "
                        f"a nibble, so m <= 16 is required; got m={self.m} "
                        "(use layout='csc' or 'auto')")

    @property
    def is_noop(self) -> bool:
        return self.kind != "nm" and self.frac <= 0.0


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    fc_prune_frac: float = 0.0  # unstructured pruning of the FC layer
    prune_names: tuple[str, ...] = ("fc_w",)
    # mixed-level pruning: per-tensor specs, e.g.
    # ``(("l0_wh", PruneSpec("nm", n=2, m=4)), ("fc_w", PruneSpec(frac=0.4)))``;
    # an explicit spec overrides the fc_prune_frac/prune_names shorthand
    prune_specs: tuple[tuple[str, PruneSpec], ...] = ()
    weight_bits: int | None = None  # None = float weights; 4 = the paper's
    quant_names: tuple[str, ...] = ("l0_wx", "l0_wh", "l1_wx", "l1_wh", "fc_w")
    quant_granularity: str = "per_channel"

    @property
    def quant_spec(self) -> QuantSpec | None:
        if self.weight_bits is None:
            return None
        return QuantSpec(bits=self.weight_bits,
                         granularity=self.quant_granularity)

    @property
    def resolved_prune_specs(self) -> dict[str, PruneSpec]:
        """The per-tensor prune map applied: the ``fc_prune_frac``/
        ``prune_names`` shorthand as magnitude specs, overridden or
        extended by ``prune_specs``; no-op specs (frac 0) dropped."""
        specs: dict[str, PruneSpec] = {}
        if self.fc_prune_frac > 0.0:
            for n in self.prune_names:
                specs[n] = PruneSpec(kind="magnitude", frac=self.fc_prune_frac)
        for name, spec in self.prune_specs:
            specs[name] = spec
        return {n: s for n, s in specs.items() if not s.is_noop}

    @property
    def fc_prune_fraction(self) -> float:
        """Deployed pruned fraction of the FC readout, whatever level
        realised it (the zero-skip MMAC/s accounting)."""
        spec = self.resolved_prune_specs.get("fc_w")
        if spec is None:
            return 0.0
        if spec.kind == "nm":
            return 1.0 - spec.n / spec.m
        return spec.frac


class CompressionState(NamedTuple):
    masks: dict  # name -> {0, 1} mask


def init_compression(params: dict, ccfg: CompressionConfig
                     ) -> CompressionState:
    specs = ccfg.resolved_prune_specs
    unknown = sorted(set(specs) - set(params))
    if unknown:
        raise ValueError(f"prune specs name tensors absent from the model: "
                         f"{unknown}; have {sorted(params)}")
    return CompressionState(masks={n: pruning.build_mask(params[n], spec)
                                   for n, spec in specs.items()})


def materializer(ccfg: CompressionConfig, cstate: CompressionState):
    """params -> effective params: masks, then fake-quant."""

    def mat(params: dict) -> dict:
        p = pruning.apply_masks(params, cstate.masks)
        spec = ccfg.quant_spec
        if spec is not None:
            p = quantization.quantize_tree(p, spec, ccfg.quant_names)
        return p

    return mat


def pack_for_inference(params: dict, cfg, ccfg: CompressionConfig,
                       cstate: CompressionState):
    """Deployment handoff: masks, int4 and the sparse layouts, through
    ``core.sparse.pack_model``; dequantizing the result reproduces
    ``materializer``'s output bit for bit."""
    from repro_torch.core import sparse  # deferred: sparse imports us

    return sparse.pack_model(params, cfg, ccfg, cstate)


def compressed_size_bytes(params: dict, ccfg: CompressionConfig,
                          cstate: CompressionState) -> float:
    """Deployed weight storage: mask-surviving weights of every 2-D tensor
    at ``weight_bits`` each (no index overhead: the accelerator zero-skips
    by input broadcasting).  Fig. 12's accounting from the float side;
    ``sparse.packed_size_report(...)["broadcast_total_bytes"]`` computes
    the same number from the packed model."""
    bits = ccfg.weight_bits or 32
    total_bits = 0.0
    for name, w in params.items():
        if not isinstance(w, torch.Tensor) or w.dim() < 2:
            continue  # LIF parameters: negligible, kept 12-bit on-chip
        nnz = w.numel()
        if name in cstate.masks:
            nnz = float(cstate.masks[name].sum())
        total_bits += nnz * bits
    return total_bits / 8.0
