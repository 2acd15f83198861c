"""Reader of the versioned on-disk deployment artifact (int4 or float).

An artifact is a directory

    <path>/
      manifest.json   — schema version, RSNNConfig, CompressionConfig,
                        measured SparsityProfile, size report, preferred
                        backend, per-tensor shape/dtype index
      tensors.npz     — every deployed array, verbatim

written by the reference's ``save_artifact``.  This module reads it with
numpy and torch alone.  Schema v2 keys each sparse tensor as
``<layout>.<name>.<field>`` and records the per-tensor layout tags under
``layouts``; schema v1 artifacts (no ``layouts``) load their ``csc.*`` keys
as implicit padded CSC.  Any other version, a tensor missing from
``tensors.npz``, or a shape or dtype that disagrees with the manifest
raises ``ArtifactError``.

Both payloads load.  The int4 payload (``PackedRSNN``: nibble-packed
``QuantTensor``s, a layout-resolved tensor for every pruned weight,
inference LIF constants) in every registered layout (``dense``, ``csc``
and ``nm_group``, for ``fc_w`` and for any recurrent tensor a mixed-level
spec pruned); the float payload (the raw parameter dict, keyed as the
reference's ``_flatten_params`` keys it) through ``params_from_arrays``.
The write side is not ported.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import layouts
from repro_torch.core.complexity import SparsityProfile
from repro_torch.core.lif import LIFParams
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.sparse import PackedRSNN, QuantTensor

SUPPORTED_VERSIONS = (1, 2)
MANIFEST = "manifest.json"
TENSORS = "tensors.npz"


class ArtifactError(ValueError):
    """Unreadable, incompatible, or internally inconsistent artifact."""


class RSNNArtifact(NamedTuple):
    """A loaded artifact: the manifest plus exactly one weight payload
    (CPU tensors; ``CompiledRSNN`` moves them to its device)."""

    manifest: dict
    cfg: RSNNConfig
    packed: PackedRSNN | None  # int4 payload
    params: dict | None  # float payload
    sparsity: SparsityProfile | None
    input_scale: torch.Tensor | None

    @property
    def precision(self) -> str:
        return self.manifest["precision"]

    @property
    def backend(self) -> str | None:
        return self.manifest.get("backend")

    @property
    def sparse_fc(self) -> bool:
        """Whether the model prefers the zero-skip layout FC path (absent
        in v1 manifests -> False)."""
        return bool(self.manifest.get("sparse_fc", False))

    @property
    def fc_prune_fraction(self) -> float:
        """Deployed pruned fraction of the FC readout, from the manifest's
        compression config (the reference's
        ``CompressionConfig.fc_prune_fraction``): an explicit ``fc_w``
        prune spec over the legacy ``fc_prune_frac``/``prune_names``
        shorthand; an N:M spec prunes ``1 - n/m``.  0.0 without a config
        or a spec."""
        cc = self.manifest.get("compression_config") or {}
        spec = None
        if cc.get("fc_prune_frac", 0.0) > 0.0 \
                and "fc_w" in cc.get("prune_names", ("fc_w",)):
            spec = {"kind": "magnitude", "frac": cc["fc_prune_frac"]}
        for name, s in cc.get("prune_specs", ()):
            if name == "fc_w":
                spec = s
        if spec is None:
            return 0.0
        if spec.get("kind", "magnitude") == "nm":
            return 1.0 - spec.get("n", 2) / spec.get("m", 4)
        return max(float(spec.get("frac", 0.0)), 0.0)

    @property
    def layouts(self) -> dict:
        """Per-tensor layout tags (v1 manifests: derived from the payload)."""
        if "layouts" in self.manifest:
            return self.manifest["layouts"]
        if self.packed is None:  # a float payload has no layouts
            return {}
        return {n: layouts.layout_of(t).name
                for n, t in self.packed.sparse.items()}


def _decode_rsnn_config(d: dict) -> RSNNConfig:
    d = dict(d)
    dtype = d.pop("dtype", "float32")
    if dtype != "float32":
        raise ArtifactError(f"rsnn_config dtype {dtype!r}: the port serves "
                            f"float32 models only")
    fields = {f.name for f in dataclasses.fields(RSNNConfig)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ArtifactError(f"rsnn_config has unknown fields {unknown}")
    return RSNNConfig(**d)


def _decode_sparsity(d: dict | None) -> SparsityProfile | None:
    if d is None:
        return None
    d = dict(d)
    for k in ("l0_density", "l1_density", "fc_density"):
        d[k] = tuple(d[k])
    return SparsityProfile(**d)


def packed_from_arrays(arrays: dict[str, np.ndarray]) -> PackedRSNN:
    """The packed model from the flat key/array dict the reference's
    ``_flatten_packed`` produces (``quant.<name>.<field>``,
    ``<layout>.<name>.<field>``, ``lif.<name>``); other keys, such as
    ``input_scale``, are not part of the packed model and are skipped.
    Arrays become CPU tensors, bit for bit."""
    quant: dict[str, dict] = {}
    sparse_fields: dict[str, dict] = {}
    sparse_tags: dict[str, str] = {}
    lif: dict[str, torch.Tensor] = {}
    known = set(layouts.available_layouts())
    for key, arr in arrays.items():
        kind, _, rest = key.partition(".")
        if kind == "quant":
            name, field = rest.rsplit(".", 1)
            quant.setdefault(name, {})[field] = torch.from_numpy(
                np.array(arr))
        elif kind == "lif":
            lif[rest] = torch.from_numpy(np.array(arr))
        elif kind in known:
            name, field = rest.rsplit(".", 1)
            sparse_tags[name] = kind
            sparse_fields.setdefault(name, {})[field] = torch.from_numpy(
                np.array(arr))
    return PackedRSNN(
        quant={n: QuantTensor(**f) for n, f in quant.items()},
        sparse={n: layouts.get_layout(sparse_tags[n]).unflatten(f)
                for n, f in sparse_fields.items()},
        lif=lif)


def params_from_arrays(arrays: dict[str, np.ndarray],
                       cfg: RSNNConfig) -> dict:
    """The float parameter dict from the flat key/array dict the
    reference's ``_flatten_params`` produces: ``params['<layer>']`` for
    each matrix of ``cfg.layer_shapes`` and ``params['lif<i>'].raw_beta``
    / ``.raw_vth`` of (hidden_dim,).  Arrays become float32 CPU tensors,
    bit for bit; a missing or misshapen tensor raises ``ArtifactError``."""

    def take(key: str, shape: tuple[int, ...]) -> torch.Tensor:
        if key not in arrays:
            raise ArtifactError(f"float artifact is missing tensor {key!r}")
        arr = np.asarray(arrays[key]).astype(np.float32)
        if arr.shape != shape:
            raise ArtifactError(f"float tensor {key!r} is {arr.shape}, the "
                                f"config needs {shape}")
        return torch.from_numpy(arr)

    params: dict = {name: take(f"params['{name}']", shape)
                    for name, shape in cfg.layer_shapes.items()}
    h = (cfg.hidden_dim,)
    for i in (0, 1):
        params[f"lif{i}"] = LIFParams(
            raw_beta=take(f"params['lif{i}'].raw_beta", h),
            raw_vth=take(f"params['lif{i}'].raw_vth", h))
    return params


def load_artifact(path: str | Path) -> RSNNArtifact:
    """Read an artifact directory written by the reference writer."""
    path = Path(path)
    mf = path / MANIFEST
    if not mf.exists():
        raise ArtifactError(f"no artifact at {path} (missing {MANIFEST})")
    manifest = json.loads(mf.read_text())
    version = manifest.get("schema_version")
    if version not in SUPPORTED_VERSIONS:
        raise ArtifactError(
            f"artifact at {path} has schema version {version!r}; this "
            f"reader supports versions {SUPPORTED_VERSIONS}. Re-export the "
            f"artifact with a matching writer or upgrade this reader")
    with np.load(path / TENSORS) as data:
        arrays = {k: data[k] for k in data.files}
    declared = manifest.get("tensors", {})
    missing = sorted(set(declared) - set(arrays))
    if missing:
        raise ArtifactError(f"artifact tensors missing from {TENSORS}: "
                            f"{missing}")
    for key, meta in declared.items():
        arr = arrays[key]
        if list(arr.shape) != meta["shape"] or str(arr.dtype) != meta["dtype"]:
            raise ArtifactError(
                f"tensor {key!r} is {arr.shape}/{arr.dtype}, manifest "
                f"declares {tuple(meta['shape'])}/{meta['dtype']}")

    precision = manifest["precision"]
    if precision not in ("int4", "float"):
        raise ArtifactError(f"unknown artifact precision {precision!r}")
    cfg = _decode_rsnn_config(manifest["rsnn_config"])
    scale = (torch.from_numpy(np.array(arrays["input_scale"]))
             if manifest.get("has_input_scale") else None)
    packed = params = None
    if precision == "float":
        params = params_from_arrays(arrays, cfg)
    else:
        packed = packed_from_arrays(arrays)
        declared_tags = manifest.get("layouts")
        if declared_tags is not None:  # v2: manifest tags must match payload
            actual = {n: layouts.layout_of(t).name
                      for n, t in packed.sparse.items()}
            if actual != declared_tags:
                raise ArtifactError(
                    f"manifest layout tags {declared_tags} disagree with "
                    f"the tensor payload {actual}")
    return RSNNArtifact(
        manifest=manifest, cfg=cfg, packed=packed, params=params,
        sparsity=_decode_sparsity(manifest.get("sparsity_profile")),
        input_scale=scale)
