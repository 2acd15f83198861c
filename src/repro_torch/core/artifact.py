"""Versioned on-disk deployment artifact of the compressed RSNN (int4 or
float): the contract between the packer and the serving engine.

An artifact is a directory

    <path>/
      manifest.json   — schema version, RSNNConfig, CompressionConfig,
                        measured SparsityProfile, size report, preferred
                        backend, per-tensor shape/dtype index
      tensors.npz     — every deployed array, verbatim

in the reference's format: ``save_artifact`` writes it and
``load_artifact`` reads it, with numpy and torch alone, and an artifact
written by either package loads in the other.  Schema v2 keys each sparse
tensor as ``<layout>.<name>.<field>`` and records the per-tensor layout
tags under ``layouts``; schema v1 artifacts (no ``layouts``) load their
``csc.*`` keys as implicit padded CSC.  Any other version, a tensor
missing from ``tensors.npz``, or a shape or dtype that disagrees with the
manifest raises ``ArtifactError``.

Both payloads: the int4 one (``PackedRSNN``: nibble-packed
``QuantTensor``s, a layout-resolved tensor for every pruned weight,
inference LIF constants) in every registered layout, and the float one
(the raw parameter dict, keyed as ``_flatten_params`` keys it).  Arrays
round-trip bit for bit.
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
from repro_torch.core.compression.compress import CompressionConfig, PruneSpec
from repro_torch.core.layouts.base import host
from repro_torch.core.lif import LIFParams
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.sparse import (PackedRSNN, QuantTensor,
                                     packed_size_report)

SCHEMA_VERSION = 2
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
    ccfg: CompressionConfig | None
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
        """Deployed pruned fraction of the FC readout
        (``CompressionConfig.fc_prune_fraction``; 0.0 without a config)."""
        return 0.0 if self.ccfg is None else self.ccfg.fc_prune_fraction

    @property
    def layouts(self) -> dict:
        """Per-tensor layout tags (v1 manifests: derived from the payload)."""
        if "layouts" in self.manifest:
            return self.manifest["layouts"]
        if self.packed is None:  # a float payload has no layouts
            return {}
        return {n: layouts.layout_of(t).name
                for n, t in self.packed.sparse.items()}

    @property
    def size_report(self) -> dict | None:
        return self.manifest.get("size_report")


def _encode_rsnn_config(cfg: RSNNConfig) -> dict:
    """The config's fields, and the reference's ``dtype`` field (the port's
    models are float32)."""
    return {**dataclasses.asdict(cfg), "dtype": "float32"}


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


def _encode_compression_config(ccfg: CompressionConfig | None
                               ) -> dict | None:
    # PruneSpecs become dicts, tuples lists
    return None if ccfg is None else dataclasses.asdict(ccfg)


def _decode_compression_config(d: dict | None) -> CompressionConfig | None:
    if d is None:
        return None
    d = dict(d)
    d["prune_names"] = tuple(d["prune_names"])
    d["quant_names"] = tuple(d["quant_names"])
    d["prune_specs"] = tuple(
        (name, PruneSpec(**spec)) for name, spec in d["prune_specs"])
    return CompressionConfig(**d)


def _encode_sparsity(sp: SparsityProfile | None) -> dict | None:
    return None if sp is None else dataclasses.asdict(sp)


def _decode_sparsity(d: dict | None) -> SparsityProfile | None:
    if d is None:
        return None
    d = dict(d)
    for k in ("l0_density", "l1_density", "fc_density"):
        d[k] = tuple(d[k])
    return SparsityProfile(**d)


def _flatten_packed(packed: PackedRSNN
                    ) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Flatten to named host arrays; returns (arrays, per-tensor layout
    tags).  Sparse tensors go through their layout's codec under
    ``<layout>.<name>.<field>`` keys."""
    flat: dict[str, np.ndarray] = {}
    tags: dict[str, str] = {}
    for name, qt in packed.quant.items():
        flat[f"quant.{name}.packed"] = host(qt.packed)
        flat[f"quant.{name}.scale"] = host(qt.scale)
    for name, t in packed.sparse.items():
        layout = layouts.layout_of(t)
        tags[name] = layout.name
        for field, arr in layout.flatten(t).items():
            flat[f"{layout.name}.{name}.{field}"] = arr
    for name, arr in packed.lif.items():
        flat[f"lif.{name}"] = host(arr)
    return flat, tags


def _flatten_params(params: dict) -> dict[str, np.ndarray]:
    """The float parameter dict as the reference's ``_flatten_params``
    keys a parameter tree: names sorted, ``params['<layer>']`` and
    ``params['lif<i>'].raw_beta`` / ``.raw_vth``."""
    flat: dict[str, np.ndarray] = {}
    for name in sorted(params):
        leaf = params[name]
        if isinstance(leaf, LIFParams):
            for field in LIFParams._fields:
                flat[f"params['{name}'].{field}"] = host(
                    getattr(leaf, field))
        else:
            flat[f"params['{name}']"] = host(leaf)
    return flat


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


def save_artifact(path: str | Path, *, cfg: RSNNConfig,
                  packed: PackedRSNN | None = None,
                  params: dict | None = None,
                  ccfg: CompressionConfig | None = None,
                  sparsity: SparsityProfile | None = None,
                  input_scale=None, backend: str | None = None,
                  sparse_fc: bool = False) -> Path:
    """Write a deployment artifact directory; returns its path.

    Exactly one of ``packed`` (int4 payload) / ``params`` (float payload)
    must be given.  ``input_scale`` is the static 8-bit input calibration
    the engine serves with; ``backend`` names the preferred entry of
    ``serving/backends.py``; ``sparse_fc=True`` records that the pruned FC
    should be served through its packed layout's zero-skip path
    (``from_artifact`` honours it).
    """
    if (packed is None) == (params is None):
        raise ValueError("save_artifact needs exactly one of packed/params")
    if packed is not None and (ccfg is None or ccfg.quant_spec is None):
        raise ValueError("an int4 artifact needs the CompressionConfig it "
                         "was packed with (weight_bits set)")
    if sparse_fc and (packed is None or "fc_w" not in packed.sparse):
        raise ValueError("sparse_fc=True needs an int4 payload with a "
                         "pruned fc_w (a packed sparse layout to serve)")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    layout_tags: dict[str, str] = {}
    if packed is not None:
        precision = "int4"
        flat, layout_tags = _flatten_packed(packed)
        size_report = packed_size_report(packed)
    else:
        precision = "float"
        flat = _flatten_params(params)
        size_report = None
    if input_scale is not None:
        flat["input_scale"] = np.asarray(host(torch.as_tensor(input_scale)),
                                         np.float32)

    manifest = {
        "schema_version": SCHEMA_VERSION,
        "precision": precision,
        "rsnn_config": _encode_rsnn_config(cfg),
        "compression_config": _encode_compression_config(ccfg),
        "sparsity_profile": _encode_sparsity(sparsity),
        "size_report": size_report,
        "backend": backend,
        "sparse_fc": sparse_fc,
        "layouts": layout_tags,
        "has_input_scale": input_scale is not None,
        "tensors": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in flat.items()},
    }
    # the manifest last, and any previous one gone first: a save that dies
    # mid-write leaves a directory without a manifest, which load_artifact
    # rejects, never an old or truncated manifest beside new tensors
    (path / MANIFEST).unlink(missing_ok=True)
    np.savez(path / TENSORS, **flat)
    tmp = path / (MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=1))
    tmp.rename(path / MANIFEST)  # atomic commit
    return path


def load_artifact(path: str | Path) -> RSNNArtifact:
    """Read an artifact directory back; the bit-exact inverse of
    ``save_artifact`` (the port's or the reference's)."""
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
        manifest=manifest, cfg=cfg,
        ccfg=_decode_compression_config(manifest.get("compression_config")),
        packed=packed, params=params,
        sparsity=_decode_sparsity(manifest.get("sparsity_profile")),
        input_scale=scale)
