"""The system under test, built the way a deployment builds it.

The benchmark hands the program the model it drew (``reference/data.py``)
as a deployment artifact, written with the port's own packers and
``save_artifact`` into the run's temporary directory, and serves it
through the port's entry: ``CompiledRSNN.from_artifact`` (the backend,
the zero-skip FC and the 8-bit input scale from the manifest) under a
``StreamLoop`` of the mix's shape.  On the card the loop captures its step
as one CUDA graph when it is built.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.core.artifact import save_artifact
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compression.quantization import pack_int4
from repro_torch.core.layouts.csc import sparsify_columns
from repro_torch.core.lif import LIFParams
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.sparse import PackedRSNN, QuantTensor
from repro_torch.serving.stream import CompiledRSNN, StreamLoop


def rsnn_config(cfg: dict) -> RSNNConfig:
    return RSNNConfig(input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                      fc_dim=cfg["fc_dim"], num_ts=cfg["num_ts"],
                      input_bits=cfg["input_bits"])


def write_artifact(path: Path, cfg: dict, model: dict,
                   scale: np.float32) -> Path:
    """The drawn ``model`` as the configuration's deployment artifact."""
    rcfg = rsnn_config(cfg)
    cpu = torch.device("cpu")
    if cfg["precision"] == "int4":
        layers = {n: tuple(None if t is None else t.to(cpu) for t in v)
                  for n, v in model["layers"].items()}
        q, scale_fc, keep = layers["fc_w"]
        if cfg["fc_layout"] != "csc":
            raise ValueError(f"fc_layout {cfg['fc_layout']!r}: the benchmark "
                             f"writes the csc layout")
        packed = PackedRSNN(
            quant={n: QuantTensor(pack_int4(q), s.reshape(1, -1))
                   for n, (q, s, _) in layers.items()},
            sparse={"fc_w": sparsify_columns(q, scale_fc, keep)},
            lif={k: v.to(cpu) for k, v in model["lif"].items()})
        ccfg = CompressionConfig(fc_prune_frac=cfg["fc_prune_fraction"],
                                 weight_bits=4)
        return save_artifact(path, cfg=rcfg, packed=packed, ccfg=ccfg,
                             input_scale=scale, backend=cfg["backend"],
                             sparse_fc=cfg["sparse_fc"])
    params = {n: t.to(cpu) for n, t in model["layers"].items()}
    for i in (0, 1):
        params[f"lif{i}"] = LIFParams(
            raw_beta=model["lif"][f"raw_beta{i}"].to(cpu),
            raw_vth=model["lif"][f"raw_vth{i}"].to(cpu))
    return save_artifact(path, cfg=rcfg, params=params, input_scale=scale,
                         backend=cfg["backend"])


def build(cfg: dict, mix: dict, model: dict, scale: np.float32,
          workdir: Path, device) -> StreamLoop:
    """The artifact written into ``workdir``, the engine loaded from it on
    ``device`` and the mix's slot loop over it."""
    return load(write_artifact(Path(workdir) / "artifact", cfg, model, scale),
                mix, device)


def load(path: Path, mix: dict, device) -> StreamLoop:
    """The engine loaded from the artifact at ``path`` on ``device`` and
    the mix's slot loop over it (on the card, its step captured)."""
    engine = CompiledRSNN.from_artifact(path, device=device)
    return StreamLoop(engine, batch_slots=mix["slots"],
                      pipeline_depth=mix["pipeline_depth"],
                      ring_frames=mix["ring_frames"],
                      chunk_frames=mix["chunk_frames"])
