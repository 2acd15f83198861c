"""Stream speech through the compressed RSNN with repro_torch, on a GPU.

  python examples/stream_asr_torch.py [--precision int4|float] \
      [--backend fused|fused_spike|pallas|sparse|spike|delta|jnp|ref] \
      [--layout dense|csc|nm] [--hidden 128] [--device cuda|cpu] \
      [--slots 4] [--streams 8] [--pipeline-depth 2] \
      [--artifact DIR | --save-artifact DIR] [--frames N] [--sharded]

The PyTorch counterpart of ``examples/stream_asr.py``.  Builds the paper's
model from a seeded ``torch.Generator``, packs it in process to the pruned
int4 deployment model (``core/sparse.py`` ``pack_model``, on the device),
submits a queue of unequal-length synthetic utterances to the slot-based
``StreamLoop`` and reports the packed size, the throughput, the measured
sparsity and the zero-skip MMAC/s the served traffic would cost on the
accelerator (paper Fig. 13).

``--backend`` defaults to ``fused``: one hand-written CUDA mega-step
launch a frame (the reference's default ``jnp`` is the port's plain
PyTorch table, which runs no hand-written kernel; it stays available).
``--layout`` picks the packed-weight recipe: ``csc`` (default) prunes the
FC 40% by magnitude into padded CSC; ``nm`` prunes it 2:4 into the
group-packed N:M layout and serves the readout through it; ``dense``
prunes nothing.  ``--save-artifact DIR`` writes the in-process model out
as a deployment artifact; ``--artifact DIR`` serves one (config,
precision, preferred backend and input scale from its manifest), with
logits bit-equal to serving the same model packed in process.
``--frames N`` truncates every utterance to N frames.  ``--device cpu``
runs the plain PyTorch versions on the CPU.  ``--sharded`` serves through
``serving/sharded.py``'s ``ShardedStreamLoop`` over every device of
``--device``'s type (every visible card; the one CPU), its slots a
multiple of their count, fed by ``data/featurize.py``'s
``AsyncFeaturizer``, which quantizes the utterances on a host thread
ahead of the loop.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import artifact as artifact_lib  # noqa: E402
from repro_torch.core import complexity as C  # noqa: E402
from repro_torch.core import rsnn, sparse  # noqa: E402
from repro_torch.core.compression import (CompressionConfig,  # noqa: E402
                                          PruneSpec)
from repro_torch.core.rsnn import RSNNConfig  # noqa: E402
from repro_torch.data.featurize import (AsyncFeaturizer,  # noqa: E402
                                        cpu_quantizer, prefetch_depth)
from repro_torch.data.synthetic import (SpeechDataConfig,  # noqa: E402
                                        TimitLikeStream)
from repro_torch.serving import backends  # noqa: E402
from repro_torch.serving.sharded import (ShardedStreamLoop,  # noqa: E402
                                         stream_mesh)
from repro_torch.serving.stream import (CompiledRSNN,  # noqa: E402
                                        EngineConfig, StreamLoop,
                                        calibrate_input_scale)

DEFAULT_BACKEND = "fused"


def compression_config(layout: str) -> CompressionConfig:
    """The packed-weight recipe of ``--layout``."""
    if layout == "dense":
        return CompressionConfig(weight_bits=4)
    if layout == "nm":
        return CompressionConfig(weight_bits=4, prune_specs=(
            ("fc_w", PruneSpec(kind="nm", n=2, m=4)),))
    return CompressionConfig(fc_prune_frac=0.4, weight_bits=4)


def utterances(streams: int, frames: int | None) -> list[np.ndarray]:
    """``streams`` synthetic utterances of 40-100 frames (at most
    ``frames``), as the reference's example draws them."""
    data = TimitLikeStream(SpeechDataConfig())
    rng = np.random.default_rng(0)
    utts = []
    for i in range(streams):
        feats = data.batch(1, step=i)["features"][0]
        n = int(rng.integers(40, 101))  # 0.4-1.0 s
        if frames is not None:
            n = min(n, frames)
        utts.append(feats[:n])
    return utts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default=None,
                    choices=list(backends.available()),
                    help=f"execution backend (default: {DEFAULT_BACKEND}, "
                         f"or the artifact's preferred backend)")
    ap.add_argument("--precision", default="int4", choices=["float", "int4"],
                    help="ignored with --artifact (manifest decides)")
    ap.add_argument("--layout", default="csc",
                    choices=["dense", "csc", "nm"],
                    help="packed-weight recipe: csc = 40%% magnitude FC "
                         "pruning in padded CSC (paper), nm = 2:4 FC "
                         "pruning in the group-packed N:M layout served "
                         "zero-skip, dense = no pruning; ignored with "
                         "--artifact (manifest decides)")
    ap.add_argument("--hidden", type=int, default=128,
                    help="paper's pruned width; ignored with --artifact")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the kernels' plain PyTorch versions")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=None,
                    help="truncate every utterance to this many frames")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="serve from an on-disk deployment artifact "
                         "(config/precision/scale from its manifest)")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="write the in-process model out as an artifact")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight device steps (0 = v1 synchronous loop)")
    ap.add_argument("--sharded", action="store_true",
                    help="split the slots over every device of --device's "
                         "type, fed by an async featurization front end")
    args = ap.parse_args(argv)
    if args.artifact and args.save_artifact:
        ap.error("--save-artifact conflicts with --artifact (the model "
                 "already lives on disk)")

    utts = utterances(args.streams, args.frames)
    if args.artifact:
        engine = CompiledRSNN.from_artifact(args.artifact,
                                            backend=args.backend,
                                            device=args.device)
        cfg = engine.cfg
        if engine._input_scale is None:
            raise SystemExit("artifact carries no input scale; re-export it "
                             "with calibration")
        print(f"serving from artifact {args.artifact} "
              f"(precision {engine.engine.precision}, "
              f"backend {engine.engine.backend})")
    else:
        cfg = RSNNConfig(hidden_dim=args.hidden)
        params = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
        ccfg = compression_config(args.layout)
        # the nm layout is there to be executed: serve the readout through
        # the packed layout's zero-skip path (int4 only)
        sparse_fc = args.layout == "nm" and args.precision == "int4"
        backend = args.backend or DEFAULT_BACKEND
        scale = calibrate_input_scale(
            torch.from_numpy(np.concatenate(utts, axis=0)), cfg.input_bits)
        engine = CompiledRSNN(
            cfg, params,
            EngineConfig(backend=backend, precision=args.precision,
                         sparse_fc=sparse_fc, input_scale=scale),
            ccfg=ccfg, device=args.device)
        if args.save_artifact:
            if engine.packed is not None:
                artifact_lib.save_artifact(
                    args.save_artifact, cfg=cfg, packed=engine.packed,
                    ccfg=ccfg, input_scale=scale, backend=backend,
                    sparse_fc=sparse_fc)
            else:
                artifact_lib.save_artifact(
                    args.save_artifact, cfg=cfg, params=params,
                    input_scale=scale, backend=backend)
            print(f"wrote deployment artifact to {args.save_artifact}")
    feat = None
    if args.sharded:
        # quantize ahead of the loop on a host thread; it starts now, so
        # the front end overlaps the loop's construction and graph capture
        feat = AsyncFeaturizer(
            utts, cpu_quantizer(engine),
            depth=prefetch_depth(args.slots, args.pipeline_depth))

    if engine.packed is not None:
        rep = sparse.packed_size_report(engine.packed)
        tags = ", ".join(f"{n}={v['layout']}" for n, v in rep.items()
                         if isinstance(v, dict) and "layout" in v)
        print(f"packed model: {rep['broadcast_total_bytes'] / 1e6:.3f} MB "
              f"nonzero int4 (paper Fig. 12: 0.10 MB); "
              f"{rep['total_bytes'] / 1e6:.3f} MB packed layout "
              f"({tags or 'all dense'})")

    if args.sharded:
        devices = stream_mesh(None if args.device == "cuda" else ["cpu"])
        loop = ShardedStreamLoop(engine, batch_slots=args.slots,
                                 devices=devices,
                                 max_frames=max(map(len, utts)),
                                 pipeline_depth=args.pipeline_depth)
        print(f"sharded over {len(loop.devices)} devices ({args.slots} "
              f"slots, pipeline depth {args.pipeline_depth}, async "
              f"featurization front end)")
        # submit_stream serves while the featurizer drains, so the timed
        # region covers it: its steps count toward the totals below
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.submit_stream(feat, quantized=True)
    else:
        loop = StreamLoop(engine, batch_slots=args.slots,
                          pipeline_depth=args.pipeline_depth)
        for u in utts:
            loop.submit(u)
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
    done = loop.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    frames = int(loop.counters.frames)
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "the CPU")
    print(f"\nserved {len(done)} streams / {frames} frames in {dt:.2f}s over "
          f"{loop.steps} engine steps ({args.slots} slots, "
          f"pipeline depth {args.pipeline_depth}, "
          f"{loop.host_syncs / frames:.3f} host syncs/frame)")
    print(f"  {frames / dt:.0f} frames/s on {where} (backend "
          f"{engine.engine.backend}) -> "
          f"{frames / dt / C.FRAMES_PER_SECOND:.1f} concurrent real-time "
          f"streams")
    prof = loop.sparsity_profile()
    print(f"  measured sparsity: input bits {1 - prof.input_bit_density:.0%}, "
          f"L0 spikes {1 - np.mean(prof.l0_density):.0%}, "
          f"L1 spikes {1 - np.mean(prof.l1_density):.0%} "
          f"(paper Fig. 18: 57% / 60-71%)")
    mmac = loop.mmac_per_second()  # at the engine's deployed FC pruning
    dense = C.mmac_per_second(cfg, cfg.num_ts,
                              fc_prune_frac=engine.fc_prune_frac)
    print(f"  zero-skip complexity of this traffic: {mmac:.2f} MMAC/s "
          f"(dense {dense:.2f}; paper's operating point 13.86)")
    top = done[0]
    preds = top.stacked_logits().argmax(-1)
    print(f"  stream {top.sid}: {len(top.frames)} frames -> "
          f"first predictions {preds[:8].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
