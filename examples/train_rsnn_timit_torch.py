"""End-to-end driver on the port: the paper's full compression pipeline +
TS ablation, in PyTorch on one device.

  python examples/train_rsnn_timit_torch.py [--steps 300] \
      [--workdir runs/rsnn_pipeline] [--resume] [--artifact DIR] \
      [--device cuda|cpu]

Runs baseline (hidden 256) -> structured (128) -> unstructured (40% FC) ->
4-bit QAT, each with inherent temporal training, on the TIMIT-shaped
synthetic stream; then sweeps time steps (Fig. 16). Writes
<out>/results.json (default runs/rsnn_pipeline/results.json).

With ``--workdir`` every finished stage is checkpointed
(``repro_torch.training.rsnn_pipeline``'s resumable CompressionPipeline)
and ``--resume`` continues an interrupted run from the last completed
stage; ``--artifact DIR`` also packs the QAT stage into the on-disk
deployment artifact that ``examples/stream_asr_torch.py --artifact DIR``
serves.  ``--device`` is ``cuda`` by default and raises without a GPU.
"""

import argparse
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data.synthetic import (SpeechDataConfig,  # noqa: E402
                                        TimitLikeStream)
from repro_torch.training.rsnn_pipeline import (run_pipeline,  # noqa: E402
                                                write_results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default="runs/rsnn_pipeline")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint finished stages here (resumable)")
    ap.add_argument("--resume", action="store_true",
                    help="restore finished stages instead of retraining")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="pack the QAT stage into a deployment artifact")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    # the pipeline emits structured records via logging, not print —
    # surface them on the console for this interactive entry point
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    results = run_pipeline(steps=args.steps, batch_size=args.batch,
                           workdir=args.workdir, resume=args.resume,
                           artifact_path=args.artifact, device=args.device)

    # Fig. 16: error rate vs number of time steps (on the final QAT model)
    out = Path(args.out) / "results.json"
    payload = write_results(results, TimitLikeStream(SpeechDataConfig()), out)
    for point in payload[-1]["ts_sweep"]:
        print(f"[ts-sweep] ts={point['time_steps']} "
              f"fer={point['frame_error_rate']:.4f}")
    print(f"\nwrote {out}")
    print(f"{'stage':14s} {'FER':>7s} {'size KB':>9s} {'MMAC/s skip':>12s}")
    for r in results:
        print(f"{r.name:14s} {r.error_rate:7.4f} {r.size_bytes/1e3:9.1f} "
              f"{r.mmac_skip:12.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
