#!/usr/bin/env python3
"""Where a K6/K7 ``megastep`` call spends its cycles, phase by phase, on one
GPU.

    python3 megastep_trace.py [--seed 0]

There is no ``ncu`` on the machine with the card, so this builds
``src/repro_torch/csrc/megastep.cu`` with ``-DREPRO_MEGASTEP_TRACE``: at each
of the source's ``MEGA_STAMP(i)`` points thread 0 of every CTA stores
``clock64()`` into a device array.  It then runs K6 and K7 in every FC mode
at the main path's shapes (``chip_smoke.py``'s inputs, B = 256, chunks of 1
and 4 frames, the plan ``resident_plan`` picks) and prints, for each, the
mean cycles of each phase over the CTAs: the gap between stamps i - 1 and
i, named ``PHASES[i]`` (stamps inside the frame loop and the FC loop hold
the last frame's and the last sub-tile's; a CTA with no FC columns leaves
the FC loop's unset, and is left out of the means).  The stamps cost a few
cycles each; the library the port builds has none.  It imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import megastep as mega  # noqa: E402

CSRC = ROOT / "src/repro_torch/csrc"
# the phase each MEGA_STAMP(i) of megastep.cu ends, in the order a CTA
# passes them (stamp 0 starts the first)
PHASES = ["start", "weights, x issued", "u/h loads",
          "first cluster.sync, trains pushed", "wait, int4 slices built",
          "setup cluster.sync", "K7 compaction",
          "frame wait, FC sub-tile 0 issued", "one-bits, ff0", "rec0",
          "LIF0, push", "cluster.sync 1", "K7 compaction, ff1, rec1",
          "LIF1, push", "cluster.sync 2", "counters, merged spikes",
          "FC sub-tiles but the last, wait", "FC decode",
          "FC mma or fmaf (last sub-tile)", "write-back"]


def build(tmp: Path) -> ctypes.CDLL:
    """megastep.cu with its stamps on and status.cu as one library, loaded
    in place of the port's own."""
    objs = []
    for src, flags in ((CSRC / "megastep.cu", ["-DREPRO_MEGASTEP_TRACE"]),
                       (CSRC / "status.cu", [])):
        obj = tmp / (src.stem + ".o")
        run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags,
                              "-I", str(CSRC), "-c", str(src), "-o",
                              str(obj)], capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"nvcc failed on {src.name}:\n{run.stdout}"
                             f"{run.stderr}")
        objs.append(str(obj))
    lib_path = tmp / "libmegastep_trace.so"
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.reprotorch_error_string.argtypes = [ctypes.c_int]
    lib.reprotorch_error_string.restype = ctypes.c_char_p
    lib.megastep_trace_read.argtypes = [ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("megastep_trace: needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.artifact import load_artifact

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        _build._lib = lib = build(Path(tmp))
        utts = cs.utterances(args.seed, 16)
        packs = {key: load_artifact(cs.write_artifact(
            Path(tmp) / f"art{i}", args.seed, utts, prune=prune,
            fc_layout=layout)).packed
            for i, (key, (prune, layout)) in enumerate(cs.ARTIFACTS.items())}
        gen = torch.Generator().manual_seed(args.seed + 7)
        a = cs.kernel_inputs(packs, 256, gen, dev)
        fa = cs.float_kernel_inputs(cs.float_params(args.seed, cs.BASELINE),
                                    256, gen, dev)
        for fc_mode, x in (("csc", a), ("nm", a), ("dense_int4", a),
                           ("dense_float", fa)):
            for frames in (1, cs.MEGA_FRAMES):
                call = cs.megastep_args(x, frames, fc_mode)
                for spike in (False, True):
                    kern = cs.megastep_pair(fc_mode, spike)[0]
                    plan = mega.resident_plan(*cs.mega_shape(call, fc_mode,
                                                             spike))
                    _build.check(lib.megastep_trace_clear(),
                                 "megastep_trace")
                    for _ in range(3):
                        kern(*call, plan=plan)
                    torch.cuda.synchronize()
                    buf = np.zeros((1024, 32), np.int64)
                    _build.check(lib.megastep_trace_read(buf.ctypes.data),
                                 "megastep_trace")
                    stamps = buf[:plan.ctas, :len(PHASES)]
                    stamps = stamps[(stamps != 0).all(axis=1)]
                    gaps = np.diff(stamps, axis=1).mean(axis=0)
                    total = stamps[:, -1] - stamps[:, 0]
                    parts = ", ".join(f"{name} {gap:.0f}" for name, gap
                                      in zip(PHASES[1:], gaps))
                    print(f"trace {fc_mode} F={frames} spike={spike} plan "
                          f"{plan.rows}x{plan.cluster}x{plan.cols}: "
                          f"{total.mean():.0f} cycles (max {total.max()}); "
                          f"{parts}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
