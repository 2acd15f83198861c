"""Quickstart on the port: the paper's RSNN in a minute.

  python examples/quickstart_torch.py [--device cuda|cpu]

Trains the (reduced) recurrent spiking network on the TIMIT-shaped stream
for a handful of steps, compressed 4-bit + 40% FC pruning (QAT), prints
the paper's headline accounting numbers, and runs two of the port's
hand-written CUDA kernels on the trained weights: ``rsnn_cell`` (K1) and
``merged_spike_fc`` (K3), through ``kernels/ops.py``, which runs their
plain PyTorch versions on CPU tensors.  ``--device`` is ``cuda`` by
default and raises without a GPU.  ``train``, ``accounting`` and
``kernels`` are the three sections as functions; ``run`` chains them.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import complexity as C  # noqa: E402
from repro_torch.core import lif as L  # noqa: E402
from repro_torch.core import rsnn  # noqa: E402
from repro_torch.core.compression import (CompressionConfig,  # noqa: E402
                                          compressed_size_bytes,
                                          init_compression, materializer,
                                          quantization)
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.core.rsnn import RSNNConfig  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.data.synthetic import (SpeechDataConfig,  # noqa: E402
                                        TimitLikeStream)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.rsnn_pipeline import make_train_step  # noqa: E402

CFG = RSNNConfig(hidden_dim=128, num_ts=2)
CCFG = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
OCFG = OptimizerConfig(lr=3.5e-3, warmup_steps=5, decay_steps=50,
                       weight_decay=0.0)
STEPS, BATCH = 30, 16


def train(params: dict, steps: int = STEPS,
          device: torch.device | str = "cuda"):
    """``steps`` QAT steps from ``params`` (moved to ``device``), batch
    ``BATCH`` of 50-frame utterances.  Returns (trained params, the
    compression state, [(loss, frame error rate)] a step)."""
    device = resolve_device(device)
    params = tree_map(lambda t: t.to(device), params)
    stream = TimitLikeStream(SpeechDataConfig(frames=50))
    cstate = init_compression(params, CCFG)
    state = {"params": params, "opt": opt_lib.init_opt_state(params, OCFG)}
    step = make_train_step(CFG, OCFG, CCFG, cstate, num_ts=2)
    print("== training (QAT int4 + pruned, 2 time steps) ==")
    history = []
    for i in range(steps):
        b = stream.batch(BATCH, step=i)
        state, m = step(state, {k: torch.from_numpy(v).to(device)
                                for k, v in b.items()})
        history.append((float(m["loss"]), float(m["frame_error_rate"])))
        if i % 10 == 0:
            print(f"  step {i}: loss={history[-1][0]:.3f} "
                  f"fer={history[-1][1]:.3f}")
    return state["params"], cstate, history


def accounting(params: dict, cstate) -> dict:
    """Fig. 12's deployed size, Fig. 13's MMAC/s and Fig. 17's cycles a
    frame at 2 time steps, merged spikes."""
    out = {"size_kb": compressed_size_bytes(params, CCFG, cstate) / 1e3,
           "mmac": C.mmac_per_second(CFG, 2, sparsity=C.SparsityProfile(),
                                     merged_spike=True),
           "cycles": C.cycles_per_frame(CFG, 2,
                                        sparsity=C.SparsityProfile(),
                                        merged_spike=True)}
    print("== compression accounting (paper Fig. 12) ==")
    print(f"  deployed size: {out['size_kb']:.1f} KB (paper: ~100 KB)")
    print(f"  complexity 2ts merged: {out['mmac']:.2f} MMAC/s")
    print(f"  cycles/frame: {out['cycles']:.0f} (paper: 895 @ 100 kHz)")
    return out


@torch.no_grad()
def kernels(params: dict, cstate) -> dict:
    """K1 over the materialized L0 recurrent weights and K3 over the int4
    FC, on seeded inputs on the parameters' device.  Returns each
    kernel's arguments and outputs."""
    dev = params["fc_w"].device
    eff = materializer(CCFG, cstate)(params)
    rng = np.random.default_rng(0)
    s_prev = torch.as_tensor(rng.integers(0, 2, (2, 128, 128)),
                             dtype=torch.float32, device=dev)
    stim = torch.as_tensor(rng.normal(size=(2, 128, 128)),
                           dtype=torch.float32, device=dev)
    z = torch.zeros((128, 128), device=dev)
    cell_args = (stim, s_prev, eff["l0_wh"], z, z,
                 L.beta_of(params["lif0"]), L.vth_of(params["lif0"]))
    where = ("launched on the card" if dev.type == "cuda"
             else "their plain PyTorch versions on the CPU")
    print(f"== hand-written CUDA kernels K1, K3 ({where}) ==")
    spikes, u = ops.rsnn_cell(*cell_args)
    print(f"  rsnn_cell: spikes {tuple(spikes.shape)}, "
          f"rate {float(spikes.mean()):.3f}")
    qw, scale = quantization.quantize_to_int(eff["fc_w"])
    fc_args = (spikes, quantization.pack_int4(qw), scale[0])
    logits = ops.merged_spike_fc(*fc_args)
    print(f"  merged_spike_fc (int4): logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits).all())}")
    return {"cell_args": cell_args, "spikes": spikes, "u": u,
            "fc_args": fc_args, "logits": logits}


def run(device: torch.device | str = "cuda") -> dict:
    """The three sections from the port's seeded parameters (generator
    seed 0): the training history, the accounting and the kernels'
    arguments and outputs."""
    device = resolve_device(device)
    params = rsnn.init_params(torch.Generator(device=device).manual_seed(0),
                              CFG)
    params, cstate, history = train(params, STEPS, device)
    return {"history": history, "accounting": accounting(params, cstate),
            "kernels": kernels(params, cstate)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
