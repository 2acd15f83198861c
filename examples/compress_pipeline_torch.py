"""The paper's compression stack applied to a pool architecture, on the
port: int4 QAT + unstructured pruning on an LM's FFN/attention weights,
then int4-kernel serving — showing the technique is a first-class,
arch-generic feature.

  python examples/compress_pipeline_torch.py [--arch yi-6b] [--prune 0.4] \
      [--device cuda|cpu]

The arch runs at its reduced config.  The int4 product goes through the
port's hand-written CUDA kernel ``int4_matmul`` (K2) by way of
``kernels/ops.py``, which runs its plain PyTorch version on CPU tensors.
``--device`` is ``cuda`` by default and raises without a GPU.
``compress``, ``drift`` and ``int4_check`` are the three steps as
functions; ``run`` chains them.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.compression import pruning, quantization  # noqa: E402
from repro_torch.core.compression.quantization import QuantSpec  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.core.tree import (tree_leaves_with_path,  # noqa: E402
                                   tree_unflatten)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import registry  # noqa: E402

SPEC = QuantSpec(bits=4)
# a leaf whose path holds one of these (as a substring, as the reference
# matches its keystr) is pruned and quantized, if it has two or more axes
COMPRESSED = ("w_gate", "w_up", "w_down", "w_q", "w_k", "w_v", "w_o")


@torch.no_grad()
def compress(params, prune: float):
    """Magnitude-prune ``prune`` of each selected leaf, then fake-quant it
    to int4.  Returns (compressed params, a report: ``fp32_bytes``,
    ``quant_bytes`` (int4 for the selected leaves, fp32 for the rest),
    ``pruned`` weights, the selected ``paths``)."""
    total_fp32 = 0
    quant_bytes = 0
    pruned = 0
    paths = []
    new_leaves = []
    for ks, leaf in tree_leaves_with_path(params):
        total_fp32 += leaf.numel() * 4
        if leaf.dim() >= 2 and any(w in ks for w in COMPRESSED):
            mask = pruning.magnitude_prune_mask(
                leaf.reshape(-1, leaf.shape[-1]), prune).reshape(leaf.shape)
            leaf = quantization.fake_quant(leaf * mask, SPEC)
            pruned += int((mask == 0).sum())
            quant_bytes += leaf.numel() * 0.5
            paths.append(ks)
        else:
            quant_bytes += leaf.numel() * 4
        new_leaves.append(leaf)
    return tree_unflatten(params, iter(new_leaves)), {
        "fp32_bytes": total_fp32, "quant_bytes": quant_bytes,
        "pruned": pruned, "paths": paths}


@torch.no_grad()
def drift(api, params, cparams, batch: dict) -> tuple[float, float]:
    """(mean |logits - compressed logits|, std of the logits) over
    ``batch``."""
    lo, _ = api.forward(params, batch)
    lc, _ = api.forward(cparams, batch)
    return (float(torch.mean(torch.abs(lo - lc))),
            float(torch.std(lo.float(), correction=0)))


def make_batch(cfg, tokens: torch.Tensor) -> dict:
    """``tokens`` and the stubbed frontends' zero inputs, as the reference
    example feeds them."""
    b = tokens.shape[0]
    batch = {"tokens": tokens}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.zeros(
            (b, cfg.num_patch_tokens, cfg.d_model), dtype=cfg.dtype,
            device=tokens.device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                      device=tokens.device)
    return batch


@torch.no_grad()
def int4_check(w: torch.Tensor, x: torch.Tensor
               ) -> tuple[float, torch.Tensor]:
    """``x @ w`` through K2 with ``w`` quantized to int4 per channel:
    (the largest |difference| from the dequantized product, K2's
    product)."""
    qw, scale = quantization.quantize_to_int(w, SPEC)
    y_kernel = ops.int4_matmul(x, quantization.pack_int4(qw), scale[0])
    y_ref = x @ (qw.to(torch.float32) * scale)
    return float(torch.abs(y_kernel - y_ref).max()), y_kernel


def run(arch: str = "yi-6b", prune: float = 0.4,
        device: torch.device | str = "cuda") -> dict:
    """``arch`` at its reduced config, seeded (generator seeds 0-3 for the
    parameters, the tokens, ``w`` and ``x``): ``compress``'s report, the
    drift and its scale, K2's error and product.  Prints the reference
    example's three lines."""
    device = resolve_device(device)
    cfg = registry.reduce_config(registry.get_model(arch).cfg)
    api = registry.get_model(arch, cfg)
    gen = torch.Generator(device=device)
    params = api.init(gen.manual_seed(0), device=device)
    cparams, rep = compress(params, prune)
    print(f"{arch}: fp32 {rep['fp32_bytes']/1e6:.2f} MB -> int4+prune "
          f"{rep['quant_bytes']/1e6:.2f} MB "
          f"({1-rep['quant_bytes']/rep['fp32_bytes']:.1%} smaller, "
          f"{rep['pruned']} weights pruned)")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=device,
                           generator=gen.manual_seed(1))
    d, scale = drift(api, params, cparams, make_batch(cfg, tokens))
    print(f"logit drift after compression: {d:.4f} (scale {scale:.3f})")
    # int4 serving path through the CUDA kernel (one FFN matmul)
    w = torch.randn((128, 256), device=device, generator=gen.manual_seed(2))
    x = torch.randn((128, 128), device=device, generator=gen.manual_seed(3))
    err, y = int4_check(w, x)
    print(f"int4 CUDA matmul max err vs dequant ref: {err:.2e}")
    return dict(rep, drift=d, scale=scale, int4_err=err, int4_y=y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=registry.list_archs())
    ap.add_argument("--prune", type=float, default=0.4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    run(args.arch, args.prune, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
