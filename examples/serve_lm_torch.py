"""Serve a small LM with batched requests (prefill + KV-cache decode +
continuous batching), demonstrating the serving substrate end to end, on
the PyTorch port.

  python examples/serve_lm_torch.py [--arch gemma2-2b] [--fit-steps 40] \
      [--requests 6] [--device cuda|cpu]

The arch is instantiated at its reduced config, briefly fitted to the
Markov stream so generations aren't pure noise (``make_train_step`` with
the state updated in place, the reference's donated step), then a request
queue is served through ServeLoop.  ``--device`` is ``cuda`` by default
and raises without a GPU.  ``run`` is the same flow as a function.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.data.synthetic import (LMDataConfig,  # noqa: E402
                                        MarkovLMStream)
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving.engine import SamplerConfig, ServeLoop  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402


def run(arch: str = "gemma2-2b", fit_steps: int = 40, requests: int = 6,
        device: torch.device | str = "cuda") -> dict:
    """Fit ``arch``'s reduced config for ``fit_steps`` steps, then serve
    ``requests`` requests.  Returns the fit's losses a step, the served
    requests and their seconds."""
    device = resolve_device(device)
    cfg = registry.reduce_config(registry.get_model(arch).cfg)
    api = registry.get_model(arch, cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0),
                      device=device)
    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size))

    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=5, decay_steps=fit_steps)
    step = steps_lib.make_train_step(api, ocfg, donate=True)
    state = {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}
    losses = []
    for i in range(fit_steps):
        b = stream.batch(8, 64, step=i)
        state, m = step(state, {"tokens": torch.as_tensor(b["tokens"],
                                                          device=device)})
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"[fit] step {i} loss={losses[-1]:.3f}")

    loop = ServeLoop(api, state["params"], batch_slots=4,
                     scfg=SamplerConfig(temperature=0.0))
    rng = np.random.default_rng(0)
    for r in range(requests):
        plen = int(rng.integers(4, 12))
        prompt = stream.batch(1, plen, step=100 + r)["tokens"][0]
        loop.submit(prompt, max_new=16)
    t0 = time.time()
    done = loop.run()
    return {"losses": losses, "done": done, "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=registry.list_archs())
    ap.add_argument("--fit-steps", type=int, default=40)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    out = run(args.arch, args.fit_steps, args.requests, args.device)
    done, dt = out["done"], out["seconds"]
    toks = sum(len(r.out) for r in done)
    print(f"\nserved {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s on {args.device})")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[-4:]={list(r.prompt[-4:])} -> "
              f"{list(map(int, r.out[:8]))}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
