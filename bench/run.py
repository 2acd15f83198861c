"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared with its limit, which
also close standard error).  Without a card, without the program
(``src/repro_torch``), or with JAX or the JAX package loaded by the time
the window has closed, the run prints no result and exits non-zero.
"""

import time

T_START = time.monotonic()  # set-up runs from here to the window's open

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, heads the path: the benchmark's
# modules are the package ``bench``, and none of them may shadow a
# top-level module of the same name
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# every build or kernel cache of the program at a fixed path in the
# checkout (the CUDA library builds into build/ itself)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from bench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    except harness.RunError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    banned = harness.banned_modules()
    if banned:
        print(f"no result: JAX or the JAX package is loaded: {banned}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
