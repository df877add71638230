#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port (svgrasterize_tpu_torch).

    python rasterbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for.  It generates the cell's document from the seed, parses, lowers and
uploads it, captures and warms up the frame (set-up), drives the cell's
traffic for the given seconds (the window), checks the layers the window
returned against the plain reference, and prints one JSON line: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics from a profiled slice of the window.  The numbers compared for
`correct` are printed with their limits as the last lines of standard error
and under "checks", the line's last key.

Without a card, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = os.path.join(ROOT, "build", "rasterbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    sys.path.insert(0, ROOT)

    import torch

    from rasterbench.harness import cell

    _bench, entry, _config, _traffic = cell.resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); found"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"modules that must not load were loaded: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
