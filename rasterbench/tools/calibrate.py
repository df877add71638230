#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the card.

    python rasterbench/tools/calibrate.py --workload <cell> --seeds 12 [--control 3]
        [--seconds 1] [--first-seed N]

For each seed, one process runs the cell as a run does (set-up, a short
window at the cell's own load, its sampled layers against the reference) and
prints the numbers compared: the program's readings, whose largest is the
lower reading.  For the first --control seeds it then puts the control in
the program's place: the reference computed in the precision below the
configuration's (bfloat16 for float32), against the reference itself; the
smallest of those is the upper reading.  One JSON line per seed, then a
summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOWER = {"float64": "float32", "float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def control_gaps(root: str, cell_name: str, seed: int, device: str, overrides=None) -> dict:
    """The control's readings on one seed: the reference in the precision
    below the configuration's, against the reference."""
    import importlib

    import torch

    from rasterbench.harness import cell
    from rasterbench.reference import compare

    _bench, _cell, config, _params = cell.resolve(root, cell_name)
    config = {**config, **(overrides or {})}
    gen = importlib.import_module(f"rasterbench.docs.{config['generator']}")
    _svg, doc = gen.generate(int(seed) % 2 ** 64, **config["args"])
    ref_mod = importlib.import_module(f"rasterbench.reference.{config['reference']}")
    scale = config["width"] / doc["width"]
    h = int(round(doc["height"] * scale))
    w = int(config["width"])
    ref = ref_mod.render(doc, h, w, scale, tile=config["tile"],
                         dtype=getattr(torch, config["precision"]), device=device)
    low = ref_mod.render(doc, h, w, scale, tile=config["tile"],
                         dtype=getattr(torch, LOWER[config["precision"]]), device=device)
    return compare.gaps(low, ref, config["block"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from rasterbench.harness import cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    quiet = lambda msg: None  # noqa: E731
    program, control = [], []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        r = cell.run(ROOT, args.workload, seed, args.seconds, False, log=quiet)
        line = {"seed": seed, "correct": r["correct"],
                "program": {n: c["value"] for n, c in r["checks"].items()}}
        program.append(line["program"])
        torch.cuda.empty_cache()
        if k < args.control:
            line["control"] = control_gaps(ROOT, args.workload, seed, "cuda")
            control.append(line["control"])
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    names = program[0].keys()
    print(json.dumps({
        "lower": {n: max(p[n] for p in program) for n in names},
        "upper": {n: min(c[n] for c in control) for n in names} if control else None,
        "seeds": len(program), "control_seeds": len(control),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
