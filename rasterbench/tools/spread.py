#!/usr/bin/env python3
"""Medians and spreads of the measurement sets that tools/sets.sh wrote.

    python3 rasterbench/tools/spread.py <out dir>

For each set and metric: the median and the spread, the distance between
the first and third quartiles (statistics.quantiles, n=4) as a share of the
median; then each metric's widest spread and five times it (the bound it
suggests, never under 1 %), and how far set 2's median lies from set 1's.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import sys


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main() -> int:
    out = sys.argv[1]
    sets = {}
    for path in sorted(glob.glob(os.path.join(out, "s[12].*.out"))):
        with open(path, encoding="utf-8") as f:
            lines = f.read().strip().splitlines()
        result = json.loads(lines[-1]) if lines else None
        name = os.path.basename(path).split(".")[0]
        sets.setdefault(name, []).append(result)
    widest, medians = {}, {}
    for name, results in sorted(sets.items()):
        print(f"{name}: {len(results)} runs, correct {[bool(r and r['correct']) for r in results]}")
        for metric in results[0]["metrics"]:
            values = [r["metrics"][metric]["value"] for r in results]
            medians.setdefault(metric, []).append(statistics.median(values))
            widest[metric] = max(widest.get(metric, 0.0), spread(values))
            print(f"  {metric:16s} median {statistics.median(values):.6f}"
                  f" spread {spread(values):.4%}")
    for metric, s in widest.items():
        shift = medians[metric][-1] / medians[metric][0] - 1
        print(f"{metric:16s} widest spread {s:.4%}, 5x {max(5 * s, 0.01):.4%},"
              f" set 2 against set 1 {shift:+.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
