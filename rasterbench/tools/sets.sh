#!/usr/bin/env bash
# The two measurement sets of one cell, on the card:
#
#   bash rasterbench/tools/sets.sh <cell> <seconds> <out dir> <seed> [<seed> ...]
#
# One short run first (it builds the kernels in a fresh checkout), then the
# seeds twice in the same order (set 1, set 2), one process a run, each
# run's stdout and stderr kept under <out dir>.  python3
# rasterbench/tools/spread.py <out dir> reads them.
set -u
cell=$1; secs=$2; out=$3; shift 3
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"
python3 rasterbench/run.py --workload "$cell" --seed 1999999999 --seconds 2 --trace 0 \
    > "$out/warm.out" 2> "$out/warm.err"
for set in 1 2; do
  for seed in "$@"; do
    python3 rasterbench/run.py --workload "$cell" --seed "$seed" --seconds "$secs" --trace 0 \
        > "$out/s$set.$seed.out" 2> "$out/s$set.$seed.err"
    echo "set=$set seed=$seed rc=$?"
  done
done
