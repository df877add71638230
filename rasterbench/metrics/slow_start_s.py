"""slow_start_s: how long the set-up's warm-up traffic ran before the frame
reached its steady rate, in seconds: the part of the slow start of graph
replays (harness/phase.py) that the cell's frame feels, which the warm-up
waits out in set-up.  The card's time from one completion to the next
(three requests in flight keep it busy) is binned by half seconds; the
steady time is the median over the window, and the reading is the end of
the last warm-up bin more than 5 % above it.  No reading without 10 s of
warm-up traffic."""

import statistics

BIN_MS, MIN_MS, SLOW = 500.0, 10000.0, 1.05


def read(ctx):
    intervals = ctx.warmup.intervals_ms or []
    if sum(intervals) < MIN_MS or not ctx.window.intervals_ms:
        return None
    steady = statistics.median(ctx.window.intervals_ms)
    bins, t = {}, 0.0
    for ms in intervals:
        t += ms
        bins.setdefault(int(t // BIN_MS), []).append(ms)
    slow = [k for k, v in bins.items() if statistics.mean(v) > SLOW * steady]
    return (max(slow) + 1) * BIN_MS / 1e3 if slow else 0.0
