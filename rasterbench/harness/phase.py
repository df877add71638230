"""The slow start of a process's graph replays, and the harness's own
detector of it.

For its first seconds (0.5-49 s in 37 processes probed on an H100) a
process spaces the kernels of every CUDA graph wider apart: a graph of 512
one-element adds, the harness's own, replays at 1.32-1.37 us a node, then
at 1.00-1.02 for the rest of the process.  A frame of ~1,160 graph nodes
runs ~12 % slower in that phase.  A cell whose configuration sets
warmup_seconds serves that long in set-up and then on, a second at a time,
until the detector reads fast (at most MAX_EXTRA_SECONDS more), so that its
window never holds the phase.
"""

from __future__ import annotations

import time

NODES = 512
# between the two readings of the detector on an H100 (1.32-1.37, 1.00-1.02)
SLOW_NODE_US = 1.18
# the longest the warm-up serves on past the configuration's warm-up seconds
MAX_EXTRA_SECONDS = 35.0


class Detector:
    """The card's time a node of the harness's graph of one-element adds."""

    def __init__(self, torch):
        self.torch = torch
        self.x = torch.zeros(1, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.x.add_(1)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(NODES):
                self.x.add_(1)

    def node_us(self) -> float:
        start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / NODES


def wait_out(node_us, serve, seconds: float = MAX_EXTRA_SECONDS) -> list:
    """serve(1.0) while node_us() reads above SLOW_NODE_US, for at most
    `seconds`; returns the readings."""
    readings = [node_us()]
    deadline = time.perf_counter() + seconds
    while readings[-1] > SLOW_NODE_US and time.perf_counter() < deadline:
        serve(1.0)
        readings.append(node_us())
    return readings
