"""The general traffic generator: a closed loop of frame requests.

A mix is a data file, traffic/<mix>.json, whose parameters this module reads:

- entry: the compiled scene's method a request calls ("render_many");
- frames_per_request: its argument (frames rendered per request);
- in_flight: requests the one client keeps issued; it waits for its oldest
  before it issues the next, as a frame pipeline that buffers that many
  outputs does;
- warmup_requests: requests issued in set-up, after the graph's capture;
- trace_seconds: the length of the profiled slice of a traced run;
- sample_layers: how many returned layers are kept for the check, drawn
  from the seed over all the window's requests (reservoir sampling).

A request's latency runs from its issue to its completion.  On the card both
ends are CUDA events, timed by the card's clock: the issue event is recorded
on an idle side stream, so it fires as the request is handed to the card, and
the completion event follows the request's work on the current stream.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "rasterbench", "traffic", f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


class CardClock:
    """Issue and completion stamps by CUDA events."""

    def __init__(self, torch):
        self.torch = torch
        self.side = torch.cuda.Stream()

    def issue(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record(self.side)
        return ev

    def done(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def wait(done) -> None:
        done.synchronize()

    @staticmethod
    def latency_ms(issue, done) -> float:
        return issue.elapsed_time(done)

    def drain(self) -> None:
        self.torch.cuda.synchronize()


class HostClock:
    """Issue and completion stamps by the host's clock (CPU runs, where the
    work is done when the call returns)."""

    @staticmethod
    def issue():
        return time.perf_counter()

    done = issue

    @staticmethod
    def wait(done) -> None:
        pass

    @staticmethod
    def latency_ms(issue, done) -> float:
        return (done - issue) * 1e3

    def drain(self) -> None:
        pass


class Window:
    """What one stretch of the closed loop did.  intervals_ms, where asked
    for: the time from each completion to the next (with the card kept busy,
    the card's time a request)."""

    def __init__(self, intervals: bool = False):
        self.attempted = 0
        self.completed = 0
        self.latencies_ms = []
        self.intervals_ms = [] if intervals else None
        self.seconds = 0.0


def closed_loop(call, clock, params: dict, *, seconds=None, requests=None, keep=None,
                window: Window | None = None) -> Window:
    """Run the closed loop until `seconds` have passed or `requests` have
    been issued, then wait for the requests in flight.

    call(): one request; returns what the client holds until it completes.
    keep(index, output): called with each completed request's output.
    The window's seconds run from the first issue to the last completion.
    """
    window = window or Window()
    in_flight = params["in_flight"]
    pending = deque()
    last = []

    def complete():
        issue, done, out, index = pending.popleft()
        clock.wait(done)
        window.latencies_ms.append(clock.latency_ms(issue, done))
        if window.intervals_ms is not None:
            if last:
                window.intervals_ms.append(clock.latency_ms(last[0], done))
            last[:] = [done]
        window.completed += 1
        if keep is not None:
            keep(index, out)

    start = time.perf_counter()
    deadline = None if seconds is None else start + seconds
    issued = 0
    while True:
        if requests is not None and issued >= requests:
            break
        if deadline is not None and time.perf_counter() >= deadline:
            break
        if len(pending) >= in_flight:
            complete()
        issue = clock.issue()
        index = window.attempted
        window.attempted += 1
        out = call()
        pending.append((issue, clock.done(), out, index))
        issued += 1
    while pending:
        complete()
    window.seconds += time.perf_counter() - start
    return window
