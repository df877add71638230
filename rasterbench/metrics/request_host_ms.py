"""request_host_ms: the median host ms of the request span (render_many:
the graph's replay, the frame's clone and the layer), over PROBE_SECONDS of
the cell's traffic. Read by harness/probe.py, with the program's tracing
on, after the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "request_host_ms")
