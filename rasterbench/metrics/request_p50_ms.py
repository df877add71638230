"""request_p50_ms: the median latency of the window's requests outside the
profiled slice (issue to completion, CUDA events on the card)."""

from rasterbench.metrics._ops import percentile


def read(ctx):
    return percentile(ctx.window.latencies_ms, 50)
