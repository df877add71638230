"""request_p95_ms: the 95th percentile of the latency of every request of the
window (issue to completion, CUDA events on the card)."""

from rasterbench.metrics._ops import percentile


def read(ctx):
    return percentile(ctx.window.latencies_ms, 95)
