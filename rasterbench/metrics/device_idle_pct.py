"""device_idle_pct: the share of the traced slice in which no device operation
ran, in per cent."""

from rasterbench.harness.trace import busy_and_gaps


def read(ctx):
    if ctx.trace is None:
        return None
    busy, _gaps = busy_and_gaps(ctx.trace)
    t0, t1 = ctx.trace["bounds"]
    return 100.0 * (1.0 - busy / (t1 - t0))
