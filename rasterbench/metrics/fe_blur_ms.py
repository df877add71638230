"""fe_blur_ms: device ms a replayed frame of the operations that the
fe.blur spans launched (that filter primitive, in every chain of the
frame). Read by harness/probe.py, with the program's tracing on, after the
run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "fe_blur_ms")
