"""post_chain_ms: device ms a replayed frame of the operations that the
post.chain spans launched (the filter chains, their fe.* primitives
included, and the conversion of their results). Read by harness/probe.py,
with the program's tracing on, after the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "post_chain_ms")
