"""post_assemble_ms: device ms a replayed frame of the operations that the
post.assemble spans launched (a filter part's span assembly, scatter,
permute, crop). Read by harness/probe.py, with the program's tracing on,
after the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "post_assemble_ms")
