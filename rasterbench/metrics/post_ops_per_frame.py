"""post_ops_per_frame: device operations of a frame launched inside the
three post.* spans. Read by harness/probe.py, with the program's tracing
on, after the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "post_ops_per_frame")
