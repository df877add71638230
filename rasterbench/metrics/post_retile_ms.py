"""post_retile_ms: device ms a replayed frame of the operations that the
post.retile spans launched (merge_at onto zeros and the re-tiling copy).
Read by harness/probe.py, with the program's tracing on, after the run's
window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "post_retile_ms")
