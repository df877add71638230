"""lower_pack_s: seconds of self time in the lower.pack spans
(_Builder._pack of the main stream and of each pass level; lower.collapse
left out). Read by harness/probe.py, with the program's tracing on, after
the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "lower_pack_s")
