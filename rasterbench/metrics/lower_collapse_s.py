"""lower_collapse_s: seconds in the lower.collapse spans
(_Builder._collapse_runs: precomposing runs of scene-static items into
paint fields). Read by harness/probe.py, with the program's tracing on,
after the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "lower_collapse_s")
