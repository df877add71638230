"""lower_groups_s: seconds of self time in the lower.groups span
(_plan_groups: levels, blur chunks, pool rows; its packs left out). Read by
harness/probe.py, with the program's tracing on, after the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "lower_groups_s")
