"""idle_in_replay_pct: the share of the probe's profiled slice's
device-idle time during which the host was inside request.replay, in per
cent. Read by harness/probe.py, with the program's tracing on, after the
run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "idle_in_replay_pct")
