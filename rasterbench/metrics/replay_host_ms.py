"""replay_host_ms: the median host ms of the request.replay span (the
graph.replay() loop: the host inside cudaGraphLaunch), over the same
requests. Read by harness/probe.py, with the program's tracing on, after
the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "replay_host_ms")
