"""lower_build_s: seconds of self time in the lower.build span (the outer
_Builder.build: collecting, flattening and binning the draws; the isolation
passes' builds nest inside it). Read by harness/probe.py, with the
program's tracing on, after the run's window."""

from rasterbench.harness import probe


def read(ctx):
    return probe.value(ctx, "lower_build_s")
