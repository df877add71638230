"""prepass_ms: device ms per frame of the prepass kernel."""

from rasterbench.metrics._ops import layer_ms


def read(ctx):
    return layer_ms(ctx, "prepass")
