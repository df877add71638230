"""blur_ms: device ms per frame of the blur-chunk kernel."""

from rasterbench.metrics._ops import layer_ms


def read(ctx):
    return layer_ms(ctx, "blur")
