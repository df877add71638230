"""pool_rows_ms: device ms per frame of the pool-row kernel."""

from rasterbench.metrics._ops import layer_ms


def read(ctx):
    return layer_ms(ctx, "pool_rows")
