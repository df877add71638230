"""output_roofline: the least time of a request's output over the device ms
of its output path (output_ms: the operations outside the replayed graph,
the frame's clone and the layer's copy), in per cent.  The least time is
one write of the returned viewport layer (RGBA float32), counted from the
viewport alone, at the card's HBM rate."""

from rasterbench.metrics import output_ms
from rasterbench.metrics._work import least_ms


def read(ctx):
    ms = output_ms.read(ctx)
    if ms is None:
        return None
    h, w = ctx.viewport[2], ctx.viewport[3]
    return 100.0 * least_ms(h * w * 16, 0, ctx.peaks) / ms
