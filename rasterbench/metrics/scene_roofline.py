"""scene_roofline: the least time of the frame's scene work (metrics/_work:
the output written once, each draw's inputs read once, counted from the
document) over the scene kernel's device ms per frame, in per cent."""

from rasterbench.metrics._ops import layer_ms
from rasterbench.metrics._work import least_ms, scene_work


def read(ctx):
    ms = layer_ms(ctx, "scene")
    if ms is None:
        return None
    scale = ctx.config["width"] / ctx.doc["width"]
    return 100.0 * least_ms(*scene_work(ctx.doc, ctx.viewport, scale), ctx.peaks) / ms
