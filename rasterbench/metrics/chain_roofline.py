"""chain_roofline: the least time of a frame's filter chains over their
device ms (post_chain_ms), in per cent.

The least time is counted from the document's records alone (never from
the program's plan): for each filtered element whose chain is a post
chain, one read of its source layer and one write of its result, at 16 bytes a pixel (RGBA float32), over
the element's device bounding box grown by its chain (each blur by half its
taps on each side, each offset by its shift on the side it moves to, each
morphology by its radius on each side), clipped to the viewport; at the
card's HBM rate.  Fused or not, no chain does less.

A chain that is one Gaussian blur of SourceGraphic or SourceAlpha is not a
post chain: the program runs it in its level's blur chunks, timed under
blur_ms, so it is left out here."""

from __future__ import annotations

import math

from rasterbench.metrics import post_chain_ms
from rasterbench.metrics._work import least_ms
from rasterbench.reference import raster

BYTES_A_PIXEL = 16


def _lone_blur(chain) -> bool:
    return (len(chain) == 1 and chain[0]["op"] == "blur"
            and chain[0]["input"] in ("SourceGraphic", "SourceAlpha"))


def chain_items(doc: dict):
    """The elements whose filter lowers to a post chain, in paint order."""
    def walk(items):
        for item in items:
            if "group" in item:
                yield from walk(item["children"])
            elif "filter" in item and not _lone_blur(doc["filters"][item["filter"]]):
                yield item
    return list(walk(doc["items"]))


def chain_pixels(doc: dict, viewport, scale: float) -> int:
    """The pixels of every post chain's grown box, summed."""
    h, w = viewport[2], viewport[3]
    total = 0
    for item in chain_items(doc):
        edges = raster.shape_edges(item, scale)
        xs, ys = edges[:, 0::2], edges[:, 1::2]
        top, bottom, left, right = ys.min(), ys.max(), xs.min(), xs.max()
        for prim in doc["filters"][item["filter"]]:
            if prim["op"] == "blur":
                sx, sy = prim["std"]
                gx = int(math.floor(2.5 * sx * scale))
                gy = int(math.floor(2.5 * sy * scale))
                top, bottom, left, right = top - gy, bottom + gy, left - gx, right + gx
            elif prim["op"] == "offset":
                dx, dy = prim["dx"] * scale, prim["dy"] * scale
                left, right = left + min(dx, 0.0), right + max(dx, 0.0)
                top, bottom = top + min(dy, 0.0), bottom + max(dy, 0.0)
            elif prim["op"] == "morphology":
                r = prim["radius"] * scale
                top, bottom, left, right = top - r, bottom + r, left - r, right + r
        rows = min(h, math.ceil(bottom)) - max(0, math.floor(top))
        cols = min(w, math.ceil(right)) - max(0, math.floor(left))
        total += max(rows, 0) * max(cols, 0)
    return total


def read(ctx):
    ms = post_chain_ms.read(ctx)
    if ms is None:
        return None
    scale = ctx.config["width"] / ctx.doc["width"]
    nbytes = 2 * BYTES_A_PIXEL * chain_pixels(ctx.doc, ctx.viewport, scale)
    return 100.0 * least_ms(nbytes, 0, ctx.peaks) / ms
