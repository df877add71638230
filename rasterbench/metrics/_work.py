"""The least work of a frame, counted from the document and the frame alone
(never from the program's plan), so a change to the plan leaves it standing.

Bytes: the viewport's output written once (RGBA float32) and each draw's
inputs read once (every number the document gives its shape, its paint and
its clip, as float32).  Operations: ITEM_PIXEL_OPS per pixel of each rect's
and circle's exact area (paths are left out, so the count stays a least
one).
"""

from __future__ import annotations

import math

# per (draw, covered pixel): coverage 2, clip 1, opacity 1, OVER of four
# channels 9, the paint's colour not counted
ITEM_PIXEL_OPS = 14


def _numbers(item: dict, doc: dict) -> int:
    n = {"rect": 4, "circle": 3}.get(item.get("shape"), 0)
    n += sum(len(cmd) - 1 for cmd in item.get("d", ()))
    kind, value = item.get("paint", ("solid", None))
    if kind == "gradient":
        grad = doc["gradients"][value]
        n += 5 + 5 * len(grad["stops"])
    else:
        n += 4
    n += 1  # opacity
    if item.get("clip"):
        n += len(doc["clips"][item["clip"]]) - 1
    for child in item.get("children", ()):
        n += _numbers(child, doc)
    return n


def _area(item: dict, scale: float) -> float:
    a = 0.0
    if item.get("shape") == "rect":
        a = item["w"] * item["h"]
    elif item.get("shape") == "circle":
        a = math.pi * item["r"] ** 2
    return a * scale * scale + sum(_area(c, scale) for c in item.get("children", ()))


def scene_work(doc: dict, viewport, scale: float) -> tuple:
    """(bytes, FP32 operations) of the frame's least work."""
    h, w = viewport[2], viewport[3]
    nbytes = h * w * 16 + 4 * sum(_numbers(item, doc) for item in doc["items"])
    ops = ITEM_PIXEL_OPS * sum(_area(item, scale) for item in doc["items"])
    return nbytes, ops


def least_ms(nbytes: float, ops: float, peaks: dict) -> float:
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops_per_s"]) * 1e3
