"""Shared arithmetic of the metric readers: percentiles and the traced
slice's device operations by layer."""

from __future__ import annotations


def percentile(values, q: float):
    """The q-th percentile of all values, linearly interpolated between the
    two nearest ranks; None without values."""
    values = sorted(values)
    if not values:
        return None
    pos = (len(values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def frame_ops(ctx):
    """(device operations the traced slice's graph replays launched, frames)."""
    if ctx.trace is None:
        return [], 0
    return [op for op in ctx.trace["ops"] if op[3]], ctx.frames


def outside_ops(ctx):
    """(device operations outside the graph replays, requests traced)."""
    if ctx.trace is None:
        return [], 0
    return [op for op in ctx.trace["ops"] if not op[3]], \
        ctx.frames // ctx.traffic["frames_per_request"]


def layer_of(ctx, name: str):
    """The port's kernel layer a device operation's name belongs to, or None."""
    for layer, pattern in ctx.kernels.items():
        if pattern.search(name):
            return layer
    return None


def layer_ms(ctx, layer: str):
    """Device ms per frame of one kernel layer; None where no frame ran it."""
    ops, frames = frame_ops(ctx)
    ns = [dur for name, _s, dur, _g in ops if layer_of(ctx, name) == layer]
    if not ns or not frames:
        return None
    return sum(ns) / frames / 1e6
