"""kernels_per_frame: device operations of one replayed frame, from the
traced slice."""

from rasterbench.metrics._ops import frame_ops


def read(ctx):
    ops, frames = frame_ops(ctx)
    if not ops or not frames:
        return None
    return len(ops) / frames
