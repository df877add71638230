"""torch_ops_ms: device ms per frame of the frame's operations that are not
one of the port's kernels (filter chains, canvas and tensor ops)."""

from rasterbench.metrics._ops import frame_ops, layer_of


def read(ctx):
    ops, frames = frame_ops(ctx)
    if not ops or not frames:
        return None
    return sum(op[2] for op in ops if layer_of(ctx, op[0]) is None) / frames / 1e6
