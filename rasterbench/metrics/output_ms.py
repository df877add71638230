"""output_ms: device ms per request of the operations outside the replayed
graph (the frame's clone, the layer's copy), from the traced slice."""

from rasterbench.metrics._ops import outside_ops


def read(ctx):
    ops, requests = outside_ops(ctx)
    if not ops or not requests:
        return None
    return sum(op[2] for op in ops) / requests / 1e6
