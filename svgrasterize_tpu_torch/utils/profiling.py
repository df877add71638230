"""Tracing and profiling instrumentation.

The twin of the JAX package's utils/profiling.py:

  * `stage(name)` — context manager recording host wall time per stage,
    nested, also emitting a `torch.profiler.record_function` so stages show
    up in profiler traces
  * `report()` — stage table
  * `trace_to(dir)` — wraps torch.profiler (CPU, plus CUDA when a card is
    present) and writes a Chrome trace into the directory
  * `checked(fn)` — raises on the NaN, division-by-zero and out-of-bounds
    index errors that the JAX package's checkify wrapper raises on
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_enabled = False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    _times.clear()
    _counts.clear()


@contextlib.contextmanager
def stage(name: str):
    """Record wall time for a pipeline stage (and tag it for traces).

    The time is the host's: the stage does not synchronize the card, so on
    CUDA it covers what the host did and enqueued in the stage, not the
    card's work (end the stage with torch.cuda.synchronize() to include it).
    """
    if not _enabled:
        with torch.profiler.record_function(name):
            yield
        return
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _times[name] += time.perf_counter() - start
    _counts[name] += 1


def report() -> str:
    if not _times:
        return "(no stages recorded)"
    width = max(len(k) for k in _times)
    lines = [
        f"{name:<{width}}  {seconds * 1e3:9.1f} ms  x{_counts[name]}"
        for name, seconds in sorted(_times.items(), key=lambda kv: -kv[1])
    ]
    return "\n".join(lines)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a profile of the block into log_dir as a Chrome trace
    (`<worker>.<time>.pt.trace.json`; view with Perfetto or tensorboard).
    CUDA activity is traced when a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


# torch's `1 / x` is a reciprocal, so reciprocals count as divisions
_DIVISIONS = {torch.ops.aten.div, torch.ops.aten.div_, torch.ops.aten.floor_divide,
              torch.ops.aten.floor_divide_, torch.ops.aten.reciprocal,
              torch.ops.aten.reciprocal_}
# factories whose output is uninitialized memory, which may hold NaN bits
_UNINITIALIZED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                  torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                  torch.ops.aten.new_empty_strided}


def _check_bounds(shape, dim: int, index) -> None:
    size = shape[dim]
    index = torch.as_tensor(index)
    bad = (index < -size) | (index >= size)
    if bool(bad.any()):
        first = int(index[bad].reshape(-1)[0])
        raise RuntimeError(
            f"out-of-bounds indexing for array of shape {tuple(shape)}: index {first}"
            f" is out of bounds for axis {dim} with size {size}"
        )


class _Checks(TorchDispatchMode):
    """Checks every ATen op the wrapped function runs: a zero divisor and a
    tensor index out of range (index, index_select, gather; on the card
    these would end in a device-side assert) before it runs, and a NaN in a
    floating output after it.  Python integer indices are checked by torch
    itself, which raises IndexError."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _DIVISIONS:
            divisor = args[0] if packet in (torch.ops.aten.reciprocal,
                                            torch.ops.aten.reciprocal_) else args[1]
            if bool((torch.as_tensor(divisor) == 0).any()):
                raise RuntimeError("division by zero")
        elif packet is torch.ops.aten.index:
            for dim, index in enumerate(args[1]):
                if index is not None and index.dtype != torch.bool:
                    _check_bounds(args[0].shape, dim, index)
        elif packet in (torch.ops.aten.index_select, torch.ops.aten.gather):
            _check_bounds(args[0].shape, args[1] % max(args[0].dim(), 1), args[2])
        out = func(*args, **kwargs)
        if packet not in _UNINITIALIZED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and bool(torch.isnan(t).any()):
                    raise RuntimeError(f"nan generated by primitive: {packet.__name__}")
        return out


def checked(fn):
    """Wrap fn so NaN / division / out-of-bounds index errors raise.

    The counterpart of checkify with float and index checks: every ATen op
    fn runs is checked (see _Checks), which synchronizes with the card after
    each op on CUDA tensors — a debugging tool, never on the render path.
    """

    def wrapper(*args, **kwargs):
        with _Checks():
            return fn(*args, **kwargs)

    return wrapper
