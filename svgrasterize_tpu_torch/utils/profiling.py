"""Tracing and profiling instrumentation.

The twin of the JAX package's utils/profiling.py:

  * `stage(name)` — the port's one span: with tracing on (`enable`) it
    records host wall time per stage for `report()`, appends the span to an
    in-memory record (`spans()`) and mirrors it as a
    `torch.profiler.record_function`, so profiler traces carry it on the
    device trace's clock; with tracing off it is one check of a flag
  * `report()` — stage table
  * `spans()` — the record: the newest RECORD_LIMIT closed spans
  * `trace_to(dir)` — wraps torch.profiler (CPU, plus CUDA when a card is
    present) and writes a Chrome trace into the directory
  * `checked(fn)` — raises on the NaN, division-by-zero and out-of-bounds
    index errors that the JAX package's checkify wrapper raises on
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
# whether tracing is on (enable() sets it); a per-request path reads it
# before a span, so that tracing off costs it one check
tracing = False

# the record keeps the newest spans; a span's parent may have been dropped
RECORD_LIMIT = 1 << 18


class Span(NamedTuple):
    """One closed span: its id, name, the enclosing span's id (None at the
    top), the id of the request it belongs to (None outside a request) and
    its time.perf_counter_ns() start and end."""

    id: int
    name: str
    parent: int | None
    request: int | None
    start_ns: int
    end_ns: int


_record: deque = deque(maxlen=RECORD_LIMIT)
_open: list = []  # (id, request) of the spans open now, innermost last (one thread)
_span_ids = itertools.count()
_request_ids = itertools.count()
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    global tracing
    tracing = on


def reset() -> None:
    _times.clear()
    _counts.clear()
    _record.clear()


def spans() -> list:
    """The record: closed spans (Span), oldest first."""
    return list(_record)


def stage(name: str, request: bool = False):
    """A span named `name` around a pipeline stage (a context manager).

    With tracing off it returns a shared null context: no clock, no
    record_function, no allocation.  With tracing on it records the
    stage's host wall time and appends a Span to the record when it ends.
    request=True starts a new request id, which the spans inside it share;
    inside a request such a span is not opened (the outermost one covers
    the call).  The time is the host's: the stage does not synchronize the
    card, so on CUDA it covers what the host did and enqueued in the stage,
    not the card's work (end the stage with torch.cuda.synchronize() to
    include it).
    """
    if not tracing or (request and _open and _open[-1][1] is not None):
        return _OFF
    return _Stage(name, request)


class _Stage:
    __slots__ = ("name", "new_request", "request", "id", "parent", "mirror", "start")

    def __init__(self, name: str, new_request: bool):
        self.name = name
        self.new_request = new_request

    def __enter__(self):
        self.parent, request = _open[-1] if _open else (None, None)
        if self.new_request:
            request = next(_request_ids)
        self.request = request
        self.id = next(_span_ids)
        _open.append((self.id, request))
        self.mirror = torch.profiler.record_function(self.name)
        self.mirror.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.mirror.__exit__(*exc)
        _open.pop()
        _record.append(Span(self.id, self.name, self.parent, self.request, self.start, end))
        _times[self.name] += (end - self.start) / 1e9
        _counts[self.name] += 1
        return False


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
