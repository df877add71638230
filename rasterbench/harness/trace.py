"""A profiled slice of a run, read in memory.

torch.profiler records the slice; nothing is written to disk.  The summary
keeps every device operation (kernels, copies, fills) with its start, its
length and whether a graph replay launched it, the host's operations for
naming idle gaps, and the slice's bounds, all on the profiler's clock in
nanoseconds.
"""

from __future__ import annotations

import contextlib

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _activity(ev) -> str:
    try:
        return str(ev.activity_type())
    except AttributeError:  # older profilers: tell device work by its device
        return "kernel" if "CUDA" in str(ev.device_type()) else "cpu_op"


def _annotation(ev) -> bool:
    """Whether the event is a record_function span (on the host or its
    mirror on the device's timeline), not work."""
    try:
        return bool(ev.is_user_annotation())
    except AttributeError:
        return "annotation" in _activity(ev)


@contextlib.contextmanager
def profiled(label: str, out: dict):
    """Profile the block in a span named label; out["events"] holds the
    profiler's events afterwards (summarize reads them)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            yield
    out["events"] = prof.profiler.kineto_results.events()


def summarize(events, label: str) -> dict:
    bounds = None
    graph_corr = set()
    device, host = [], []
    for ev in events:
        name, act = ev.name(), _activity(ev)
        start, dur = int(ev.start_ns()), int(ev.duration_ns())
        on_device = "CUDA" in str(ev.device_type())
        if name == label or _annotation(ev):
            if name == label and not on_device:
                bounds = (start, start + dur)
            continue
        if act in DEVICE_ACTIVITIES and on_device:
            corr = {int(ev.correlation_id())}
            with contextlib.suppress(AttributeError):
                corr.add(int(ev.linked_correlation_id()))
            device.append([name, start, dur, corr])
            continue
        if "GraphLaunch" in name:
            graph_corr.add(int(ev.correlation_id()))
        host.append((name, start, start + dur))
    if bounds is None:
        raise RuntimeError(f"the profile holds no span {label!r}")
    ops = [(name, start, dur, bool(corr & graph_corr)) for name, start, dur, corr in device
           if bounds[0] <= start < bounds[1]]
    ops.sort(key=lambda op: op[1])
    return dict(bounds=bounds, ops=ops, host=host)


def busy_and_gaps(summary: dict):
    """(busy ns: the union of the device operations, [(gap ns, start, end)])
    over the slice."""
    t0, t1 = summary["bounds"]
    busy, gaps, cursor = 0, [], t0
    for _name, start, dur, _g in summary["ops"]:
        end = min(start + dur, t1)
        if start > cursor:
            gaps.append((start - cursor, cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if t1 > cursor:
        gaps.append((t1 - cursor, cursor, t1))
    return busy, gaps


def host_at(summary: dict, t: float) -> str:
    """The innermost host operation running at time t, or "host: python"."""
    best = None
    for name, start, end in summary["host"]:
        if start <= t < end and (best is None or end - start < best[1] - best[0]):
            best = (start, end, name)
    return best[2] if best else "host: python"


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by what the host was doing, in seconds."""
    by_name = {}
    for name, _start, dur, _g in summary["ops"]:
        by_name[name] = by_name.get(name, 0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _busy, gaps = busy_and_gaps(summary)
    gaps = sorted(gaps, key=lambda g: -g[0])[:top]
    return {
        "device_ops": [[name[:160], ns / 1e9] for name, ns in ops],
        "idle_gaps": [[host_at(summary, (a + b) / 2)[:160], ns / 1e9] for ns, a, b in gaps],
    }
