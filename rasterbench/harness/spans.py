"""The program's spans, read: self times from its in-memory record, and the
replayed frame's device operations attributed to the spans that launched
them.

A CUDA graph's kernels replay with no host span around their launch, so a
replay is mapped onto an eager frame of the same program: each device
operation of the eager frame takes the program spans (record_function
marks of utils.profiling.stage, on the profiler's clock) around the host
call that launched it, found through its correlation id; a replay whose
operations, in start order, bear the eager frame's names one for one gives
operation k the spans of eager operation k (copies and fills compare by
kind: a graph runs a copy node as a kernel of its own, "memcpy32_post"
where the eager frame's is "Memcpy DtoD (Device -> Device)").  The profiler at
times loses device records: of several eager frames the longest is taken
(`longest`), and a replay that lacks some of its operations is dropped
(`whole`) before the mapping.  Host times come from the
record (perf_counter_ns), device times and idle gaps from the profile
alone; the two clocks are never mixed.

Events are read into plain tuples first (`events`), so that the arithmetic
runs on synthetic lists in the tests:

    ("device", name, start, end, (correlation, linked correlation))
                                                a kernel, copy or fill
    ("launch", name, start, end, correlation)   a CUDA API call (cuda*, cu*)
    ("mark", name, start, end, None)            a record_function on the host
"""

from __future__ import annotations

import contextlib
import re

from . import trace as trace_mod

# the program's span names (utils.profiling.stage in svgrasterize_tpu_torch)
PROGRAM_TOPS = ("lower", "request")
PROGRAM_PREFIXES = ("lower.", "request.", "post.", "fe.")
POST = ("post.assemble", "post.chain", "post.retile")
LOWERING = ("lower.build", "lower.pack", "lower.collapse", "lower.groups")


# a CUDA API call, by name (not every profiler gives its events an activity type)
_API = re.compile(r"^cu(da)?[A-Z]")


def is_program_span(name: str) -> bool:
    return name in PROGRAM_TOPS or name.startswith(PROGRAM_PREFIXES)


# -- the in-memory record -----------------------------------------------------
def self_ns(record) -> dict:
    """{span id: its duration less its children's} over a record of
    utils.profiling.Span."""
    out = {s.id: s.end_ns - s.start_ns for s in record}
    for s in record:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def lowering(record) -> dict:
    """Seconds of lowering by step, from the record of one lower_scene:
    lower (its span), lower_self (what no step covers), and the four
    steps' self times (lower.collapse whole: it has no child)."""
    own = self_ns(record)
    out = {"lower": 0.0, "lower_self": 0.0, **{name: 0.0 for name in LOWERING}}
    for s in record:
        if s.name == "lower":
            out["lower"] += (s.end_ns - s.start_ns) / 1e9
            out["lower_self"] += own[s.id] / 1e9
        elif s.name in LOWERING:
            out[s.name] += own[s.id] / 1e9
    return out


def durations_ms(record, name: str) -> list:
    return [(s.end_ns - s.start_ns) / 1e6 for s in record if s.name == name]


# -- the profile --------------------------------------------------------------
def events(kineto_events) -> list:
    """The profiler's events as the tuples above (others dropped)."""
    out = []
    for ev in kineto_events:
        name, act = ev.name(), trace_mod._activity(ev)
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        on_device = "CUDA" in str(ev.device_type())
        if trace_mod._annotation(ev):
            if not on_device:
                out.append(("mark", name, start, end, None))
        elif act in trace_mod.DEVICE_ACTIVITIES and on_device:
            linked = 0
            with contextlib.suppress(AttributeError):
                linked = int(ev.linked_correlation_id())
            out.append(("device", name, start, end, (int(ev.correlation_id()), linked)))
        elif _API.match(name):
            out.append(("launch", name, start, end, int(ev.correlation_id())))
    return out


def bounds(evs, label: str):
    """(start, end) of the host mark named label."""
    for kind, name, start, end, _c in evs:
        if kind == "mark" and name == label:
            return start, end
    raise RuntimeError(f"the profile holds no mark {label!r}")


def _chain(marks, t: int) -> tuple:
    """The program spans open at host time t, innermost first."""
    open_ = [(start, name) for name, start, end in marks if start <= t < end]
    return tuple(name for _start, name in sorted(open_, reverse=True))


def eager_frame(evs, label: str) -> list:
    """[(name, device ns, spans innermost first)] of the device operations
    launched inside the mark named label, in launch order."""
    t0, t1 = bounds(evs, label)
    launches = {c: start for kind, _n, start, _e, c in evs
                if kind == "launch" and t0 <= start < t1}
    marks = [(n, s, e) for kind, n, s, e, _c in evs if kind == "mark" and is_program_span(n)]
    ops = []
    for kind, name, start, end, corr in evs:
        if kind != "device":
            continue
        if corr[0] in launches:
            ops.append((launches[corr[0]], start, name, end - start))
    ops.sort()
    return [(name, ns, _chain(marks, t)) for t, _s, name, ns in ops]


def replays(evs, label: str) -> list:
    """The graph replays launched inside the mark named label whose device
    operations all ran inside it: each [(name, device ns)] in start order.
    Replays cut by the slice's edges are dropped."""
    t0, t1 = bounds(evs, label)
    graphs = {c: t0 <= start < t1 for kind, name, start, _e, c in evs
              if kind == "launch" and "GraphLaunch" in name}
    groups, cut = {}, set()
    for kind, name, start, end, corr in evs:
        if kind != "device":
            continue
        # a graph's operations carry its launch's correlation (older
        # profilers: as the linked one)
        c = corr[0] if corr[0] in graphs else corr[1]
        if c not in graphs:
            continue
        groups.setdefault(c, []).append((start, name, end - start))
        if not (graphs[c] and t0 <= start and end <= t1):
            cut.add(c)
    return [[(name, ns) for _s, name, ns in sorted(ops)]
            for c, ops in groups.items() if c not in cut]


def op_kind(name: str) -> str:
    """A device operation's name, copies and fills by kind."""
    low = name.lower()
    return "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") else name


def longest(frames: list) -> list:
    """Of eager frames of one program, the one with the most operations: the
    profiler at times loses device records, and a lost record only shortens
    a frame."""
    return max(frames, key=len) if frames else []


def lost_records(names: list, got: list) -> bool:
    """got is names less some operations, in order: a replay whose records
    the profiler partly lost (a graph replays the same operations each time)."""
    if len(got) >= len(names):
        return False
    it = iter(names)
    return all(any(g == n for n in it) for g in got)


def whole(eager: list, complete: list) -> tuple:
    """(the replays with all their records, how many lost some): a replay
    that bears the eager frame's names with operations missing is dropped,
    as one cut by the slice is."""
    names = [op_kind(name) for name, _ns, _chain in eager]
    kept = [ops for ops in complete
            if not lost_records(names, [op_kind(name) for name, _ns in ops])]
    return kept, len(complete) - len(kept)


def map_replays(eager: list, complete: list):
    """(device ns a frame by span chain, None) where every replay bears the
    eager frame's names op for op, else (None, (replay, position, eager
    name, replay name)) at the first difference."""
    if not complete:
        return None, (None, None, None, None)
    names = [op_kind(name) for name, _ns, _chain in eager]
    by_chain = {}
    for r, ops in enumerate(complete):
        got = [op_kind(name) for name, _ns in ops]
        if got != names:
            k = next((k for k, (a, b) in enumerate(zip(names, got)) if a != b),
                     min(len(names), len(got)))
            return None, (r, k, names[k] if k < len(names) else None,
                          got[k] if k < len(got) else None)
        for (_n, _e, chain), (_n2, ns) in zip(eager, ops):
            by_chain[chain] = by_chain.get(chain, 0) + ns
    return {chain: ns / len(complete) for chain, ns in by_chain.items()}, None


def ns_in(by_chain: dict, span: str) -> float:
    """Device ns a frame of the operations launched inside `span`."""
    return sum(ns for chain, ns in by_chain.items() if span in chain)


def idle_in(gaps, evs, span: str) -> tuple:
    """(idle ns, idle ns with the host inside a mark named span) over gaps
    [(ns, start, end)] in time order (trace.busy_and_gaps); the marks of
    one thread never overlap."""
    inside = sorted((s, e) for kind, n, s, e, _c in evs if kind == "mark" and n == span)
    total = covered = j = 0
    for ns, a, b in gaps:
        total += ns
        while j < len(inside) and inside[j][1] <= a:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < b:
            covered += min(b, inside[k][1]) - max(a, inside[k][0])
            k += 1
    return total, covered
