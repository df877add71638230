"""The program's own spans in a traced run: one more pass through lowering,
serving and a profiled frame, with the program's tracing on.

The run's set-up and window keep the program's tracing off, so the run's
end-to-end and per-layer numbers are what they would be without this file.
After them, when the first reader of a span metric asks (`of`), this module
turns the program's tracing on (`utils.profiling.enable`), parses and lowers
the cell's document again (the run's, from the --seed of the command line
that started the process; SEED where it has none), uploads it, captures its
frame and serves the cell's traffic:

- lowering: the lower.* spans' self times, from the program's record;
- PROBE_SECONDS of requests with tracing off, on, then off: the median
  host ms of the request and request.replay spans, from the record of the
  middle window, and what tracing costs a request;
- one torch.profiler session: a few requests (a session loses its first
  device records: on an H100 the first frame's first kernels), one eager
  frame (render_tiles), each of its device operations with the program
  spans that launched it (spans.eager_frame), then trace_seconds of
  requests: the graph replays, mapped op for op onto the eager frame
  (spans.map_replays), and the idle gaps with the host inside
  request.replay; then a second eager frame.  The profiler at times loses
  device records further on too: the longer eager frame is mapped, replays
  with records lost are dropped, and where no replay maps, another session
  is profiled, up to ATTEMPTS.

The program's state is freed afterwards.  A program without a span record
(utils.profiling.spans) gives None, and so does each of its readers.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import statistics
import sys
import time
import traceback

from . import spans as spans_mod
from . import trace as trace_mod
from . import traffic as traffic_mod

SEED = 0
PROBE_SECONDS = 1.0
# an eager frame before the slice and one after it (the longer is mapped)
FRAME_LABELS = ("rasterbench_probe_frame", "rasterbench_probe_frame_after")
# profiled sessions made until one maps its replays
ATTEMPTS = 3
SLICE_LABEL = "rasterbench_probe_slice"
# the filter primitives a metric reads (fe_<kind>_ms)
PRIMITIVES = ("blur", "merge", "color_matrix", "composite")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def of(ctx):
    """The probe's numbers for the run ctx describes, made once a run; None
    where the program keeps no span record or the probe failed."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = run(ctx)
    return ctx.program_spans


def value(ctx, name: str):
    """One of the probe's numbers, or None."""
    numbers = of(ctx)
    return None if numbers is None else numbers.get(name)


def run(ctx, device=None, log=_log):
    import torch

    from svgrasterize_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        log("program spans: the program keeps no span record; no span metric")
        return None
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    t = time.perf_counter()
    profiling.reset()
    profiling.enable(True)
    try:
        return _probe(ctx, torch, profiling, device, log)
    except Exception:  # noqa: BLE001  the run's other metrics stand; these are left out
        log("program spans: the probe failed\n" + traceback.format_exc())
        return None
    finally:
        profiling.enable(False)
        profiling.reset()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        log(f"program spans: the probe took {time.perf_counter() - t:.3f} s")


def _seed() -> int:
    """The --seed of the process's command line (rasterbench/run.py), or SEED."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=SEED)
    return ap.parse_known_args(sys.argv[1:])[0].seed % 2 ** 64


def _probe(ctx, torch, profiling, device, log) -> dict:
    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.frontend.svg import scene_from_str
    from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene

    from .cell import SWAP

    config, params = ctx.config, ctx.traffic
    on_card = device == "cuda"
    gen = importlib.import_module(f"rasterbench.docs.{config['generator']}")
    seed = _seed()
    svg, _doc = gen.generate(seed, **config["args"])
    scene, _ids, _size = scene_from_str(svg, None, config["width"], None)
    profiling.reset()
    lowered = lower_scene(scene, Transform().matrix(*SWAP), ctx.viewport, False, config["tile"],
                          device=device)
    steps = spans_mod.lowering(profiling.spans())
    out = {f"{name.replace('.', '_')}_s": steps[name] for name in spans_mod.LOWERING}
    harness_lower = ctx.spans.get("lower")
    log(f"program spans: seed {seed}: lower {steps['lower']:.6f} s (the run's lower_s"
        f" {harness_lower}),"
        f" uncovered {steps['lower_self']:.6f} s"
        f" ({100 * steps['lower_self'] / max(steps['lower'], 1e-12):.3f} %); "
        + ", ".join(f"{k} {steps[k]:.6f}" for k in spans_mod.LOWERING))

    cs = CompiledScene(lowered, ctx.viewport, False, device=device)
    entry = getattr(cs, params["entry"])
    call = lambda: entry(params["frames_per_request"])  # noqa: E731
    clock = traffic_mod.CardClock(torch) if on_card else traffic_mod.HostClock()
    traffic_mod.closed_loop(call, clock, params, requests=params["warmup_requests"])
    clock.drain()

    # requests outside any profile, on one graph with tracing off, on, off:
    # the host's time in the request spans, and what tracing costs a request
    ms_a_request = []
    for traced in (False, True, False):
        profiling.enable(traced)
        profiling.reset()
        window = traffic_mod.closed_loop(call, clock, params, seconds=PROBE_SECONDS)
        clock.drain()
        ms_a_request.append(window.seconds * 1e3 / max(window.completed, 1))
        if traced:
            record = profiling.spans()
    profiling.enable(True)
    request_ms = spans_mod.durations_ms(record, "request")
    replay_ms = spans_mod.durations_ms(record, "request.replay")
    if request_ms:
        out["request_host_ms"] = statistics.median(request_ms)
    if replay_ms:
        out["replay_host_ms"] = statistics.median(replay_ms)
    log(f"program spans: ms a request with tracing off, on, off {ms_a_request} (the run's"
        f" window {ctx.window.seconds * 1e3 / max(ctx.window.completed, 1):.6f}); host ms"
        f" median request {out.get('request_host_ms')}, request.replay"
        f" {out.get('replay_host_ms')} over {len(request_ms)} requests")
    if not on_card:
        return out

    device = _until_mapped(lambda: _session(torch, cs, call, clock, params,
                                            out.get("replay_host_ms"), log), log)
    del cs, entry, call, lowered, scene
    out.update(device)
    return out


def _until_mapped(session, log) -> dict:
    """The device metrics of the first of ATTEMPTS profiled sessions whose
    replays map (else of the last that gave any)."""
    device = {}
    for attempt in range(1, ATTEMPTS + 1):
        try:
            device, mapped = session()
        except Exception:  # noqa: BLE001  the record's metrics stand; another session is tried
            log("program spans: the profiled session failed\n" + traceback.format_exc())
            mapped = False
        if mapped:
            break
        log(f"program spans: profiled session {attempt} of {ATTEMPTS} mapped no frame")
    return device


def _session(torch, cs, call, clock, params, replay_host_ms, log) -> tuple:
    """One profiled session: warm requests, an eager frame, the slice of
    requests, another eager frame; its device metrics (_device)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def eager(label):
        with record_function(label):
            cs.render_tiles()
            torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traffic_mod.closed_loop(call, clock, params, requests=2 * params["in_flight"])
        clock.drain()
        eager(FRAME_LABELS[0])
        with record_function(SLICE_LABEL):
            traffic_mod.closed_loop(call, clock, params, seconds=params["trace_seconds"])
        clock.drain()
        torch.cuda.synchronize()
        eager(FRAME_LABELS[1])
    return _device(prof.profiler.kineto_results.events(), replay_host_ms, log)


def _device(events, replay_host_ms, log) -> tuple:
    """(the device metrics, whether the replays mapped): the replays mapped
    onto the eager frame, and the idle gaps with the host inside
    request.replay (whose host time under the profiler is logged beside
    replay_host_ms, without it)."""
    out, t = {}, time.perf_counter()
    summary = trace_mod.summarize(events, SLICE_LABEL)
    _busy, gaps = trace_mod.busy_and_gaps(summary)
    evs = spans_mod.events(events)
    idle, covered = spans_mod.idle_in(gaps, evs, "request.replay")
    if idle:
        out["idle_in_replay_pct"] = 100.0 * covered / idle
    t0, t1 = spans_mod.bounds(evs, SLICE_LABEL)
    profiled = [(e - s) / 1e6 for kind, n, s, e, _c in evs
                if kind == "mark" and n == "request.replay" and t0 <= s < t1]
    if profiled:
        log(f"program spans: request.replay host ms median {replay_host_ms} unprofiled,"
            f" {statistics.median(profiled):.6f} under the profiler")
    frames = [spans_mod.eager_frame(evs, label) for label in FRAME_LABELS]
    eager = spans_mod.longest(frames)
    complete, lossy = spans_mod.whole(eager, spans_mod.replays(evs, SLICE_LABEL))
    log(f"program spans: eager frames of {[len(f) for f in frames]} operations;"
        f" {lossy} replays with records lost dropped")
    by_chain, miss = spans_mod.map_replays(eager, complete)
    if by_chain is None:
        log(f"program spans: {len(complete)} complete replays; replay {miss[0]} differs from"
            f" the eager frame ({len(eager)} operations) first at operation {miss[1]}:"
            f" {miss[2]!r} against {miss[3]!r}; no mapped metric")
        return out, False
    total = sum(by_chain.values())
    post = {name: spans_mod.ns_in(by_chain, name) for name in spans_mod.POST}
    outside = sum(ns for chain, ns in by_chain.items()
                  if not any(name in chain for name in spans_mod.POST))
    log(f"program spans: all {len(complete)} complete replays in the slice matched the eager"
        f" frame op for op ({len(eager)} operations); a frame's device ms"
        f" {total / 1e6:.6f} = post " + " + ".join(f"{post[n] / 1e6:.6f}" for n in spans_mod.POST)
        + f" + outside them {outside / 1e6:.6f} ({(sum(post.values()) + outside) / total:.6f}"
        f" of it; {time.perf_counter() - t:.3f} s to read)")
    inner = {}
    for chain, ns in by_chain.items():
        key = chain[0] if chain else "(none)"
        inner[key] = inner.get(key, 0) + ns
    log("program spans: device ms a frame by innermost span: " + ", ".join(
        f"{k} {v / 1e6:.6f}" for k, v in sorted(inner.items(), key=lambda kv: -kv[1])))
    if any(post.values()):
        for name, ns in post.items():
            out[name.replace(".", "_") + "_ms"] = ns / 1e6
        out["post_ops_per_frame"] = sum(
            1 for _n, _ns, chain in eager if any(name in chain for name in spans_mod.POST))
        for kind in PRIMITIVES:
            out[f"fe_{kind}_ms"] = spans_mod.ns_in(by_chain, f"fe.{kind}") / 1e6
    return out, True
