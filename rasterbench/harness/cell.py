"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration in the file the configuration names, its document
generator in docs/<generator>.py, its traffic mix in traffic/<mix>.json, its
reference in reference/<reference>.py and each metric's reader in
metrics/<metric>.py.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import re
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import phase
from . import traffic as traffic_mod
from . import trace as trace_mod

SLICE = "rasterbench_slice"
# top-level modules that must not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "svgrasterize_tpu")
# the CLI's presentation transform: axis 0 of the canvas is the row (user y)
SWAP = (0, 1, 0, 1, 0, 0)


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return json.load(f)


def resolve(root: str, cell_name: str):
    """(benchmark, cell, config, traffic) of a cell, by name."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no cell {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root, entry["file"])
    return bench, cell, config, traffic_mod.load(root, cell["traffic"])


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's end-to-end metrics, or with traced its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def kernel_layers(root: str) -> dict:
    """{layer: compiled pattern} of the port's kernels' names (kernels.json)."""
    table = load_json(root, "rasterbench/kernels.json")
    return {layer: re.compile(r"(?<![A-Za-z0-9_])" + re.escape(name) + r"(?![A-Za-z0-9_])")
            for layer, name in table.items()}


class Reservoir:
    """A uniform sample of k outputs of a stream, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, np.random.default_rng(seed), 0, []

    def __call__(self, _index, out) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(out)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = out


def run(root: str, cell_name: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", t_start: float | None = None, fault=None, overrides=None,
        log=None) -> dict:
    """One run of a cell; returns the result line's object.

    Tests only: fault(cs, call) -> call replaces the request; overrides
    replaces keys of the configuration (a smaller canvas on the CPU)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench, cell, config, params = resolve(root, cell_name)
    config = {**config, **(overrides or {})}
    on_card = torch.device(device).type == "cuda"
    seed = int(seed) % 2 ** 64
    spans = {}

    def span(name, fn):
        t = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        spans[name] = time.perf_counter() - t
        return out

    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.frontend.svg import scene_from_str
    from svgrasterize_tpu_torch.render_plan import CompiledScene, lower_scene

    gen = importlib.import_module(f"rasterbench.docs.{config['generator']}")
    svg, doc = span("generate", lambda: gen.generate(seed, **config["args"]))
    scene, _ids, (w, h) = span("parse", lambda: scene_from_str(svg, None, config["width"], None))
    viewport = (0, 0, int(h), int(w))
    lowered = span("lower", lambda: lower_scene(scene, Transform().matrix(*SWAP), viewport,
                                                False, config["tile"], device=device))
    if lowered is None or bool(lowered.groups) != config["passes"]:
        raise RuntimeError(f"{config['name']}: the document must lower "
                           f"{'with' if config['passes'] else 'without'} isolation passes")
    cs = span("upload", lambda: CompiledScene(lowered, viewport, False, device=device))
    entry = getattr(cs, params["entry"])
    call = lambda: entry(params["frames_per_request"])  # noqa: E731
    if fault is not None:
        call = fault(cs, call)
    span("capture", call)  # the first request: an eager frame, then the capture
    clock = traffic_mod.CardClock(torch) if on_card else traffic_mod.HostClock()
    traffic_mod.closed_loop(call, clock, params, requests=params["warmup_requests"])
    warmup = traffic_mod.Window(intervals=True)
    if config["warmup_seconds"]:
        # serve through the slow start of graph replays (phase.py); slow_start_s
        # reads its length from this traffic
        detector = phase.Detector(torch) if on_card else None
        serve = lambda s: traffic_mod.closed_loop(call, clock, params, seconds=s,  # noqa: E731
                                                  window=warmup)
        serve(config["warmup_seconds"])
        if detector is not None:
            readings = phase.wait_out(detector.node_us, serve)
            log(f"slow start: {readings[-1]:.4f} us a node of the detector after"
                f" about {config['warmup_seconds'] + len(readings) - 1} s of warm-up traffic")
    clock.drain()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # the card counts every replayed frame; the CPU path keeps no count
    counted = on_card or cs.replays > 0
    replays, launches = cs.replays, cs.frame_launches

    # the measured window
    sample = Reservoir(params["sample_layers"], seed ^ 0x5EED)
    window = traffic_mod.Window(intervals=traced)
    slice_window, profile = None, {}
    if not traced:
        traffic_mod.closed_loop(call, clock, params, seconds=seconds, keep=sample, window=window)
    else:
        traffic_mod.closed_loop(call, clock, params, seconds=seconds / 2, keep=sample,
                                window=window)
        with trace_mod.profiled(SLICE, profile):
            slice_window = traffic_mod.closed_loop(call, clock, params,
                                                   seconds=params["trace_seconds"], keep=sample)
        traffic_mod.closed_loop(call, clock, params,
                                seconds=max(0.0, seconds / 2 - params["trace_seconds"]),
                                keep=sample, window=window)
    clock.drain()
    # the peak less the layers sampled for the check, which the window holds
    # besides what serving holds (from its third request on, always both)
    peak = max(setup_peak, torch.cuda.max_memory_allocated() - sum(
        layer.image.untyped_storage().nbytes() for layer in sample.items)) if on_card else 0
    requests = window.attempted + (slice_window.attempted if slice_window else 0)
    frames = [cs.replays - replays, requests * params["frames_per_request"]] if counted else []
    relaunched = cs.frame_launches != launches

    summary, slice_frames = None, 0
    if traced:
        summary = trace_mod.summarize(profile.pop("events"), SLICE)
        slice_frames = slice_window.completed * params["frames_per_request"]
        log(f"trace: {len(summary['ops'])} device operations in the slice,"
            f" {sum(op[3] for op in summary['ops'])} of them in graph replays;"
            f" {slice_frames} frames")

    # the program's state is freed before the reference runs
    del cs, entry, call, lowered, scene
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks, notes = check(root, config, doc, viewport, sample.items, window, device, log)
    if frames and frames[0] != frames[1]:
        notes.append(f"the window's requests replayed {frames[0]} frames, {frames[1]} asked for")
    if relaunched:
        notes.append(f"the captured frame's launches changed from {launches}"
                     f" to {cs.frame_launches}")
    correct = all(v <= lim for v, lim in checks.values()) and not notes

    ctx = SimpleNamespace(
        root=root, cell=cell, config=config, traffic=params, doc=doc, viewport=viewport,
        spans=spans, setup_s=setup_s, warmup=warmup, window=window, peak_bytes=peak, trace=summary,
        frames=slice_frames, kernels=kernel_layers(root) if traced else None,
        peaks=load_json(root, "rasterbench/peaks.json"),
    )
    metrics = {}
    for m in cell_metrics(bench, cell_name, traced):
        value = importlib.import_module(f"rasterbench.metrics.{m['name']}").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": correct,
        "attempted": window.attempted + (slice_window.attempted if slice_window else 0),
        "failed": (window.attempted - window.completed) + (
            slice_window.attempted - slice_window.completed if slice_window else 0),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        busy, _gaps = trace_mod.busy_and_gaps(summary)
        result["device"]["busy_s"] = busy / 1e9
        result["device"]["window_s"] = (summary["bounds"][1] - summary["bounds"][0]) / 1e9
        result["breakdown"] = trace_mod.breakdown(summary)
    for note in notes:
        log(f"check: {note}")
    log(f"spans: {json.dumps({k: round(v, 6) for k, v in spans.items()})}, setup_s {setup_s:.6f}")
    if window.latencies_ms:
        log(f"window: {window.completed} requests in {window.seconds:.6f} s, latency ms median"
            f" {statistics.median(window.latencies_ms):.6f}")
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        log(f"{name} {v!r} limit {lim!r}")
    return result


def check(root: str, config: dict, doc: dict, viewport, layers: list, window, device,
          log) -> tuple:
    """({number: (value, limit)}, [what else is wrong]) of the sampled layers
    against the configuration's reference."""
    import torch

    from rasterbench.reference import compare

    notes = []
    if window.completed != window.attempted:
        notes.append(f"{window.attempted - window.completed} requests never completed")
    if not layers:
        notes.append("no layer was sampled")
    h, w = viewport[2], viewport[3]
    ref_mod = importlib.import_module(f"rasterbench.reference.{config['reference']}")
    t = time.perf_counter()
    ref = ref_mod.render(doc, h, w, config["width"] / doc["width"], tile=config["tile"],
                         dtype=getattr(torch, config["precision"]), device=device)
    worst = {}
    for layer in layers:
        image = layer.image
        if tuple(image.shape) != (h, w, 4) or tuple(layer.offset) != (0, 0) \
                or not layer.pre_alpha or layer.linear_rgb:
            notes.append(f"a layer of shape {tuple(image.shape)}, offset {layer.offset},"
                         f" pre_alpha {layer.pre_alpha}, linear_rgb {layer.linear_rgb}")
            continue
        for name, value in compare.gaps(image.to(ref.dtype), ref, config["block"]).items():
            worst[name] = max(worst.get(name, 0.0), value)
    log(f"reference: {time.perf_counter() - t:.3f} s for {len(layers)} sampled layers"
        f" (widest single gap {worst.get('max_gap', float('nan'))!r}, not compared)")
    limits = config["limits"]
    if not worst:
        return {name: (float("inf"), lim) for name, lim in limits.items()}, notes
    return {name: (worst[name], lim) for name, lim in limits.items()}, notes
