"""Time the whole-image winding kernel's paths of one source tree on a card.

    python3 winding_ab.py [--root DIR] [--label NAME] [--plain-pinned]

Imports svgrasterize_tpu_torch from DIR (default: this script's directory),
builds its CUDA kernels there, and prints one JSON line: the card's name and
power limit as nvidia-smi gives them, then

- interp_render_ms: wall time of one Scene.render of chip_smoke.interp_doc
  at 1488^2 on the card, synchronized, median of RENDERS warm renders;
  interp_winding_host_ms: the host time spent inside fused_exec.winding_batch
  in one of those renders (median), where a staging buffer's wait would show;
- masks_call_ms: winding_batch of that render's masks in one batch (packing,
  upload, launch), CUDA events; masks_dev_ms: its launch with the host ahead;
- s16 / s256 / s2048 (_ms, _dev_ms): fused_exec.winding on chip_smoke's
  random lists at 200 x 300, 513 x 777 and 1024^2, each checked against
  coverage.winding within chip_smoke.WINDING_TOL;
- fill_call_ms: parallel.batch.fill_batch of chip_smoke's fill batch (64
  paths of 64 edges at 256^2); fill_dev_ms: its winding_uniform launch with
  the host ahead.

--plain-pinned makes upload_winding_batch take a new torch.empty(...,
pin_memory=True) per call (PyTorch's caching host allocator) in place of its
staging buffers.  To compare trees, unpack each one (git archive) into a
directory that .gitignore lists and run this script on each in one call on
one card, in the order A, B, B, A.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs

RENDERS = 15


class _NoEvent:
    def record(self, _stream) -> None:
        pass


def _plain_pinned(fused_exec, torch) -> None:
    """upload_winding_batch with a new pinned tensor per call."""
    def take(_self, n):
        return torch.empty(n, dtype=torch.float32, pin_memory=True), _NoEvent()

    fused_exec._Staging.take = take


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--plain-pinned", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("winding_ab: no CUDA device; nothing was run\n")
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from svgrasterize_tpu_torch.core.transform import Transform
    from svgrasterize_tpu_torch.frontend.svg import scene_from_filepath
    from svgrasterize_tpu_torch.ops import coverage, cuda_lib, fused_exec
    from svgrasterize_tpu_torch.parallel import batch as pbatch
    from svgrasterize_tpu_torch.text.fonts import DEFAULT_FONTS, FontsDB
    from svgrasterize_tpu_torch.utils.stress import edge_batch

    if not fused_exec.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {fused_exec.__file__}, not the tree at {root}")
    if args.plain_pinned:
        _plain_pinned(fused_exec, torch)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cuda_lib.build()
    cuda_lib.load()
    res = dict(label=args.label, card=smi, plain_pinned=args.plain_pinned)

    # the interpreter document: whole renders, and the host's time inside
    # winding_batch (no synchronize added around it)
    calls, host_s = [], [0.0]
    inner = fused_exec.winding_batch

    def timed(lists, sizes, device):
        calls.append((lists, sizes))
        t0 = time.perf_counter()
        try:
            return inner(lists, sizes, device)
        finally:
            host_s[0] += time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        doc = os.path.join(tmp, "interp.svg")
        with open(doc, "w", encoding="utf-8") as f:
            f.write(cs.interp_doc(cs.INTERP_DRAWS, cs.CLI_SIZE, seed=0))
        fonts = FontsDB()
        fonts.register_file(DEFAULT_FONTS)
        scene, _ids, (w, h) = scene_from_filepath(doc, None, None, fonts)
    vp = (0, 0, int(h), int(w))
    swap = Transform().matrix(0, 1, 0, 1, 0, 0)
    fused_exec.winding_batch = timed
    try:
        scene.render(swap, viewport=vp, device=dev)  # warm-up; records the masks
        masks = [(np.asarray(e, np.float32).reshape(-1, 4), s)
                 for lists, sizes in calls for e, s in zip(lists, sizes)]
        render_ms, wind_ms = [], []
        for _ in range(RENDERS):
            host_s[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scene.render(swap, viewport=vp, device=dev)
            torch.cuda.synchronize()
            render_ms.append((time.perf_counter() - t0) * 1e3)
            wind_ms.append(host_s[0] * 1e3)
    finally:
        fused_exec.winding_batch = inner
    res.update(interp_render_ms=statistics.median(render_ms),
               interp_winding_host_ms=statistics.median(wind_ms),
               interp_batches=len(calls) // (RENDERS + 1), masks=len(masks))

    lists, shapes = [m[0] for m in masks], [m[1] for m in masks]
    res["masks_call_ms"] = cs._time_ms(torch, lambda: fused_exec.winding_batch(lists, shapes, dev),
                                       50)
    uploaded = fused_exec.upload_winding_batch(lists, shapes, dev)
    res["masks_dev_ms"] = cs._device_ms(torch, lambda: fused_exec.launch_winding_batch(uploaded),
                                        50)

    # chip_smoke's random lists
    rng = np.random.default_rng(4)
    for segs, hh, ww in ((16, 200, 300), (256, 513, 777), (2048, 1024, 1024)):
        e = rng.uniform(-8, max(hh, ww) + 8, (segs, 4)).astype(np.float32)
        e[::9, 2] = e[::9, 0]
        e[::13] = 0.0
        lines = torch.from_numpy(e).to(dev)
        err = float((fused_exec.winding(lines, hh, ww) - coverage.winding(lines, hh, ww))
                    .abs().max())
        if not err <= cs.WINDING_TOL:
            raise RuntimeError(f"winding kernel disagrees at S={segs}: {err}")
        res[f"s{segs}_ms"] = cs._time_ms(torch, lambda: fused_exec.winding(lines, hh, ww), 20)
        res[f"s{segs}_dev_ms"] = cs._device_ms(torch, lambda: fused_exec.winding(lines, hh, ww),
                                               20)

    # the fill batch
    fl, fc = edge_batch(cs.FILL_PATHS, cs.FILL_SEGS, float(cs.FILL_SIZE), seed=0)
    fl = torch.as_tensor(np.asarray(fl, np.float32), device=dev)
    fc = torch.as_tensor(np.asarray(fc, np.float32), device=dev)
    n = cs.FILL_SIZE
    res["fill_call_ms"] = cs._time_ms(torch, lambda: pbatch.fill_batch(fl, fc, n, n, device=dev),
                                      20)
    res["fill_dev_ms"] = cs._device_ms(torch, lambda: fused_exec.winding_uniform(fl, n, n), 20)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
