"""Multi-process execution over torch.distributed, and a runnable dry run.

The twin of the JAX package's parallel/distributed.py:

  * `initialize()` joins a process group (NCCL for CUDA devices, gloo for
    the CPU) through a TCP rendezvous at a coordinator address;
  * `global_mesh()` builds the one-axis "data" mesh over every process's
    shards; canvas tile ranges (and therefore batch documents) shard over
    the processes;
  * `worker()` is one process of the dry run: every rank lowers the same
    document (host lowering is deterministic), renders the shards it owns
    and all_gathers the assembled canvas, so every rank ends with the whole
    frame;
  * `spawn_local()` launches N such workers as separate OS processes.

Run by hand:  python -m svgrasterize_tpu_torch.parallel.distributed --processes 2
(on CUDA devices by default, NCCL; `--device cpu` for gloo on the CPU)
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

DRYRUN_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="256" height="192">
  <defs>
    <linearGradient id="g"><stop offset="0" stop-color="red"/>
    <stop offset="1" stop-color="blue"/></linearGradient>
    <clipPath id="c"><circle cx="128" cy="96" r="80"/></clipPath>
  </defs>
  <rect x="8" y="8" width="240" height="176" fill="url(#g)"/>
  <g opacity="0.7"><circle cx="96" cy="96" r="60" fill="#ffaa00"/>
  <rect x="140" y="40" width="80" height="100" fill="teal"
        clip-path="url(#c)"/></g>
  <path d="M20 180 L128 20 L236 180 Z" fill="green"/>
</svg>"""

# multi-pass + pattern scene: group opacity and a mask force isolation
# passes (the pool's sub-stacks are gathered per shard), the pattern fill
# forces a pattern atlas (sub-stacks per shard at upload)
MULTIPASS_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="256" height="192">
  <defs>
    <mask id="m"><rect x="16" y="16" width="224" height="160" fill="white"/>
      <circle cx="128" cy="96" r="40" fill="black"/></mask>
    <pattern id="p" width="16" height="16" patternUnits="userSpaceOnUse">
      <rect width="8" height="8" fill="#aa2200"/></pattern>
  </defs>
  <rect x="8" y="8" width="240" height="176" fill="url(#p)"/>
  <g opacity="0.6"><rect x="40" y="40" width="120" height="80" fill="blue"/>
    <circle cx="170" cy="120" r="50" fill="red"/></g>
  <rect x="60" y="30" width="150" height="130" fill="#00aa88" mask="url(#m)"/>
</svg>"""

_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def _require_card(device: str) -> None:
    """Raise when the ranks are to render on CUDA and there is no card."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available")


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str = "cuda") -> None:
    """Join the process group at `coordinator` (host:port): NCCL when the
    ranks render on CUDA devices, gloo on the CPU."""
    import torch.distributed as dist

    _require_card(device)

    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )


def _devices_of(rank: int, devices_per_process: int, device: str) -> list:
    """A rank's shard devices: CUDA devices in rank order (wrapping over the
    host's cards), or the CPU once per shard."""
    import torch

    if device != "cuda":
        return [torch.device("cpu")] * devices_per_process
    _require_card(device)
    count = max(torch.cuda.device_count(), 1)
    return [torch.device("cuda", (rank * devices_per_process + i) % count)
            for i in range(devices_per_process)]


def global_mesh(devices_per_process: int = 1, device: str = "cuda", axis: str = "data"):
    """One-axis mesh over every process's shards (after initialize())."""
    import torch.distributed as dist

    from .mesh import Mesh

    shards = [d for rank in range(dist.get_world_size())
              for d in _devices_of(rank, devices_per_process, device)]
    return Mesh(shards, (axis,), group=dist.group.WORLD)


def worker(coordinator: str, num_processes: int, process_id: int,
           full: bool = False, devices_per_process: int = 2,
           device: str = "cuda") -> None:
    """One process of the multi-process dry run; prints one
    `[distributed] ok` line on success (rank 0).  With full, also runs a
    multi-pass + pattern plan and a sharded sprite-atlas batch."""
    initialize(coordinator, num_processes, process_id, device)
    import torch
    import torch.distributed as dist

    from .. import scene_from_str
    from ..core.transform import Transform
    from ..render_plan import execute_lowered, lower_scene
    from .atlas import render_atlas

    try:
        mesh = global_mesh(devices_per_process, device)
        home = mesh.home
        n_global = mesh.size
        if device == "cuda":
            torch.cuda.set_device(home)

        # every rank lowers the same scene: host lowering is deterministic,
        # so every rank partitions it the same way
        tr = Transform().matrix(0, 1, 0, 1, 0, 0)
        scene, _ids, _size = scene_from_str(DRYRUN_DOC)
        lowered = lower_scene(scene, tr, (0, 0, 192, 256), False, 32, device=home)
        if lowered is None:
            raise RuntimeError("the dry-run document did not lower")
        tiles = execute_lowered(lowered, home, (0, 0), False, mesh=mesh)
        if not bool(torch.isfinite(tiles).all()):
            raise RuntimeError("non-finite canvas on the global mesh")
        total = float(tiles.sum())
        gh, gw = lowered.grid
        line = (f"[distributed] ok processes={num_processes} devices={n_global}"
                f" grid={gh}x{gw} checksum={total:.2f}")

        if full:
            # stage 2: a multi-pass plan with a pattern atlas
            scene2, _ids2, _size2 = scene_from_str(MULTIPASS_DOC)
            lowered2 = lower_scene(scene2, tr, (0, 0, 192, 256), False, 32, device=home)
            if lowered2 is None or not lowered2.groups or lowered2.patterns is None:
                raise RuntimeError("stage 2 needs passes and a pattern atlas")
            tiles2 = execute_lowered(lowered2, home, (0, 0), False, mesh=mesh)
            if not bool(torch.isfinite(tiles2).all()):
                raise RuntimeError("non-finite multi-pass canvas")
            total2 = float(tiles2.sum())

            # stage 3: a sharded sprite-atlas batch — batch documents land
            # in disjoint tile ranges, so tile sharding is document sharding
            docs = []
            for color in ("#c03020", "#2060c0", "#20a040", "#a020c0"):
                d, _i, ds = scene_from_str(
                    f"<svg xmlns='http://www.w3.org/2000/svg' width='48' height='48'>"
                    f"<circle cx='24' cy='24' r='20' fill='{color}'/></svg>"
                )
                docs.append((d, (float(ds[0]), float(ds[1]))))
            atlas = render_atlas(docs, cell=64, mesh=mesh, device=home)
            if not bool(torch.isfinite(atlas.image).all()):
                raise RuntimeError("non-finite atlas")
            total3 = float(atlas.image.sum())
            line += f" multipass={total2:.2f} atlas={total3:.2f}"
        if process_id == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(num_processes: int = 2, devices_per_process: int = 2,
                timeout: float = 600.0, full: bool = False, device: str = "cuda") -> str:
    """Run the dry run as real separate OS processes on this host (gloo on
    the CPU, NCCL on CUDA devices).  Returns rank 0's `[distributed] ok
    ...` line; raises on failure, after stopping every worker."""
    _require_card(device)
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "svgrasterize_tpu_torch.parallel.distributed",
                "--worker", "--coordinator", coordinator,
                "--processes", str(num_processes), "--id", str(pid),
                "--devices-per-process", str(devices_per_process), "--device", device,
            ] + (["--full"] if full else []),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(num_processes)
    ]
    outs = []
    try:
        for pid, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"distributed worker {pid} timed out") from None
            if proc.returncode != 0:
                raise RuntimeError(
                    f"distributed worker {pid} failed rc={proc.returncode}:\n{err[-2000:]}"
                )
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ok = next((line for line in outs[0].splitlines() if "[distributed] ok" in line), None)
    if ok is None:
        raise RuntimeError(f"rank 0 produced no ok line:\n{outs[0][-2000:]}")
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="multi-process render dry run")
    parser.add_argument("--worker", action="store_true",
                        help="run as one rank (internal)")
    parser.add_argument("--full", action="store_true",
                        help="also run the multipass + atlas stages")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--id", type=int, default=0)
    parser.add_argument("--devices-per-process", type=int, default=2)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = parser.parse_args(argv)

    if args.worker:
        worker(args.coordinator, args.processes, args.id, full=args.full,
               devices_per_process=args.devices_per_process, device=args.device)
        return 0
    print(spawn_local(args.processes, args.devices_per_process, full=args.full,
                      device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
