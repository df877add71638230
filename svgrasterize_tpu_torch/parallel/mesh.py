"""Device meshes: the shards a sharded render or fill runs over.

The JAX package's parallel/mesh.py builds a jax.sharding.Mesh; the port's
Mesh is a numpy object array of torch.device, one entry per shard (the same
device may appear more than once: each entry is one shard), and, across
processes, the torch.distributed group the shards span.
"""

from __future__ import annotations

import numpy as np
import torch


def _factor2(n: int) -> tuple[int, int]:
    """Split n into the most square (a, b) with a * b == n."""
    best = (n, 1)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


class Mesh:
    """Shards laid out on named axes.

    devices: object array of torch.device, one entry per shard, shaped by
    the axes.  group: None when this process runs every shard; else the
    torch.distributed group whose ranks split the shards in equal,
    consecutive blocks of the flattened array (rank r runs block r).
    """

    def __init__(self, devices, axis_names, group=None):
        arr = np.array(devices, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(arr[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.group = group
        if group is not None:
            import torch.distributed as dist

            world = dist.get_world_size(group)
            if self.devices.size % world:
                raise ValueError(f"{self.devices.size} shards do not split over {world} ranks")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_shards(self) -> range:
        """Flat indices of the shards this process runs."""
        if self.group is None:
            return range(self.size)
        import torch.distributed as dist

        per = self.size // dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        return range(rank * per, (rank + 1) * per)

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices.flat[self.local_shards[0]]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.devices.shape}, axis_names={self.axis_names})"


def make_mesh(devices=None, axis_names=("data", "seg")) -> Mesh:
    """2D mesh over the available devices: paths x segments.

    The "data" axis shards independent work items (paths, tiles, documents);
    the "seg" axis shards each item's segment list, whose partial windings
    are summed.  devices: one torch.device (or name) per shard; default
    every CUDA device.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass the devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(_factor2(len(devices))), axis_names)
