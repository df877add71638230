"""Multi-device scaling: meshes, sharded rasterization, collectives.

Paths and tiles are data-parallel over a mesh's shards, edge lists are
split over a second axis (partial winding, then a sum), and canvases
assemble by a gather.  Across processes every entry point takes a Mesh
whose `group` is a torch.distributed process group; distributed.py is the
runnable wiring and a dry run that spawns real OS processes:

    python -m svgrasterize_tpu_torch.parallel.distributed --processes 2
"""

from .mesh import make_mesh
from .batch import fill_batch, sharded_fill_batch, sharded_render_step
from .distributed import global_mesh, initialize, spawn_local
