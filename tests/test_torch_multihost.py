"""The port's multi-process path: real torch.distributed processes (gloo)
on the CPU.

spawn_local launches separate OS processes that join one process group
over a TCP rendezvous on localhost; each renders the shards it owns of the
sharded plan and all_gathers the canvas (parallel/distributed.py).  Mirrors
tests/test_multihost.py.
"""

import re

import pytest

from svgrasterize_tpu_torch.core.transform import Transform
from svgrasterize_tpu_torch.frontend.svg import scene_from_str
from svgrasterize_tpu_torch.parallel.distributed import DRYRUN_DOC, spawn_local
from svgrasterize_tpu_torch.render_plan import execute_lowered, lower_scene


def test_distributed_two_processes():
    line = spawn_local(num_processes=2, devices_per_process=2, timeout=300)
    match = re.search(r"processes=(\d+) devices=(\d+) grid=(\d+)x(\d+) checksum=([\d.]+)$",
                      line)
    assert match, line
    assert int(match.group(1)) == 2
    assert int(match.group(2)) == 4
    scene, _ids, _size = scene_from_str(DRYRUN_DOC)
    lowered = lower_scene(scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, 192, 256),
                          False, 32, device="cpu")
    assert (int(match.group(3)), int(match.group(4))) == tuple(lowered.grid)
    single = float(execute_lowered(lowered, "cpu").sum())
    assert float(match.group(5)) == pytest.approx(single, rel=1e-4)


@pytest.mark.slow
def test_distributed_four_processes():
    """4 processes x 2 shards: the multi-pass pool and pattern-atlas
    sub-stacks and a sharded sprite-atlas batch."""
    line = spawn_local(num_processes=4, devices_per_process=2, timeout=560, full=True)
    match = re.search(
        r"processes=(\d+) devices=(\d+).*checksum=([\d.]+) "
        r"multipass=([\d.]+) atlas=([\d.]+)", line
    )
    assert match, line
    assert int(match.group(1)) == 4
    assert int(match.group(2)) == 8
    assert float(match.group(4)) > 0 and float(match.group(5)) > 0
