"""Port lowering (svgrasterize_tpu_torch.render_plan.lower_scene) against the
JAX package's lower_scene: every array of the plan must be bit-identical at
the same explicit tile size.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_support import FLAT_DOCS, jax_lower, torch_lower


@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(FLAT_DOCS))
def test_lowering_bit_identical(name, tile):
    ref = jax_lower(FLAT_DOCS[name], tile)
    got = torch_lower(FLAT_DOCS[name], tile)
    assert ref is not None and got is not None
    assert ref.groups == [] and got.groups == []
    assert got.tile == ref.tile == tile
    assert tuple(got.grid) == tuple(ref.grid)
    ref_keys = {k for k in ref.items if not k.startswith("_")}
    assert set(got.items) == ref_keys
    for key in sorted(ref_keys):
        a, b = np.asarray(ref.items[key]), got.items[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    assert len(got.bigs) == len(ref.bigs)
    for a, b in zip(ref.bigs, got.bigs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.clips.dtype == ref.clips.dtype
    assert np.array_equal(got.clips, ref.clips)
    assert np.array_equal(got.hull.raw_points, ref.hull.raw_points)
    assert got.patterns is None and ref.patterns is None
