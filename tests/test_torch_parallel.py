"""The port's parallel package against the JAX package's.

Mirrors tests/test_parallel.py, test_parallel_scene.py and test_atlas.py
on the CPU: the port's meshes are lists of torch.device (the same device
once per shard), the JAX package's its virtual 8-device CPU mesh.  The
partition's host arrays must be the JAX package's bit for bit (dtype
included); sharded renders agree with the JAX package's single-device run
within 1e-5 and with the port's unsharded run within 1e-6; fills and
atlases within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgrasterize_tpu.render_plan as jrp
from svgrasterize_tpu.core.transform import Transform as JTransform
from svgrasterize_tpu.frontend.svg import scene_from_str as j_scene_from_str
from svgrasterize_tpu.parallel import atlas as j_atlas
from svgrasterize_tpu.parallel import batch as j_batch
from svgrasterize_tpu.parallel import scene as j_pscene
from svgrasterize_tpu.parallel.mesh import make_mesh as j_make_mesh

import svgrasterize_tpu_torch.render_plan as trp
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.frontend.svg import scene_from_str as t_scene_from_str
from svgrasterize_tpu_torch.parallel import atlas as t_atlas
from svgrasterize_tpu_torch.parallel import batch as t_batch
from svgrasterize_tpu_torch.parallel import scene as t_pscene
from svgrasterize_tpu_torch.parallel.mesh import Mesh, make_mesh
from svgrasterize_tpu_torch.utils.stress import edge_batch

from test_parallel_scene import CLUSTERED_DOC, DOC, MULTIPASS_DOC, POOL_HEAVY_DOC

EXEC_TOL = 1e-5  # the bound the executors hold against the JAX package
SHARD_TOL = 1e-6  # sharded against unsharded: the same kernels on the same items
CPU = torch.device("cpu")
DOCS = {"doc": DOC, "multipass": MULTIPASS_DOC, "clustered": CLUSTERED_DOC}


def _viewport(doc):
    _scene, _ids, (w, h) = t_scene_from_str(doc)
    return (0, 0, int(h), int(w))


def _jax_lower(doc, tile=32):
    return jrp.lower_scene(j_scene_from_str(doc)[0], JTransform().matrix(0, 1, 0, 1, 0, 0),
                           _viewport(doc), False, tile=tile)


def _torch_lower(doc, tile=32):
    return trp.lower_scene(t_scene_from_str(doc)[0], TTransform().matrix(0, 1, 0, 1, 0, 0),
                           _viewport(doc), False, tile, device="cpu")


def _shards(n):
    return Mesh([CPU] * n, ("data",))


@pytest.fixture(scope="module")
def lowered():
    return {name: _jax_lower(doc) for name, doc in DOCS.items()}


def test_mesh_factoring():
    mesh = make_mesh([CPU] * 8)
    assert mesh.devices.size == 8 and mesh.devices.shape == j_make_mesh(
        jax.devices()[:8]).devices.shape
    assert mesh.axis_names == ("data", "seg")
    assert make_mesh([CPU]).devices.shape == (1, 1)
    assert make_mesh([CPU] * 6).devices.shape in ((3, 2), (2, 3))
    assert list(mesh.local_shards) == list(range(8)) and mesh.home == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_partition_bit_identical(lowered, name, n):
    low = lowered[name]
    num_tiles = low.grid[0] * low.grid[1]
    valid = low.items["tile_id"][low.items["tile_id"] < num_tiles]
    tpd = -(-num_tiles // n)
    ref = j_pscene._assign_tiles(valid, num_tiles, n, tpd)
    got = t_pscene._assign_tiles(valid, num_tiles, n, tpd)
    assert got[2] == ref[2]
    _assert_same(got[0], ref[0], "dev_of_tile")
    _assert_same(got[1], ref[1], "slot_of_tile")
    clips = low.clips if low.clips.shape[0] else None
    ref = j_pscene.partition_plan(low.items, low.bigs, num_tiles, n, patterns=low.patterns,
                                  clips=clips)
    got = t_pscene.partition_plan(low.items, low.bigs, num_tiles, n, patterns=low.patterns,
                                  clips=clips)
    assert got[2] == ref[2]
    _assert_same(got[1], ref[1], "stacked_big")
    assert sorted(got[0]) == sorted(ref[0])
    for key in sorted(ref[0]):
        _assert_same(got[0][key], ref[0][key], key)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_shard_balance_counts(lowered, name):
    low = lowered[name]
    st, _big, tpd = t_pscene.partition_plan(low.items, low.bigs, low.grid[0] * low.grid[1], 8)
    ref = j_pscene.shard_balance(st, tpd)
    got = t_pscene.shard_balance(st, tpd)
    _assert_same(got["counts"], ref["counts"], "counts")
    if (got["counts"] > 0).all():
        assert got["skew"] == ref["skew"]
    if name == "clustered":
        assert got["skew"] < 2.0


IDLE_DOC = """<svg xmlns="http://www.w3.org/2000/svg" width="256" height="64">
<circle cx="16" cy="16" r="10" fill="#c04020"/>
<rect x="36" y="36" width="20" height="20" fill="#2040c0"/></svg>"""


def test_shard_balance_skips_idle_devices():
    """A plan that leaves shards idle: the skew averages over the shards
    with work.  The JAX package averages over every shard: on this plan
    (items on 2 of 4 shards) it reports twice the port's skew."""
    low = _jax_lower(IDLE_DOC)
    num_tiles = low.grid[0] * low.grid[1]
    st, _big, tpd = t_pscene.partition_plan(low.items, low.bigs, num_tiles, 4)
    got = t_pscene.shard_balance(st, tpd)
    ref = j_pscene.shard_balance(st, tpd)
    counts = got["counts"]
    assert (counts == 0).sum() == 2 and (counts > 0).sum() == 2
    assert got["skew"] == pytest.approx(counts.max() / counts[counts > 0].mean())
    assert ref["skew"] == pytest.approx(2 * got["skew"])


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", ["doc", "multipass", "pool_heavy"])
def test_sharded_plan_matches(name, n, monkeypatch):
    """Sharded renders (isolation passes, masks, patterns and a blur in the
    multi-pass document; 16 opacity passes in pool_heavy) against the JAX
    package's single-device run and the port's unsharded one."""
    monkeypatch.setenv("SVGR_FUSED", "0")
    doc = {"doc": DOC, "multipass": MULTIPASS_DOC, "pool_heavy": POOL_HEAVY_DOC}[name]
    ref = np.asarray(jrp.execute_lowered(_jax_lower(doc), (0, 0), False))
    low = _torch_lower(doc)
    if name != "doc":
        assert low.groups
    plain = trp.execute_lowered(low, "cpu").numpy()
    program = trp.upload_program(low, "cpu", _shards(n))
    assert program.main.n_shards == n
    got = trp.run_program(program).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= EXEC_TOL
    assert np.abs(got - plain).max() <= SHARD_TOL


def test_sharded_compiled_scene_matches():
    mesh = make_mesh([CPU] * 4)
    scene = t_scene_from_str(MULTIPASS_DOC)[0]
    tr, vp = TTransform().matrix(0, 1, 0, 1, 0, 0), _viewport(MULTIPASS_DOC)
    sharded = trp.compile_scene(scene, tr, vp, False, mesh, device="cpu")
    single = trp.compile_scene(scene, tr, vp, False, device="cpu")
    a, b = sharded.render_tiles(), sharded.render_tiles()
    assert torch.equal(a, b)
    assert float((a - single.render_tiles()).abs().max()) <= SHARD_TOL


@pytest.fixture(scope="module")
def fill_inputs():
    lines, colors = edge_batch(n_paths=8, n_segs=64, extent=32.0, seed=7)
    return lines, colors


def test_fill_batch_matches_jax(fill_inputs):
    lines, colors = fill_inputs
    ref = np.asarray(j_batch.fill_batch(jnp.asarray(lines), jnp.asarray(colors), 32, 32))
    got = t_batch.fill_batch(lines, colors, 32, 32, device="cpu").numpy()
    assert got.shape == ref.shape == (8, 32, 32, 4)
    assert np.abs(got - ref).max() <= EXEC_TOL
    ref_eo = np.asarray(j_batch.fill_batch(jnp.asarray(lines), jnp.asarray(colors), 32, 32,
                                           "evenodd"))
    got_eo = t_batch.fill_batch(lines, colors, 32, 32, "evenodd", device="cpu").numpy()
    assert np.abs(got_eo - ref_eo).max() <= EXEC_TOL


def test_sharded_fill_batch_matches_jax(fill_inputs):
    lines, colors = fill_inputs
    j_mesh = j_make_mesh(jax.devices()[:8])
    ref = np.asarray(j_batch.sharded_fill_batch(j_mesh, jnp.asarray(lines), jnp.asarray(colors),
                                                32, 32))
    mesh = make_mesh([CPU] * 8)
    got = t_batch.sharded_fill_batch(mesh, torch.from_numpy(lines), colors, 32, 32).numpy()
    assert np.abs(got - ref).max() <= EXEC_TOL
    single = t_batch.fill_batch(lines, colors, 32, 32, device="cpu").numpy()
    assert np.abs(got - single).max() <= EXEC_TOL


def test_sharded_render_step_matches_jax(fill_inputs):
    lines, colors = fill_inputs
    j_mesh = j_make_mesh(jax.devices()[:8])
    ref = np.asarray(j_batch.sharded_render_step(j_mesh, jnp.asarray(lines),
                                                 jnp.asarray(colors), 32, 32))
    got = t_batch.sharded_render_step(make_mesh([CPU] * 8), lines, colors, 32, 32).numpy()
    assert got.shape == ref.shape == (32, 32, 4)
    assert np.abs(got - ref).max() <= EXEC_TOL


def _icon(i: int) -> str:
    color = ("#c03020", "#2060c0", "#20a040", "#a020c0")[i % 4]
    return (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='48' height='40'>"
        f"<defs><linearGradient id='g'><stop offset='0' stop-color='{color}'/>"
        f"<stop offset='1' stop-color='#222222'/></linearGradient></defs>"
        f"<circle cx='24' cy='20' r='{12 + i * 2}' fill='url(#g)'/>"
        f"<rect x='4' y='4' width='12' height='12' fill='{color}' opacity='0.6'/></svg>"
    )


def _docs(scene_from_str, n):
    out = []
    for i in range(n):
        scene, _ids, size = scene_from_str(_icon(i))
        out.append((scene, (float(size[0]), float(size[1]))))
    return out


def test_layout_grid_and_atlas_scene():
    for args in ((4, 64), (5, 64, 5, 8), (13, 192), (52, 192, 8, 0), (0, 32)):
        assert t_atlas.layout_grid(*args) == j_atlas.layout_grid(*args)
    for cols, margin in ((None, 0), (3, 8)):
        ref, ref_size = j_atlas.atlas_scene(_docs(j_scene_from_str, 5), 64, cols, margin)
        got, got_size = t_atlas.atlas_scene(_docs(t_scene_from_str, 5), 64, cols, margin)
        assert got_size == ref_size and repr(got) == repr(ref)
    assert t_atlas.atlas_scene([(None, None)], 32) == (None, (32, 32))


@pytest.mark.parametrize("sharded", [False, True])
def test_render_atlas_matches_jax(sharded, monkeypatch):
    monkeypatch.setenv("SVGR_TILE", "32")
    monkeypatch.setenv("SVGR_FUSED", "0")
    ref = np.asarray(j_atlas.render_atlas(_docs(j_scene_from_str, 4), cell=64).image)
    mesh = make_mesh([CPU] * 4) if sharded else None
    got = t_atlas.render_atlas(_docs(t_scene_from_str, 4), cell=64, mesh=mesh,
                               device="cpu").image.numpy()
    assert got.shape == ref.shape == (128, 128, 4)
    assert np.abs(got - ref).max() <= EXEC_TOL
    for r in (0, 64):
        for c in (0, 64):
            assert got[r:r + 64, c:c + 64, 3].max() > 0.5


def test_compile_atlas_dedups_repeated_docs():
    """12 documents, 3 unique: each unique one renders once, duplicates are
    a tile-row gather; equal to the plain combined plan within 1e-5."""
    docs = _docs(t_scene_from_str, 3) * 4
    srv = t_atlas.compile_atlas(docs, cell=64, device="cpu")
    assert srv is not None and srv.n_unique == 3 and srv.n_docs == 12
    combined, (aw, ah) = t_atlas.atlas_scene(docs, cell=64)
    plain = trp.compile_scene(combined, TTransform().matrix(0, 1, 0, 1, 0, 0),
                              (0, 0, ah, aw), False, device="cpu")
    ref = plain.render().image.numpy()
    got = srv.render().image.numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= EXEC_TOL
    many = srv.render_tiles_many(2)
    assert torch.equal(many, srv.render_tiles())


def test_compile_atlas_unique_docs_falls_back_to_plain():
    docs = _docs(t_scene_from_str, 2)
    srv = t_atlas.compile_atlas(docs, cell=64, device="cpu")
    assert srv is not None and srv.n_unique == srv.n_docs == 2
    out = srv.render().image.numpy()
    assert out.shape == (128, 64, 4) and np.isfinite(out).all() and out[..., 3].max() > 0.5
