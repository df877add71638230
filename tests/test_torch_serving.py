"""The port's serving slice against itself and the JAX package.

CompiledScene.render_tiles_many / render_many (on a CUDA device replays of
one frame captured in a CUDA graph; on the CPU, run here, k eager frames)
must equal render_tiles / render bit for bit (compared as int32 views, so
-0.0 and +0.0 differ), also on a plan whose zero float parameters were
set to -0.0, and agree with the JAX package's render_tiles_many within
1e-5.  `tile` and `hull` equal the JAX package's.  The repairs: the JAX
argument lists of compile_scene and render_fast work on the port, its
top-level names include the JAX package's, and the coverage floor sits
where the JAX package's XLA executor puts it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import svgrasterize_tpu
import svgrasterize_tpu.render_plan as jrp
from svgrasterize_tpu.core.transform import Transform as JTransform
from svgrasterize_tpu.frontend.svg import scene_from_str as j_scene_from_str
from svgrasterize_tpu.ops.fused_exec import from_planar

import svgrasterize_tpu_torch
import svgrasterize_tpu_torch.render_plan as trp
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.frontend.svg import scene_from_str as t_scene_from_str
from svgrasterize_tpu_torch.parallel.mesh import make_mesh

from test_render_many import MULTIPASS_DOC, PLAIN_DOC
import torch_support  # noqa: F401 (the CPU thread budget)

EXEC_TOL = 1e-5  # the bound the executors hold against the JAX package
DOCS = {"plain": PLAIN_DOC, "multipass": MULTIPASS_DOC}


def _viewport(doc):
    _scene, _ids, (w, h) = t_scene_from_str(doc)
    return (0, 0, int(h), int(w))


def _compiled(doc, **kw):
    scene, _ids, _size = t_scene_from_str(doc)
    cs = trp.compile_scene(scene, TTransform().matrix(0, 1, 0, 1, 0, 0), _viewport(doc),
                           False, tile=32, device="cpu", **kw)
    assert cs is not None
    return cs


def _bits(t) -> np.ndarray:
    return np.ascontiguousarray(t.numpy() if isinstance(t, torch.Tensor) else t).view(np.int32)


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_render_tiles_many_is_render_tiles(name, k):
    cs = _compiled(DOCS[name])
    np.testing.assert_array_equal(_bits(cs.render_tiles_many(k)), _bits(cs.render_tiles()))


@pytest.mark.parametrize("name", sorted(DOCS))
def test_render_many_is_render(name):
    cs = _compiled(DOCS[name])
    a, b = cs.render(), cs.render_many(2)
    assert a.offset == b.offset and a.pre_alpha == b.pre_alpha
    np.testing.assert_array_equal(_bits(b.image.contiguous()), _bits(a.image.contiguous()))


def _negate_zeros(items: dict) -> None:
    for key, value in items.items():
        if not key.startswith("_") and np.issubdtype(value.dtype, np.floating):
            items[key] = np.where(value == 0, np.float32(-0.0), value).astype(value.dtype)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_negative_zero_params_survive_replay(name):
    """The JAX package's render_many perturbs its operands by +0.0 to chain
    frames, which turns -0.0 into +0.0; the port replays frames without
    touching them."""
    scene, _ids, _size = t_scene_from_str(DOCS[name])
    vp = _viewport(DOCS[name])
    lowered = trp.lower_scene(scene, TTransform().matrix(0, 1, 0, 1, 0, 0), vp, False, 32,
                              device="cpu")
    _negate_zeros(lowered.items)
    for g in lowered.groups:
        _negate_zeros(g["items"])
    assert any(np.signbit(v[v == 0]).any() for k, v in lowered.items.items()
               if not k.startswith("_") and np.issubdtype(v.dtype, np.floating))
    cs = trp.CompiledScene(lowered, vp, False, device="cpu")
    one = cs.render_tiles()
    np.testing.assert_array_equal(_bits(cs.render_tiles_many(3)), _bits(one))
    np.testing.assert_array_equal(_bits(cs.render_tiles()), _bits(one))


@pytest.mark.parametrize("name", sorted(DOCS))
def test_render_tiles_many_matches_jax(name, monkeypatch):
    monkeypatch.setenv("SVGR_TILE", "32")
    monkeypatch.setenv("SVGR_FUSED", "0")
    scene, _ids, _size = j_scene_from_str(DOCS[name])
    jcs = jrp.compile_scene(scene, JTransform().matrix(0, 1, 0, 1, 0, 0), _viewport(DOCS[name]),
                            False)
    ref = np.asarray(from_planar(jcs.render_tiles_many(2)))
    cs = _compiled(DOCS[name])
    got = cs.render_tiles_many(2).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= EXEC_TOL
    assert cs.tile == jcs.tile == 32
    np.testing.assert_array_equal(cs.hull.raw_points, jcs.hull.raw_points)
    np.testing.assert_array_equal(cs.hull.points, jcs.hull.points)


def test_render_tiles_many_refuses_a_mesh():
    cs = _compiled(PLAIN_DOC, mesh=make_mesh([torch.device("cpu")] * 2))
    with pytest.raises(ValueError, match="single-device plans only"):
        cs.render_tiles_many(2)
    cs.render_tiles()  # the sharded plan itself renders


@pytest.mark.parametrize("name", sorted(DOCS))
def test_jax_argument_lists(name, monkeypatch):
    """compile_scene(scene, transform, viewport) and render_fast(scene,
    transform, viewport), as a caller of the JAX package writes them, work
    on both packages (the port on the CPU by its device keyword)."""
    monkeypatch.setenv("SVGR_TILE", "32")
    monkeypatch.setenv("SVGR_FUSED", "0")
    doc = DOCS[name]
    vp = _viewport(doc)
    j_scene = j_scene_from_str(doc)[0]
    t_scene = t_scene_from_str(doc)[0]
    jtr, ttr = JTransform().matrix(0, 1, 0, 1, 0, 0), TTransform().matrix(0, 1, 0, 1, 0, 0)
    ref = np.asarray(jrp.compile_scene(j_scene, jtr, vp).render().image)
    got = trp.compile_scene(t_scene, ttr, vp, device="cpu").render().image.numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= EXEC_TOL
    ref = np.asarray(jrp.render_fast(j_scene, jtr, vp)[0].image)
    got = trp.render_fast(t_scene, ttr, vp, device="cpu")[0].image.numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= EXEC_TOL


def test_top_level_names_cover_jax():
    """Every public name of the JAX package's top level is the port's too,
    except default_cache_dir, which belongs to the JAX compile cache."""
    public = {n for n in dir(svgrasterize_tpu) if not n.startswith("_")}
    missing = sorted(n for n in public - {"default_cache_dir"}
                     if not hasattr(svgrasterize_tpu_torch, n))
    assert missing == []
    assert svgrasterize_tpu_torch.__version__ == svgrasterize_tpu.__version__ == "0.1.0"
    canvas, tr = svgrasterize_tpu_torch.canvas_create(5, 3, device="cpu")
    assert tuple(canvas.shape) == (3, 5, 4) and tr.m.tolist() == TTransform().matrix(
        0, 1, 0, 1, 0, 0).m.tolist()


# a rect whose left column is covered 1e-5 (>= the 1e-6 floor) at opacity
# 0.05: coverage x opacity is 4.8e-7, below the floor
THRESHOLD_DOC = """<svg xmlns="http://www.w3.org/2000/svg" width="64" height="32">
<rect x="8.99999" y="4" width="40" height="20" fill="#3060c0" opacity="0.05"/></svg>"""


def test_threshold_order_follows_xla_executor(monkeypatch):
    """The coverage floor (< 1e-6 -> 0) applies before the opacity multiply,
    as in the JAX package's XLA executor (SVGR_FUSED=0): the port's plain
    executor equals it exactly on an item whose coverage x opacity
    straddles the floor.  The JAX package's Pallas kernel (interpret mode)
    floors after the multiply and zeroes those pixels: on this document it
    differs from both in 80 values, by at most 4.7683716e-07."""
    vp = _viewport(THRESHOLD_DOC)
    jtr = JTransform().matrix(0, 1, 0, 1, 0, 0)
    ref = {}
    for mode in ("0", "interp"):
        monkeypatch.setenv("SVGR_FUSED", mode)
        low = jrp.lower_scene(j_scene_from_str(THRESHOLD_DOC)[0], jtr, vp, False, tile=32)
        ref[mode] = np.asarray(jrp.execute_lowered(low, (0, 0), False))
    low = trp.lower_scene(t_scene_from_str(THRESHOLD_DOC)[0], TTransform().matrix(
        0, 1, 0, 1, 0, 0), vp, False, 32, device="cpu")
    got = trp.execute_lowered(low, "cpu").numpy()
    np.testing.assert_array_equal(got, ref["0"])
    straddling = (got[..., 3] > 0) & (got[..., 3] < 1e-6)
    assert straddling.any()
    diff = np.abs(got - ref["interp"])
    assert int((diff > 0).sum()) == 80 and float(diff.max()) == pytest.approx(4.7683716e-07)
