"""The port's filter execution against the JAX package's.

Every filter primitive is parsed from the same SVG by both packages'
frontends and applied to one seeded layer (numpy random premultiplied RGBA)
through Filter.__call__ (each primitive's _apply): results must agree within
1e-5 (feImage, which renders through the interpreter, here and in
tests/test_torch_interp.py).  The lighting primitives are held against the
JAX package's with its Sobel kernels negated: it convolves with them where
the SVG 1.1 normal is a cross-correlation, so its normals' in-plane sign is
the spec's reversed, and the port's follows the spec
(test_lighting_normals_follow_the_spec).  The batched blur chunk's plain
version (ops/filter_batch.apply_chunk) is held against the JAX package's
XLA chain and its Pallas chunk kernel in interpret mode within 2e-6, the
bound tests/test_filter_batch.py holds between those two.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgrasterize_tpu import scene_from_str as j_scene_from_str
from svgrasterize_tpu.core.layer import Layer as JLayer
from svgrasterize_tpu.core.transform import Transform as JTransform
from svgrasterize_tpu.ops import blur as j_blur
from svgrasterize_tpu.ops import filter_batch as j_fb

from svgrasterize_tpu_torch import scene_from_str as t_scene_from_str
from svgrasterize_tpu_torch.core.layer import Layer as TLayer
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.ops import blur as t_blur
from svgrasterize_tpu_torch.ops import filter_batch as t_fb
from svgrasterize_tpu_torch.ops import fused_exec

import torch_support  # noqa: F401 (the CPU thread budget)

FILTER_TOL = 1e-5
CHUNK_TOL = 2e-6

_LIGHT = "surfaceScale='3' lighting-color='#ffe0c0'"

# filter id -> (filter element attributes, primitives)
FILTERS = {
    "blur": ("", "<feGaussianBlur stdDeviation='2'/>"),
    "blur_aniso": ("", "<feGaussianBlur stdDeviation='0.8 3'/>"),
    "blur_alpha": ("", "<feGaussianBlur in='SourceAlpha' stdDeviation='1.5'/>"),
    "blur_srgb": (" color-interpolation-filters='sRGB'",
                  "<feGaussianBlur stdDeviation='1.5'/>"),
    "blur_subregion": ("", "<feGaussianBlur stdDeviation='1' x='6' y='4' width='9'"
                           " height='12' result='b'/><feMerge><feMergeNode in='b'/>"
                           "<feMergeNode in='SourceGraphic'/></feMerge>"),
    "offset_merge": ("", "<feGaussianBlur in='SourceAlpha' stdDeviation='1' result='b'/>"
                         "<feOffset in='b' dx='3' dy='-2' result='o'/><feMerge>"
                         "<feMergeNode in='o'/><feMergeNode in='SourceGraphic'/></feMerge>"),
    "drop_shadow": ("", "<feDropShadow dx='2' dy='3' stdDeviation='1.2'"
                        " flood-color='#304050' flood-opacity='0.7'/>"),
    "color_matrix": ("", "<feColorMatrix type='matrix' values='0.5 0.2 0.1 0 0.05"
                         " 0.1 0.7 0.1 0 0 0.2 0.1 0.6 0 0.1 0 0 0 0.9 0'/>"),
    "saturate": ("", "<feColorMatrix type='saturate' values='0.3'/>"),
    "hue_rotate": ("", "<feColorMatrix type='hueRotate' values='70'/>"),
    "luminance_to_alpha": ("", "<feColorMatrix type='luminanceToAlpha'/>"),
    "erode": ("", "<feMorphology operator='erode' radius='1.2 2'/>"),
    "dilate": ("", "<feMorphology operator='dilate' radius='2'/>"),
    "flood_region": ("", "<feFlood flood-color='lime' flood-opacity='0.5' x='2' y='3'"
                         " width='10' height='8' result='fl'/><feComposite in='fl'"
                         " in2='SourceGraphic' operator='over'/>"),
    "tile": ("", "<feOffset dx='0' dy='0' x='8' y='6' width='6' height='5' result='t'/>"
                 "<feTile in='t'/>"),
    "component_transfer": ("", "<feComponentTransfer><feFuncR type='linear' slope='0.5'"
                               " intercept='0.25'/><feFuncG type='table' tableValues='1 0.3"
                               " 0.8'/><feFuncB type='gamma' amplitude='1.2' exponent='2'"
                               " offset='0.05'/><feFuncA type='discrete' tableValues='0.2"
                               " 0.6 0.9'/></feComponentTransfer>"),
    "turbulence": ("", "<feTurbulence baseFrequency='0.09' numOctaves='2' seed='5'/>"),
    "fractal_noise": ("", "<feTurbulence type='fractalNoise' baseFrequency='0.05 0.12'"
                          " numOctaves='3' seed='2'/>"),
    "convolve": ("", "<feConvolveMatrix order='3' kernelMatrix='1 2 0 -1 4 1 0 1 -2'"
                     " bias='0.05'/>"),
    "convolve_preserve_alpha": ("", "<feConvolveMatrix order='3 2' kernelMatrix="
                                    "'0 1 0 1 2 1' divisor='5' preserveAlpha='true'/>"),
    "displacement": ("", "<feFlood flood-color='rgb(255,96,200)' result='map'/>"
                         "<feDisplacementMap in='SourceGraphic' in2='map' scale='6'"
                         " xChannelSelector='R' yChannelSelector='G'/>"),
    "diffuse_distant": ("", f"<feDiffuseLighting {_LIGHT} diffuseConstant='0.9'>"
                            "<feDistantLight azimuth='30' elevation='40'/></feDiffuseLighting>"),
    "diffuse_point": ("", f"<feDiffuseLighting {_LIGHT} diffuseConstant='1'>"
                          "<fePointLight x='10' y='8' z='15'/></feDiffuseLighting>"),
    "specular_spot": ("", f"<feSpecularLighting {_LIGHT} specularConstant='1.1'"
                          " specularExponent='6'><feSpotLight x='4' y='4' z='20'"
                          " pointsAtX='12' pointsAtY='10' pointsAtZ='0'"
                          " specularExponent='2' limitingConeAngle='40'/>"
                          "</feSpecularLighting>"),
    "specular_point": ("", f"<feSpecularLighting {_LIGHT} specularConstant='0.8'"
                           " specularExponent='12'><fePointLight x='14' y='10' z='12'/>"
                           "</feSpecularLighting>"),
}
for _mode in ("multiply", "screen", "darken", "lighten", "normal"):
    FILTERS[f"blend_{_mode}"] = (
        "", "<feFlood flood-color='#3080c0' flood-opacity='0.7' result='fl'/>"
            f"<feBlend in='SourceGraphic' in2='fl' mode='{_mode}'/>")
for _op in ("over", "in", "out", "atop", "xor"):
    FILTERS[f"composite_{_op}"] = (
        "", "<feOffset dx='4' dy='3' result='o'/>"
            f"<feComposite in='SourceGraphic' in2='o' operator='{_op}'/>")
FILTERS["composite_arithmetic"] = (
    "", "<feGaussianBlur stdDeviation='1' result='b'/><feComposite in='SourceGraphic'"
        " in2='b' operator='arithmetic' k1='0.3' k2='0.6' k3='0.5' k4='-0.05'/>")


def _filters(name):
    attrs, prims = FILTERS[name]
    doc = (
        "<svg xmlns='http://www.w3.org/2000/svg' width='32' height='32'><defs>"
        f"<filter id='f'{attrs}>{prims}</filter></defs>"
        "<rect width='10' height='10' fill='red' filter='url(#f)'/></svg>"
    )
    return j_scene_from_str(doc)[1]["f"], t_scene_from_str(doc)[1]["f"]


def _layer_image(seed: int, h: int = 24, w: int = 28) -> np.ndarray:
    """Seeded premultiplied RGBA with transparent, partial and opaque
    pixels."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 1, (h, w, 1))
    alpha[rng.random((h, w, 1)) < 0.15] = 0.0
    alpha[rng.random((h, w, 1)) < 0.15] = 1.0
    rgb = rng.uniform(0, 1, (h, w, 3)) * alpha
    return np.concatenate([rgb, alpha], -1).astype(np.float32)


def _transforms(rotated: bool):
    jt = JTransform().matrix(0, 1, 0, 1, 0, 0).scale(1.25)
    tt = TTransform().matrix(0, 1, 0, 1, 0, 0).scale(1.25)
    if rotated:
        jt, tt = jt.rotate(0.5), tt.rotate(0.5)
    return jt, tt


def _run_both(name, rotated=False, offset=(5, 7), seed=0):
    jf, tf = _filters(name)
    jt, tt = _transforms(rotated)
    img = _layer_image(seed)
    ref = jf(jt, JLayer(jnp.asarray(img), offset, pre_alpha=True, linear_rgb=False))
    got = tf(tt, TLayer(torch.from_numpy(img), offset, pre_alpha=True, linear_rgb=False))
    return ref, got


def _assert_layers_close(ref, got):
    assert got.offset == ref.offset
    assert (got.pre_alpha, got.linear_rgb) == (ref.pre_alpha, ref.linear_rgb)
    a, b = np.asarray(ref.image), got.image.numpy()
    assert a.shape == b.shape and np.isfinite(b).all()
    assert np.abs(a - b).max() <= FILTER_TOL


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_primitive_matches_jax(name, monkeypatch):
    if "diffuse" in name or "specular" in name:
        import svgrasterize_tpu.filter as j_filter

        monkeypatch.setattr(j_filter, "_SOBEL", -j_filter._SOBEL)
    ref, got = _run_both(name)
    _assert_layers_close(ref, got)
    assert float(np.abs(np.asarray(ref.image)).max()) > 0.0


@pytest.mark.parametrize("kind", ["diffuse", "specular"])
def test_lighting_normals_follow_the_spec(kind):
    """On an alpha ramp rising to the right the SVG 1.1 normal,
    N = (-surfaceScale dA/dx, -surfaceScale dA/dy, 1), leans left: a light
    far to the left lights the ramp more than one as far to the right, and
    an interior pixel's diffuse light is the spec's N.L to 1e-6."""
    prim = ("<feDiffuseLighting surfaceScale='2' diffuseConstant='1'>" if kind == "diffuse"
            else "<feSpecularLighting surfaceScale='2' specularConstant='1'"
                 " specularExponent='1'>")
    end = prim.split(" ")[0].replace("<", "</") + ">"
    values = []
    for x in (-1000, 1000):
        doc = ("<svg xmlns='http://www.w3.org/2000/svg' width='32' height='32'><defs>"
               f"<filter id='f'>{prim}<fePointLight x='{x}' y='8' z='1000'/>{end}</filter>"
               "</defs><rect width='10' height='10' filter='url(#f)'/></svg>")
        flt = t_scene_from_str(doc)[1]["f"]
        ramp = torch.linspace(0.0, 1.0, 16).expand(16, 16)
        image = torch.stack([ramp * 0.5, ramp * 0.5, ramp * 0.5, ramp], -1).contiguous()
        out = flt(TTransform().matrix(0, 1, 0, 1, 0, 0),
                  TLayer(image, (0, 0), pre_alpha=True, linear_rgb=True))
        values.append(float(out.image[8, 8, 0]))
    assert values[0] > values[1] > 0.0
    if kind == "diffuse":
        # dA/dx = 1 / 15 a column, so the Sobel sum is 2 / 15 and
        # N = (-4 / 15, 0, 1); L from the pixel centre (8.5, 8.5) at height 2 A
        n = np.array([-4.0 / 15.0, 0.0, 1.0])
        light = np.array([-1000.0 - 8.5, 8.0 - 8.5, 1000.0 - 2.0 * 8.0 / 15.0])
        expect = n @ light / np.linalg.norm(n) / np.linalg.norm(light)
        assert abs(values[0] - expect) <= 1e-6


@pytest.mark.parametrize("name", ["blur", "blur_aniso", "drop_shadow"])
def test_rotated_blur_matches_jax(name):
    """Under a rotation the gaussian kernel is not separable: the full 2D
    depthwise convolution runs (cuDNN TF32 off on a card)."""
    ref, got = _run_both(name, rotated=True, seed=1)
    _assert_layers_close(ref, got)


def test_blur_ops_match_jax():
    rng = np.random.default_rng(4)
    img = rng.random((13, 17, 4), dtype=np.float32)
    u = rng.random(5).astype(np.float32)
    v = rng.random(7).astype(np.float32)
    k = rng.random((5, 4)).astype(np.float32)
    ref = np.asarray(j_blur.convolve_separable(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    got = t_blur.convolve_separable(torch.from_numpy(img), torch.from_numpy(u),
                                    torch.from_numpy(v)).numpy()
    assert got.shape == ref.shape == (17, 23, 4)
    assert np.abs(got - ref).max() <= FILTER_TOL
    ref = np.asarray(j_blur.convolve_full(jnp.asarray(img), jnp.asarray(k)))
    got = t_blur.convolve_full(torch.from_numpy(img), torch.from_numpy(k)).numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= FILTER_TOL
    jt, tt = _transforms(rotated=True)
    np.testing.assert_array_equal(j_blur.gaussian_kernel(jt, (2.0, 1.0)),
                                  t_blur.gaussian_kernel(tt, (2.0, 1.0)))


def test_fe_image_raises_naming_the_interpreter():
    """feImage of a fragment renders it through the interpreter; the filter
    matches the JAX package's.  (The name is the one this test had while
    feImage raised.)"""
    doc = (
        "<svg xmlns='http://www.w3.org/2000/svg' width='32' height='32'><defs>"
        "<g id='frag'><circle cx='8' cy='8' r='6' fill='lime'/></g>"
        "<filter id='f'><feImage href='#frag'/></filter></defs>"
        "<rect width='10' height='10' fill='red' filter='url(#f)'/></svg>"
    )
    image = _layer_image(0)
    ref = j_scene_from_str(doc)[1]["f"](
        JTransform(), JLayer(jnp.asarray(image), (0, 0), True, False))
    got = t_scene_from_str(doc)[1]["f"](
        TTransform(), TLayer(torch.from_numpy(image), (0, 0), True, False))
    _assert_layers_close(ref, got)
    assert float(np.asarray(ref.image)[..., 3].max()) > 0.0


def _random_chunk(rng, t, nsi, nsj, noi, noj, B, chain_linear):
    n_rows = 12
    canvas = rng.random((n_rows, t, t, 4), dtype=np.float32)
    canvas[..., :3] *= canvas[..., 3:]  # premultiplied
    u = rng.random(5)
    u /= u.sum()
    v = rng.random(3)
    v /= v.sum()
    ck = {
        "B": B, "NSi": nsi, "NSj": nsj, "NOi": noi, "NOj": noj,
        "chain_linear": chain_linear,
        "lut": rng.integers(-1, n_rows, (B, nsi * nsj)).astype(np.int32),
        "bh": np.stack([j_fb._band(u, nsi * t - 3, 1, -2, noi * t, nsi * t)
                        for _ in range(B)]).astype(np.float32),
        "bw": np.stack([j_fb._band(v, nsj * t - 5, 2, 1, noj * t, nsj * t)
                        for _ in range(B)]).astype(np.float32),
        "src_alpha": np.arange(B) % 2 == 0,
        "out_idx": np.asarray(rng.permutation(B * noi * noj)[: B * noi * noj // 2 + 1],
                              np.int32),
        "pool_idx": [],
    }
    ck["pool_idx"] = list(range(len(ck["out_idx"])))
    return canvas, ck


CHUNK_SHAPES = [(1, 1, 1, 1, 2), (2, 3, 3, 2, 3)]


@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=["1x1", "2x3"])
@pytest.mark.parametrize("gamma", [False, True], ids=["nogamma", "gamma"])
def test_apply_chunk_matches_jax(shape, gamma, monkeypatch):
    """Plain apply_chunk (and the blur_chunk wrapper on CPU tensors)
    against the JAX XLA chain on interleaved rows and the JAX Pallas chunk
    kernel (interpret mode) on planar rows."""
    rng = np.random.default_rng(11 + gamma)
    t = 32
    canvas, ck = _random_chunk(rng, t, *shape, chain_linear=gamma)
    got_all = t_fb.apply_chunk(torch.from_numpy(canvas), ck, t, False)
    nsi, nsj, noi, noj, B = shape
    assert got_all.shape == (B * noi * noj, t, t, 4)
    level = t_fb.pack_level([ck], t, "cpu")  # a level of one chunk
    wrapped = fused_exec.blur_chunk(torch.from_numpy(canvas), level, t, False)
    assert torch.equal(wrapped, got_all)
    got = got_all.numpy()[ck["out_idx"]]

    monkeypatch.setenv("SVGR_BLUR_PALLAS", "0")
    xla = np.asarray(j_fb.apply_chunk(jnp.asarray(canvas), ck, t, False))
    assert np.abs(got - xla).max() <= CHUNK_TOL

    def planar(a):
        return a.transpose(0, 1, 3, 2).reshape(a.shape[0], t, 4 * t)

    monkeypatch.setenv("SVGR_BLUR_PALLAS", "interp")
    pallas = np.asarray(j_fb.apply_chunk(jnp.asarray(planar(canvas)), ck, t, False,
                                         planar=True))
    assert np.abs(planar(got) - pallas).max() <= CHUNK_TOL
    assert os.environ["SVGR_BLUR_PALLAS"] == "interp"
