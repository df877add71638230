"""A filter part's entry and exit (ops/part_io.py, the plain versions of the
part kernels in csrc/part_io.cu) against independent constructions.

Entry: the part's rows placed tile by tile into a zero span image by slice
assignment, the crop taken from the source bbox, then Layer.convert and the
SourceAlpha mask.  Exit: Layer.convert of the chain's result, merge_at onto
a zero out span, and the out tiles cut out by slicing.  Random parts
(chip_smoke.random_part) have empty span slots, source bboxes past every
span edge and results past every side of the out span.  The slot map
upload_program builds for the kernel inverts each part's tile list.  The
wrappers in ops/fused_exec.py are run against a numpy model of the
kernels, so what they hand the kernel (crop bounds, offsets, strides,
colorspace steps) is held to the plain versions here; the kernels
themselves run only on a CUDA card, where chip_smoke.py holds them to the
plain versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
import svgrasterize_tpu_torch.render_plan as trp
from svgrasterize_tpu_torch.core.layer import Layer, merge_at
from svgrasterize_tpu_torch.filter import Filter
from svgrasterize_tpu_torch.ops import fused_exec, part_io

from torch_support import PASS_DOCS, torch_lower

TILES = (16, 32, 64, 128)
PARTS = 24  # random parts a case


def _parts(seed: int, t: int, chain_linear: bool):
    rng = np.random.default_rng(seed)
    for _ in range(PARTS):
        canvas, part, viewport = chip_smoke.random_part(torch, rng, t, "cpu")
        yield rng, canvas, part._replace(flt=Filter.empty(chain_linear)), viewport


@pytest.mark.parametrize("chain_linear", [False, True], ids=["chain_srgb", "chain_linear"])
@pytest.mark.parametrize("canvas_linear", [False, True], ids=["canvas_srgb", "canvas_linear"])
@pytest.mark.parametrize("t", TILES)
def test_part_entry_matches_slice_assembly(t, canvas_linear, chain_linear):
    clipped = set()
    for _rng, canvas, part, viewport in _parts(t + 2 * canvas_linear + chain_linear, t,
                                               chain_linear):
        si0, sj0, nsi, nsj = part.span
        first, _count = part.rows
        image = torch.zeros((nsi * t, nsj * t, 4))
        for row, slot in enumerate(part.local.tolist()):
            i, j = divmod(slot, nsj)
            image[i * t:(i + 1) * t, j * t:(j + 1) * t] = canvas[first + row]
        # the source bbox in span pixels, cut to the span
        top, left, bottom, right = (part.content_bbox[0] - viewport[0] - si0 * t,
                                    part.content_bbox[1] - viewport[1] - sj0 * t,
                                    part.content_bbox[2] - viewport[0] - si0 * t,
                                    part.content_bbox[3] - viewport[1] - sj0 * t)
        clipped |= {side for side, past in (("top", top < 0), ("left", left < 0),
                                            ("bottom", bottom > nsi * t),
                                            ("right", right > nsj * t)) if past}
        r0, c0 = max(top, 0), max(left, 0)
        crop = image[r0:min(bottom, nsi * t), c0:min(right, nsj * t)]
        offset = (viewport[0] + si0 * t + r0, viewport[1] + sj0 * t + c0)
        want = Layer(crop, offset, pre_alpha=True, linear_rgb=canvas_linear).convert(
            pre_alpha=False, linear_rgb=chain_linear)

        alpha, graphic = part_io.part_entry(canvas, part, viewport, canvas_linear, t)
        assert (graphic.offset, graphic.pre_alpha, graphic.linear_rgb) == (
            offset, False, chain_linear)
        assert (alpha.offset, alpha.pre_alpha, alpha.linear_rgb) == (offset, True, chain_linear)
        assert torch.equal(graphic.image, want.image)
        assert torch.equal(alpha.image, crop[..., 3:] * torch.tensor([0.0, 0.0, 0.0, 1.0]))
    assert clipped == {"top", "left", "bottom", "right"}


RESULT_STATES = [(4, False, False), (4, False, True), (4, True, False), (4, True, True),
                 (1, True, True)]


@pytest.mark.parametrize("canvas_linear", [False, True], ids=["canvas_srgb", "canvas_linear"])
@pytest.mark.parametrize("state", RESULT_STATES,
                         ids=lambda s: f"c{s[0]}_pre{int(s[1])}_lin{int(s[2])}")
def test_part_exit_matches_merge_at_on_zeros(state, canvas_linear):
    past = set()
    t = 16
    for rng, _canvas, part, viewport in _parts(sum(state) + 7 * canvas_linear, t, True):
        result = chip_smoke.random_result(torch, rng, part, t, viewport, "cpu", state=state)
        di0, dj0, nti, ntj = part.out
        off = (result.x - viewport[0] - di0 * t, result.y - viewport[1] - dj0 * t)
        h, w = result.image.shape[:2]
        past |= {side for side, out in (("top", off[0] < 0), ("left", off[1] < 0),
                                        ("bottom", off[0] + h > nti * t),
                                        ("right", off[1] + w > ntj * t)) if out}
        span = merge_at(torch.zeros((nti * t, ntj * t, 4)),
                        result.convert(pre_alpha=True, linear_rgb=canvas_linear).image, off)
        pool = chip_smoke._random_canvas(torch, rng, t, part.dst_idx.shape[0]
                                         + chip_smoke.POOL_SPARE, "cpu")
        want = pool.clone()
        for s, d in zip(part.src_idx.tolist(), part.dst_idx.tolist()):
            i, j = divmod(s, ntj)
            want[d] = span[i * t:(i + 1) * t, j * t:(j + 1) * t]

        assert part_io.part_exit(pool, result, part, viewport, canvas_linear, t) is pool
        assert torch.equal(pool, want)
    assert past == {"top", "left", "bottom", "right"}


def _slot_docs():
    docs = dict(PASS_DOCS, pass_doc=chip_smoke.pass_doc(200, 400, 0))
    return sorted(docs.items())


@pytest.mark.parametrize("name,svg", _slot_docs(), ids=[n for n, _s in _slot_docs()])
def test_slot_map_inverts_part_local(name, svg):
    program = trp.upload_program(torch_lower(svg, 32), "cpu")
    parts = [part for level in program.levels for part in level.filters]
    if name in ("pass_doc", "passes", "drop_shadow_chain"):
        assert parts
    for part in parts:
        _si0, _sj0, nsi, nsj = part.span
        slots, local = part.slots.numpy(), part.local.numpy()
        assert slots.dtype == np.int32 and slots.shape == (nsi * nsj,)
        assert np.array_equal(slots[local], np.arange(part.rows[1]))
        assert (np.delete(slots, local) == -1).all()


class _KernelModel:
    """csrc/part_io.cu's two C entries in numpy, on CPU tensors by address."""

    @staticmethod
    def _floats(ptr, n, ctype=ctypes.c_float):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    @staticmethod
    def _convert(v, pre, gamma):
        def straight(v):
            a = v[:, 3:]
            v = np.concatenate([np.where(a > 1e-4, v[:, :3] / np.where(a > 1e-4, a, 1), v[:, :3]),
                                a], 1)
            return np.clip(v, 0, 1)

        def curve(x):
            if gamma == 1:
                return np.where(x <= 0.04045, x / np.float32(12.92), np.maximum(
                    (x + np.float32(0.055)) / np.float32(1.055), np.float32(1e-12))
                    ** np.float32(2.4))
            return np.where(x <= 0.0031308, x * np.float32(12.92), np.float32(1.055) * np.maximum(
                x, np.float32(1e-12)) ** np.float32(1 / 2.4) - np.float32(0.055))

        if pre is None:  # entry: un-premultiplied, then the curve
            v = straight(v)
        elif gamma:
            v = straight(v) if pre else v
        if gamma:
            v = np.concatenate([curve(v[:, :3]), v[:, 3:]], 1)
        if pre is not None and (gamma or not pre):
            v = np.concatenate([v[:, :3] * v[:, 3:], v[:, 3:]], 1)
        return v.astype(np.float32)

    def svgr_part_entry(self, rows, n_rows, slots, nsj, r0, c0, h, w, gamma, amask, graphic,
                        alpha, t, _stream):
        i = np.arange(h * w)
        r, c = r0 + i // w, c0 + i % w
        slot = (r // t) * nsj + c // t
        row = self._floats(slots, int(slot.max()) + 1, ctypes.c_int32)[slot]
        canvas = self._floats(rows, n_rows * t * t * 4).reshape(n_rows, t, t, 4)
        v = np.where((row >= 0)[:, None], canvas[np.maximum(row, 0), r % t, c % t], 0)
        mask = self._floats(amask, 4)
        self._floats(alpha, h * w * 4).reshape(-1, 4)[:] = v[:, 3:] * mask
        self._floats(graphic, h * w * 4).reshape(-1, 4)[:] = self._convert(v, None, gamma)
        return 0

    def svgr_part_exit(self, pool, pool_rows, result, h, w, channels, sr, sc, sch, pre, gamma,
                       off_r, off_c, ntj, span_tiles, src_idx, dst_idx, n, t, _stream):
        rows = self._floats(pool, pool_rows * t * t * 4).reshape(pool_rows, t * t, 4)
        extent = (h - 1) * sr + (w - 1) * sc + (channels - 1) * sch + 1
        image = np.lib.stride_tricks.as_strided(
            self._floats(result, extent), (h, w, channels), (4 * sr, 4 * sc, 4 * sch))
        p = np.arange(t * t)
        for s, d in zip(self._floats(src_idx, n, ctypes.c_int32),
                        self._floats(dst_idx, n, ctypes.c_int32)):
            r, c = (s // ntj) * t + p // t - off_r, (s % ntj) * t + p % t - off_c
            inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            v = np.asarray(image[r[inside], c[inside]], np.float32)
            v = np.repeat(v, 4, 1) if channels == 1 else self._convert(v, bool(pre), gamma)
            rows[d] = 0
            rows[d][inside] = np.clip(v + np.float32(0) * (1 - v[:, 3:]), 0, 1)
        return 0


@pytest.mark.parametrize("t", TILES)
def test_wrappers_hand_the_kernels_what_plain_computes(t, monkeypatch):
    """The wrappers' launch arguments, through a numpy model of the kernels,
    give the plain versions' seeds and pool rows within 1e-6 (numpy's pow
    against torch's)."""
    from svgrasterize_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "load", _KernelModel)
    monkeypatch.setattr(fused_exec, "_kernel_device", lambda device, what: True)
    monkeypatch.setattr(fused_exec, "_stream", lambda device: 0)
    rng = np.random.default_rng(t)
    fused_exec.reset_launch_counts()
    for i in range(PARTS):
        canvas, part, viewport = chip_smoke.random_part(torch, rng, t, "cpu")
        canvas_linear = bool(i % 2)
        got = fused_exec.part_entry(canvas, part, viewport, canvas_linear, t)
        want = part_io.part_entry(canvas, part, viewport, canvas_linear, t)
        for g, w in zip(got, want):
            assert (g.offset, g.pre_alpha, g.linear_rgb) == (w.offset, w.pre_alpha, w.linear_rgb)
            assert g.image.shape == w.image.shape
            assert not g.image.numel() or float((g.image - w.image).abs().max()) <= 1e-6
        pool = chip_smoke._random_canvas(torch, rng, t, part.dst_idx.shape[0]
                                         + chip_smoke.POOL_SPARE, "cpu")
        result = chip_smoke.random_result(torch, rng, part, t, viewport, "cpu")
        got, want = pool.clone(), pool.clone()
        fused_exec.part_exit(got, result, part, viewport, canvas_linear, t)
        part_io.part_exit(want, result, part, viewport, canvas_linear, t)
        assert float((got - want).abs().max()) <= 1e-6
    assert fused_exec.part_exit.launches == PARTS
