"""The whole-image winding kernel's scanline decomposition, on the CPU.

csrc/winding.cu computes each row of a winding field as its partial cells
(the closed form, only where an edge crosses the cell) plus the inclusive
prefix sum of one carry of sign * dy per (edge, row) pair, over row segments
of WINDING_BLOCK[1] columns whose pairs wholly left of the segment start the
row from a base.  scanline_winding below is that decomposition in plain
PyTorch, used by these tests only: on adversarial edge lists it agrees within
1e-5 with the plain version (ops/coverage.winding, which the wrappers take on
CPU tensors), the JAX package's coverage.winding and its Pallas kernel in
interpret mode (the same f32 terms, summed in another order).  The kernel
itself runs only on a CUDA card, where chip_smoke.py holds it against the
plain version on these lists.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgrasterize_tpu.ops.pallas_coverage as j_pc
from svgrasterize_tpu.ops import coverage as j_cov

from svgrasterize_tpu_torch.ops import coverage as t_cov
from svgrasterize_tpu_torch.ops import fused_exec

import chip_smoke
from torch_support import interpret_pallas  # noqa: F401 (a fixture)

TOL = 1e-5
KERNEL_SOURCE = Path(fused_exec.__file__).resolve().parent.parent / "csrc" / "winding.cu"


def _cell_term(k, xs0, xs1, col):
    """The closed form at a partial cell: sign * dy * mean, k = sign * dy."""
    g0 = (col + 1.0) - xs0
    g1 = (col + 1.0) - xs1
    den = g1 - g0
    safe = torch.abs(den) > 1e-7
    mean = torch.where(
        safe,
        (t_cov.clamp_antideriv(g1) - t_cov.clamp_antideriv(g0))
        / torch.where(safe, den, torch.ones_like(den)),
        torch.clamp(0.5 * (g0 + g1), 0.0, 1.0),
    )
    return k * mean


def _expand(counts):
    """(owner, offset) of each of sum(counts) items, counts per owner."""
    owner = torch.repeat_interleave(torch.arange(len(counts)), counts)
    start = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    return owner, torch.arange(len(owner)) - start


def scanline_winding(lines, height: int, width: int, seg: int = fused_exec.WINDING_BLOCK[1]):
    """Winding field (height, width) f32 of an edge list (S, 4) by the
    kernel's decomposition: per (edge, row) pair one slab clip; per row
    segment [c0, c1) pairs with ceil(xmax) <= c0 add sign * dy to the row's
    base, pairs with floor(xmin) >= c1 drop, the rest deposit the closed form
    on their partial cells [floor(xmin), ceil(xmax)) and a carry of
    sign * dy at ceil(xmax); the field is partial cells + base + inclusive
    prefix sum of the carries (f64 sums, rounded once)."""
    lines = torch.as_tensor(lines, dtype=torch.float32).reshape(-1, 4)
    out = torch.zeros((height, width), dtype=torch.float64)
    a0, a1, b0, b1 = lines.unbind(-1)
    sign = torch.sign(b0 - a0)
    y_lo, y_hi = torch.minimum(a0, b0), torch.maximum(a0, b0)
    x_lo = torch.where(a0 <= b0, a1, b1)
    x_hi = torch.where(a0 <= b0, b1, a1)
    dy_seg = y_hi - y_lo
    slope = (x_hi - x_lo) / torch.where(dy_seg > 0, dy_seg, torch.ones_like(dy_seg))
    # the (edge, row) pairs: each live edge and each row in [0, height) it crosses
    r0 = torch.clamp(torch.floor(y_lo), 0, height).long()
    r1 = torch.clamp(torch.ceil(y_hi), 0, height).long()
    e, off = _expand(torch.where(sign != 0, (r1 - r0).clamp(min=0), 0))
    row = r0[e] + off
    rowf = row.to(torch.float32)
    lo = torch.maximum(y_lo[e], rowf)
    hi = torch.minimum(y_hi[e], rowf + 1.0)
    dy = torch.clamp(hi - lo, min=0.0)
    xs0 = x_lo[e] + slope[e] * (lo - y_lo[e])
    xs1 = x_lo[e] + slope[e] * (hi - y_lo[e])
    k = sign[e] * dy
    fl = torch.floor(torch.minimum(xs0, xs1))
    ce = torch.ceil(torch.maximum(xs0, xs1))
    for c0 in range(0, width, seg):
        c1 = min(c0 + seg, width)
        left = ce <= c0
        base = torch.zeros(height, dtype=torch.float64).index_add_(
            0, row[left], k[left].double())
        mid = ~left & (fl < c1) & (dy > 0)
        first = torch.clamp(fl[mid], min=c0).long()
        cells = torch.clamp(ce[mid], max=c1).long() - first
        p, t = _expand(cells)
        col = first[p] + t
        term = _cell_term(k[mid][p], xs0[mid][p], xs1[mid][p], col.to(torch.float32))
        part = torch.zeros((height, c1 - c0), dtype=torch.float64)
        part.index_put_((row[mid][p], col - c0), term.double(), accumulate=True)
        carried = ce[mid] < c1
        carry = torch.zeros((height, c1 - c0), dtype=torch.float64)
        carry.index_put_((row[mid][carried], ce[mid][carried].long() - c0),
                         k[mid][carried].double(), accumulate=True)
        out[:, c0:c1] = part + (base[:, None] + torch.cumsum(carry, 1))
    return out.to(torch.float32)


# the adversarial lists chip_smoke.py holds the kernel to at 1024^2, here small
CASES = chip_smoke.winding_cases(24, 40, 1100)


def _jax_lines(lines):
    return jnp.asarray(j_cov.pad_lines(lines))


@pytest.mark.parametrize("name", sorted(CASES))
def test_scanline_matches_plain_jax_and_pallas(name, interpret_pallas):
    lines, h, w = CASES[name]
    got = scanline_winding(torch.from_numpy(lines), h, w)
    assert got.shape == (h, w) and bool(torch.isfinite(got).all())
    plain = t_cov.winding(torch.from_numpy(lines), h, w)
    assert float((got - plain).abs().max()) <= TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(j_cov.winding(_jax_lines(lines), h, w)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_pc.winding_pallas(_jax_lines(lines), h, w)),
                               rtol=0, atol=TOL)
    # the wrapper on a CPU tensor is the plain version, no launch
    fused_exec.reset_launch_counts()
    assert torch.equal(fused_exec.winding(torch.from_numpy(lines), h, w), plain)
    assert fused_exec.winding.launches == 0
    # one segment per row gives the same field within rounding
    assert float((scanline_winding(torch.from_numpy(lines), h, w, seg=max(w, 1)) - got)
                 .abs().max()) <= TOL


def test_scanline_segments_and_carries_are_exercised():
    """The adversarial lists reach every branch of the decomposition: pairs
    wholly left of a segment, dropped right of it, with partial cells only,
    with cells and a carry, with a carry only (vertical on an integer
    column), wide pairs (more than 4 cells) and coincident first cells."""
    seen = set()
    for lines, h, w in CASES.values():
        for c0 in range(0, w, fused_exec.WINDING_BLOCK[1]):
            c1 = min(c0 + fused_exec.WINDING_BLOCK[1], w)
            for a0, a1, b0, b1 in lines:
                if a0 == b0:
                    continue
                for r in range(h):
                    lo, hi = max(min(a0, b0), r), min(max(a0, b0), r + 1)
                    if hi <= lo:
                        continue
                    xs = [a1 + (b1 - a1) * (y - a0) / (b0 - a0) for y in (lo, hi)]
                    fl, ce = np.floor(min(xs)), np.ceil(max(xs))
                    if ce <= c0:
                        seen.add("left")
                    elif fl >= c1:
                        seen.add("right")
                    else:
                        cells = min(ce, c1) - max(fl, c0)
                        seen.add("carry" if ce < c1 else "no_carry")
                        seen.add("cells" if cells else "carry_only")
                        if cells > 4:
                            seen.add("wide")
                    if c0 > 0 and fl < c0 < ce:
                        seen.add("straddles_segment")
    assert seen >= {"left", "right", "carry", "no_carry", "cells", "carry_only", "wide",
                    "straddles_segment"}


def test_winding_batch_and_uniform_on_cpu_equal_plain():
    """The batched entries on the CPU: every adversarial list in one
    winding_batch, and winding_uniform over lists of one shape."""
    names = sorted(CASES)
    fields = fused_exec.winding_batch([CASES[n][0] for n in names],
                                      [CASES[n][1:] for n in names], "cpu")
    for name, field in zip(names, fields, strict=True):
        lines, h, w = CASES[name]
        assert torch.equal(field, t_cov.winding(torch.from_numpy(lines), h, w))
    lines = torch.from_numpy(
        np.random.default_rng(20).uniform(-2, 300, (3, 32, 4)).astype(np.float32))
    got = fused_exec.winding_uniform(lines, 28, 290)
    assert fused_exec.winding.launches == 0
    for i in range(3):
        assert torch.equal(got[i], t_cov.winding(lines[i], 28, 290))
        assert float((scanline_winding(lines[i], 28, 290) - got[i]).abs().max()) <= TOL


@pytest.mark.parametrize("size, blocks", [((8, 256), 1), ((9, 257), 4), ((1, 1100), 5),
                                          ((130, 129), 17), ((0, 300), 0), ((40, 0), 0)])
def test_mask_table_blocks_follow_winding_block(size, blocks):
    """A mask's blocks are its bands of WINDING_BLOCK[0] rows times its
    segments of WINDING_BLOCK[1] columns, the kernel's own block shape."""
    assert fused_exec.WINDING_BLOCK == (8, 256)
    src = KERNEL_SOURCE.read_text()
    assert re.search(r"constexpr int kRows = (\d+);", src).group(1) == "8"
    assert re.search(r"constexpr int kSeg = (\d+);", src).group(1) == "256"
    table, (_segs, pixels, total) = fused_exec._mask_table([3, 5], [size, (16, 512)])
    assert total == blocks + 2 * 2 and pixels == size[0] * size[1] + 16 * 512
    assert table[:, 5].tolist() == [0, blocks]
