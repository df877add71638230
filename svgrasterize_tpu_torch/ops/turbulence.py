"""feTurbulence: the SVG spec's Perlin noise, evaluated in torch.

A copy of the JAX package's ops/turbulence.py: the lattice tables come from
the spec's linear-congruential PRNG (host, integer math), and the per-pixel
noise (two-level lattice gathers + s-curve lerp, octave sum) runs as one
vectorised pass over the pixel grid.  The reference declares FE_TURBULENCE
but never executes it (svgrasterize.py:1732).

turbulence_region (turbulence_impl over a region's pixel centres) is the
plain version and the CPU's path: on a CUDA device filter._apply runs
csrc/fe_turbulence.cu (ops/fused_exec.fe_turbulence, the same arguments),
the same arithmetic in one launch, which the card's tests hold against it.
"""

from __future__ import annotations

import numpy as np
import torch

_BSIZE = 256
_BM = 0xFF
_PERLIN_N = 0x1000

# spec PRNG constants (after Park & Miller)
_RAND_M = 2147483647
_RAND_A = 16807
_RAND_Q = 127773
_RAND_R = 2836


def _random(seed: int) -> int:
    result = _RAND_A * (seed % _RAND_Q) - _RAND_R * (seed // _RAND_Q)
    return result if result > 0 else result + _RAND_M


def lattice_tables(seed: int):
    """Spec-exact lattice setup: (selector (512+2,) int32, gradients
    (4, 512+2, 2) float32)."""
    seed = int(seed)
    if seed <= 0:
        seed = -(seed % (_RAND_M - 1)) + 1
    if seed > _RAND_M - 1:
        seed = _RAND_M - 1

    selector = np.zeros(_BSIZE + _BSIZE + 2, dtype=np.int32)
    gradient = np.zeros((4, _BSIZE + _BSIZE + 2, 2), dtype=np.float64)
    for k in range(4):
        for i in range(_BSIZE):
            selector[i] = i
            for j in range(2):
                seed = _random(seed)
                gradient[k][i][j] = ((seed % (_BSIZE + _BSIZE)) - _BSIZE) / _BSIZE
            s = np.sqrt(gradient[k][i][0] ** 2 + gradient[k][i][1] ** 2)
            if s > 0:
                gradient[k][i] /= s
    for i in range(_BSIZE - 1, 0, -1):
        seed = _random(seed)
        j = seed % _BSIZE
        selector[i], selector[j] = selector[j], selector[i]
    for i in range(_BSIZE + 2):
        selector[_BSIZE + i] = selector[i]
        gradient[:, _BSIZE + i] = gradient[:, i]
    return selector, gradient.astype(np.float32)


def _s_curve(t):
    return t * t * (3.0 - 2.0 * t)


def _noise2(selector, gradient, vx, vy):
    """Spec noise2 for one channel: selector (512+2,) int64, gradient
    (512+2, 2), vx/vy (...,)."""
    tx = vx + _PERLIN_N
    bx0 = tx.to(torch.int32).long() & _BM
    bx1 = (bx0 + 1) & _BM
    rx0 = tx - torch.floor(tx)
    rx1 = rx0 - 1.0
    ty = vy + _PERLIN_N
    by0 = ty.to(torch.int32).long() & _BM
    by1 = (by0 + 1) & _BM
    ry0 = ty - torch.floor(ty)
    ry1 = ry0 - 1.0

    i = selector[bx0]
    j = selector[bx1]
    g00 = gradient[selector[i + by0]]
    g10 = gradient[selector[j + by0]]
    g01 = gradient[selector[i + by1]]
    g11 = gradient[selector[j + by1]]

    sx = _s_curve(rx0)
    sy = _s_curve(ry0)
    u = rx0 * g00[..., 0] + ry0 * g00[..., 1]
    v = rx1 * g10[..., 0] + ry0 * g10[..., 1]
    a = u + sx * (v - u)
    u = rx0 * g01[..., 0] + ry1 * g01[..., 1]
    v = rx1 * g11[..., 0] + ry1 * g11[..., 1]
    b = u + sx * (v - u)
    return a + sy * (b - a)


def turbulence_impl(selector, gradient, x, y, base_fx, base_fy, octaves: int,
                    fractal: bool):
    """RGBA turbulence over user-space points x/y (...,) -> (..., 4).

    selector / gradient: lattice_tables' arrays (numpy or tensors)."""
    dev = x.device
    selector = torch.as_tensor(selector, device=dev).long()
    gradient = torch.as_tensor(gradient, device=dev)
    out = []
    for k in range(4):
        vx = x * base_fx
        vy = y * base_fy
        ratio = 1.0
        total = torch.zeros_like(x)
        for _ in range(octaves):
            n = _noise2(selector, gradient[k], vx, vy)
            total = total + (n if fractal else torch.abs(n)) / ratio
            vx = vx * 2.0
            vy = vy * 2.0
            ratio = ratio * 2.0
        out.append((total + 1.0) / 2.0 if fractal else total)
    return torch.clamp(torch.stack(out, dim=-1), 0.0, 1.0).to(torch.float32)


def turbulence_region(selector, gradient, offset, size, inverse, base_fx, base_fy,
                      octaves: int, fractal: bool):
    """RGBA turbulence (h, w, 4) over h x w device pixels (size) from offset,
    each pixel centre taken to user space by inverse, the device-to-user
    transform's first two rows (2, 3); on the tables' device.  The plain
    version of fused_exec.fe_turbulence, with its arguments."""
    (h, w), dev = size, gradient.device
    pr = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + offset[0] + 0.5
    pc = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + offset[1] + 0.5
    ux = float(inverse[0][0]) * pr + float(inverse[0][1]) * pc + float(inverse[0][2])
    uy = float(inverse[1][0]) * pr + float(inverse[1][1]) * pc + float(inverse[1][2])
    ux, uy = torch.broadcast_tensors(ux, uy)
    return turbulence_impl(selector, gradient, ux, uy, base_fx, base_fy, octaves, fractal)
