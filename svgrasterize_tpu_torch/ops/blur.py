"""Gaussian blur (feGaussianBlur): kernel construction on the host, full
convolutions in torch.

The kernel is constructed in *user space* (so blurs rotate correctly with the
presentation transform — ref svgrasterize.py:1903-1944).  For axis-aligned
transforms the kernel is exactly separable and runs as two band matmuls (on
the card a 4-channel layer takes csrc/fe_blur.cu, whose plain version is
fe_blur below); otherwise as one depthwise 2D convolution.  All
convolutions are 'full', so the layer grows by the kernel extent, matching
scipy.signal.convolve semantics.  A copy of the JAX package's ops/blur.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import color
from ..utils.constants import DEVICE_FLOAT

# truncate the gaussian at this many sigmas (ref :1924)
_SIGMA_CUTOFF = 2.5


def gaussian_kernel(transform, sigma_user: tuple[float, float]) -> np.ndarray | None:
    """Build the device-space blur kernel for user-space sigmas; None if no-op."""
    sigma_x, sigma_y = sigma_user
    scale_x, scale_y = transform.scale_factors()
    if scale_x * sigma_x < 0.5 and scale_y * sigma_y < 0.5:
        return None  # sub-pixel blur is a no-op
    if scale_x * sigma_x < 0.5:
        sigma_x = 0.5 / scale_x
    elif scale_y * sigma_y < 0.5:
        sigma_y = 0.5 / scale_y

    # device-space bbox of the +-cutoff*sigma user-space box
    box = np.array(
        [
            [-_SIGMA_CUTOFF * sigma_x, -_SIGMA_CUTOFF * sigma_y],
            [-_SIGMA_CUTOFF * sigma_x, _SIGMA_CUTOFF * sigma_y],
            [_SIGMA_CUTOFF * sigma_x, _SIGMA_CUTOFF * sigma_y],
            [_SIGMA_CUTOFF * sigma_x, -_SIGMA_CUTOFF * sigma_y],
        ]
    )
    box = transform.apply_vectors(box)
    lo = box.min(axis=0).astype(int)
    hi = box.max(axis=0).astype(int)
    kh, kw = hi[0] - lo[0], hi[1] - lo[1]
    kh += ~kh & 1  # make odd
    kw += ~kw & 1
    if kh < 1 or kw < 1:
        return None

    # evaluate the user-space gaussian at device pixel centers
    r = np.arange(kh, dtype=np.float64) - kh / 2 + 0.5
    c = np.arange(kw, dtype=np.float64) - kw / 2 + 0.5
    grid = np.stack(np.meshgrid(r, c, indexing="ij"), axis=-1).reshape(-1, 2)
    inv = transform.invert
    user = inv.apply_vectors(grid)
    k = np.exp(-np.square(user) / (2 * np.square([sigma_x, sigma_y])))
    k = k.prod(axis=-1).reshape(kh, kw)
    return (k / k.sum()).astype(DEVICE_FLOAT)


def separate_kernel(kernel: np.ndarray):
    """(u, v) with kernel == outer(u, v), or None if not rank-1.

    Axis-aligned gaussian kernels factor exactly (row sums x column sums
    for a normalized kernel), turning a kh*kw-tap conv into kh + kw taps.
    """
    u = kernel.sum(axis=1)
    v = kernel.sum(axis=0)
    s = kernel.sum()
    if s <= 0:
        return None
    if not np.allclose(np.outer(u, v) / s, kernel, atol=1e-7):
        return None
    return u / s, v


class BlurTaps(NamedTuple):
    """A blur kernel on the device (upload_kernel)."""

    shape: tuple  # (kh, kw)
    u: torch.Tensor | None  # (kh,) f32 row factor of a separable kernel
    v: torch.Tensor | None  # (kw,) f32 column factor
    full: torch.Tensor | None  # (kh, kw) f32 kernel that does not separate


def upload_kernel(kernel: np.ndarray, device) -> BlurTaps:
    """Upload a kernel as its separable factors (when it is rank 1 and both
    sides exceed one tap) or whole."""
    kh, kw = kernel.shape
    uv = separate_kernel(kernel) if min(kh, kw) > 1 else None
    if uv is not None:
        return BlurTaps((kh, kw), torch.as_tensor(uv[0].astype(np.float32), device=device),
                        torch.as_tensor(uv[1].astype(np.float32), device=device), None)
    return BlurTaps((kh, kw), None, None,
                    torch.as_tensor(np.asarray(kernel, np.float32), device=device))


def _band_matrix(taps: torch.Tensor, n_in: int) -> torch.Tensor:
    """(n_in + k - 1, n_in) full-convolution operator: B[o, i] = taps[o - i]."""
    k = taps.shape[0]
    o = torch.arange(n_in + k - 1, device=taps.device)[:, None]
    band = o - torch.arange(n_in, device=taps.device)[None, :]
    inside = (band >= 0) & (band < k)
    return torch.where(inside, taps[band.clamp(0, k - 1)], torch.zeros((), device=taps.device))


def convolve_separable(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Full separable convolution as two band matmuls in full f32: rows by
    u, columns by v; (h, w, ch) -> (h + ku - 1, w + kv - 1, ch).

    The JAX package's _convolve_separable_mxu: (h_out, h) @ (h, w*ch), then
    the column operator contracted over w.
    """
    h, w, ch = image.shape
    bu = _band_matrix(u.to(image.dtype), h)
    bv = _band_matrix(v.to(image.dtype), w)
    rows = torch.matmul(bu, image.reshape(h, w * ch))  # (h_out, w*ch)
    rows = rows.reshape(-1, w, ch).transpose(1, 2)      # (h_out, ch, w)
    return torch.matmul(rows, bv.T).transpose(1, 2)     # (h_out, w_out, ch)


def fe_blur(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor, unpremultiply: bool):
    """A filter chain's separable blur of an (h, w, 4) layer image, first
    un-premultiplied (color.pre_to_straight_alpha) when unpremultiply is
    set: the plain version of csrc/fe_blur.cu (ops/fused_exec.fe_blur),
    which the kernel is held against.  Layer.convolve's CPU path, the
    conversion then convolve_separable, runs the same operations."""
    if unpremultiply:
        image = color.pre_to_straight_alpha(image)
    return convolve_separable(image, u, v)


def convolve_full(image: torch.Tensor, kernel: torch.Tensor):
    """Full 2D depthwise convolution: (h, w, ch) * (kh, kw) -> grown image.

    cuDNN's TF32 is switched off where it runs: the reference is f32.
    """
    ch = image.shape[-1]
    kh, kw = kernel.shape
    x = image.permute(2, 0, 1)[None]  # NCHW
    # true convolution = cross-correlation with the flipped kernel
    k = torch.flip(kernel.to(image.dtype), (0, 1))
    k = k[None, None].expand(ch, 1, kh, kw).contiguous()
    with torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic,
        allow_tf32=False,
    ):
        out = F.conv2d(x, k, padding=(kh - 1, kw - 1), groups=ch)
    return out[0].permute(1, 2, 0)
