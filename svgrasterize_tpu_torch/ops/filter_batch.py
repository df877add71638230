"""Batched execution of a dependency level's Gaussian-blur filter parts.

A filter-heavy scene lowers to dozens of isolation parts per dependency
level, each with a single-`feGaussianBlur` chain.  Instead of one op chain
per part, the parts of a level are grouped into chunks, and each chunk runs
as one batched computation (the JAX package's ops/filter_batch.py):

  1. a whole-tile-row gather assembles each part's source span, the
     span-position -> canvas-row LUT resolved on the host;
  2. alpha/colorspace conversion runs elementwise on the whole batch
     (pixels outside the crop window see sibling content in shared tiles;
     the band operators mask them out exactly);
  3. crop-shift, separable blur AND out-span placement fold into ONE pair
     of band-operator matmuls per channel,
     out_span[b] = BH[b] @ span[b] @ BW[b]^T, with
     BH[o, s] = u[(o + span_r0 - out_r) - (s - crop_r0)] masked to the
     part's real crop/output windows;
  4. the out spans convert back and re-tile into (T, T, 4) tiles.

Host planning (plan_level, build_chunks) is numpy and must produce the same
arrays as the JAX package's.  Batching is always on and size classes are
exact (the JAX defaults; its SVGR_BLUR_BATCH and SVGR_CHUNK_POW2 knobs are
not ported).  pack_level packs a level's chunks for the blur-chunk kernel
(csrc/blur_chunk.cu, wrapper ops/fused_exec.blur_chunk), one launch per
level; apply_level, apply_chunk per chunk, is its plain PyTorch version.

Parts that are not a lone separable blur (rotated kernels, multi-primitive
chains, per-primitive subregions) keep the per-part path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..filter import FE_GAUSSIAN_BLUR
from ..utils.constants import DEVICE_FLOAT

# cap on B * max(span, out_span) pixels per chunk (~64 MB of f32 RGBA)
_CHUNK_ELEMS = 1 << 22


def _part_spec(part, grid_w: int, viewport, t_size: int):
    """Host metadata for one batchable part, or None to keep it per-part.

    Mirrors the crop/offset arithmetic of the per-part path
    (ops/part_io.crop_window + Layer.convolve) exactly: the
    reference's `int(x - k/2)` blur placement is truncation-sensitive,
    so both paths must feed the same origins to the same formula.
    """
    from . import blur as blur_ops

    flt, transform, bbox = part["post"]
    if len(flt.filters) != 1:
        return None
    kind, attrs, inputs = flt.filters[0]
    if kind != FE_GAUSSIAN_BLUR or any(r is not None for r in flt.regions):
        return None
    if tuple(inputs) not in ((0,), (1,)):
        return None
    std_x, std_y = attrs
    std_y = std_x if std_y is None else std_y
    kernel = blur_ops.gaussian_kernel(transform, (std_x, std_y))
    if kernel is None:
        u = v = np.ones(1, np.float64)  # sub-pixel blur: exact identity
    else:
        uv = blur_ops.separate_kernel(np.asarray(kernel))
        if uv is None:
            return None  # rotated/non-separable kernel: per-part 2D conv
        u, v = uv

    T = t_size
    v0, v1 = int(viewport[0]), int(viewport[1])
    src_tiles = [int(t) for t in part["src_tiles"]]
    s_rows = [t // grid_w for t in src_tiles]
    s_cols = [t % grid_w for t in src_tiles]
    si0, sj0 = min(s_rows), min(s_cols)
    nsi = max(s_rows) - si0 + 1
    nsj = max(s_cols) - sj0 + 1
    or_, oc = si0 * T, sj0 * T  # span origin, canvas px
    r0 = max(bbox[0] - v0 - or_, 0)
    c0 = max(bbox[1] - v1 - oc, 0)
    r1 = min(bbox[2] - v0 - or_, nsi * T)
    c1 = min(bbox[3] - v1 - oc, nsj * T)
    if r1 <= r0 or c1 <= c0:
        return None  # empty crop: keep the per-part path's semantics
    kh, kw = len(u), len(v)
    crop_r, crop_c = or_ + r0, oc + c0  # crop origin, canvas px
    if kernel is None:
        out_r, out_c = crop_r, crop_c  # identity keeps the layer origin
    else:
        # reference truncation: int(x - k/2) on the ABSOLUTE origin
        out_r = int(v0 + crop_r - kh / 2) - v0
        out_c = int(v1 + crop_c - kw / 2) - v1
    out_tiles = [int(t) for t in part["out_tiles"]]
    o_rows = [t // grid_w for t in out_tiles]
    o_cols = [t % grid_w for t in out_tiles]
    oi0, oj0 = min(o_rows), min(o_cols)
    return {
        "u": u, "v": v,
        "r0": r0, "c0": c0,  # crop origin, span px
        "crop_h": r1 - r0, "crop_w": c1 - c0,
        "out_h": (r1 - r0) + kh - 1, "out_w": (c1 - c0) + kw - 1,
        # blurred row index = out-span row + od_r (span origin minus the
        # blurred image's origin)
        "od_r": oi0 * T - out_r, "od_c": oj0 * T - out_c,
        "nsi": nsi, "nsj": nsj,
        "noi": max(o_rows) - oi0 + 1, "noj": max(o_cols) - oj0 + 1,
        "span_tile": (si0, sj0),
        "out_local": [(r - oi0, c - oj0) for r, c in zip(o_rows, o_cols)],
        "src_tiles": src_tiles,
        "row_start": int(part["row_start"]),
        # final pool row of the part's first out tile; reassigned by the
        # caller (render_plan._plan_groups emission-order pool numbering)
        # before build_chunks consumes it
        "pool_base": part["pool_base"],
        "src_alpha": tuple(inputs) == (0,),
        "chain_linear": bool(flt.linear),
    }


def _band(taps, n_in_real: int, shift: int, dr: int,
          n_out: int, n_in: int) -> np.ndarray:
    """Band operator folding crop, full convolution, and placement:
    B[o, s] = taps[(o + dr) - (s - shift)] masked to the part's real
    crop columns (s - shift in [0, n_in_real)) and real output rows
    ((o + dr) in [0, n_in_real + k - 1))."""
    k = len(taps)
    m = np.zeros((n_out, n_in), DEVICE_FLOAT)
    o = np.arange(n_out)[:, None] + dr
    s = np.arange(n_in)[None, :]
    p = s - shift
    band = o - p
    inside = ((band >= 0) & (band < k) & (p >= 0) & (p < n_in_real)
              & (o >= 0) & (o < n_in_real + k - 1))
    m[inside] = np.asarray(taps, np.float64)[band[inside]]
    return m


def plan_level(parts, grid_w: int, viewport, t_size: int):
    """Partition a level's filtered parts into batchable chunk groups.

    Returns (chunk_groups: list of ([(pi, spec)], chain_linear),
    batched: set of part indices) — pool-independent metadata only, so
    the caller can assign pool rows in emission order (per-part outputs
    first, then each chunk's) BEFORE building the chunk tensors with
    build_chunks.  Chunks group parts with the same conversion signature
    and the same exact size class (the largest tile dimension of span and
    output), sorted by span area and split under _CHUNK_ELEMS so small
    crops never pad to the scene maximum.
    """
    specs = {}
    for pi, part in enumerate(parts):
        if part["post"] is None:
            continue
        spec = _part_spec(part, grid_w, viewport, t_size)
        if spec is not None:
            specs[pi] = spec
    chunk_groups = []
    by_sig: dict = {}
    for pi, s in specs.items():
        by_sig.setdefault(s["chain_linear"], []).append((pi, s))
    spx = t_size * t_size

    def cost(items):
        si = max(t[1]["nsi"] for t in items) * max(t[1]["nsj"] for t in items)
        so = max(t[1]["noi"] for t in items) * max(t[1]["noj"] for t in items)
        return len(items) * max(si, so) * spx

    def dclass(s):
        return max(s["nsi"], s["nsj"], s["noi"], s["noj"])

    for chain_linear, group in by_sig.items():
        by_class: dict = {}
        for pi, s in group:
            by_class.setdefault(dclass(s), []).append((pi, s))
        for _cl, sub in sorted(by_class.items()):
            sub.sort(key=lambda kv: max(
                kv[1]["nsi"] * kv[1]["nsj"], kv[1]["noi"] * kv[1]["noj"]
            ))
            cur: list = []
            for pi, s in sub:
                if cur and cost(cur + [(pi, s)]) > _CHUNK_ELEMS:
                    chunk_groups.append((cur, chain_linear))
                    cur = [(pi, s)]
                else:
                    cur = cur + [(pi, s)]
            if cur:
                chunk_groups.append((cur, chain_linear))
    return chunk_groups, set(specs)


def build_chunks(chunk_groups, grid_w: int, t_size: int):
    """Build the chunk dicts; specs must carry final pool_base."""
    return [
        _build_chunk(group, grid_w, t_size, chain_linear)
        for group, chain_linear in chunk_groups
    ]


def plan_level_batches(parts, grid_w: int, viewport, t_size: int):
    """One-step plan for parts that already carry final pool rows."""
    chunk_groups, batched = plan_level(parts, grid_w, viewport, t_size)
    return build_chunks(chunk_groups, grid_w, t_size), batched


def _build_chunk(group, grid_w: int, t_size: int, chain_linear: bool) -> dict:
    B = len(group)
    nsi = max(s["nsi"] for _, s in group)
    nsj = max(s["nsj"] for _, s in group)
    noi = max(s["noi"] for _, s in group)
    noj = max(s["noj"] for _, s in group)
    T = t_size
    i32 = np.int32
    # span-position -> canvas-row LUT (row-major over the padded span)
    lut = np.full((B, nsi * nsj), -1, i32)
    for b, (_, s) in enumerate(group):
        si0, sj0 = s["span_tile"]
        for k, t in enumerate(s["src_tiles"]):
            di = t // grid_w - si0
            dj = t % grid_w - sj0
            lut[b, di * nsj + dj] = s["row_start"] + k
    # out-span position -> pool row (gather the listed out tiles only)
    out_idx, pool_idx = [], []
    for b, (_, s) in enumerate(group):
        for k, (di, dj) in enumerate(s["out_local"]):
            out_idx.append((b * noi + di) * noj + dj)
            pool_idx.append(s["pool_base"] + k)
    return {
        "B": B, "NSi": nsi, "NSj": nsj, "NOi": noi, "NOj": noj,
        "chain_linear": chain_linear,
        "lut": lut,
        "bh": np.stack([
            _band(s["u"], s["crop_h"], s["r0"], s["od_r"], noi * T, nsi * T)
            for _, s in group
        ]),
        "bw": np.stack([
            _band(s["v"], s["crop_w"], s["c0"], s["od_c"], noj * T, nsj * T)
            for _, s in group
        ]),
        "src_alpha": np.array([s["src_alpha"] for _, s in group], bool),
        "out_idx": np.array(out_idx, i32),
        "pool_idx": pool_idx,
    }


def gammas(chain_linear: bool, linear_rgb: bool):
    """(gamma_in, gamma_out) conversions around a chunk's blur: None when
    the chain's colorspace is the canvas's."""
    if chain_linear == linear_rgb:
        return None, None
    if chain_linear:
        return "to_linear", "to_srgb"
    return "to_srgb", "to_linear"


def _planar_convert(x, to_straight: bool, gamma: str | None, axis: int = 1):
    """Layer.convert math on channel-planar batches; the same piecewise
    formulas as core.color, with channels on `axis` (4 entries)."""
    cshape = [1] * x.ndim
    cshape[axis] = 4
    is_rgb = (torch.arange(4, device=x.device) < 3).reshape(cshape)
    alpha = x.narrow(axis, 3, 1)  # broadcasts over `axis`
    if to_straight:
        pos = alpha > 0.0001
        safe = torch.where(pos, alpha, torch.ones_like(alpha))
        x = torch.where(is_rgb & pos, x / safe, x)
        x = torch.clamp(x, 0, 1)  # reference clips rgb AND alpha here
    if gamma == "to_linear":
        g = torch.where(
            x <= 0.04045,
            x / 12.92,
            torch.pow(torch.clamp((x + 0.055) / 1.055, min=1e-12), 2.4),
        )
        x = torch.where(is_rgb, g, x)
    elif gamma == "to_srgb":
        g = torch.where(
            x <= 0.0031308,
            x * 12.92,
            1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055,
        )
        x = torch.where(is_rgb, g, x)
    if not to_straight:  # straight -> premultiplied
        x = torch.where(is_rgb, x * alpha, x)
    return x


# columns of a packed level's chunk table (csrc/kernels.h SVGR_BT_*)
LEVEL_TABLE_COLS = 13
(LT_OUT, LT_B, LT_NSI, LT_NSJ, LT_NOI, LT_NOJ, LT_LINEAR, LT_LUT, LT_BH, LT_BW,
 LT_PART, LT_HB, LT_WB) = range(LEVEL_TABLE_COLS)
_INT32_MAX = 2**31 - 1
# out rows one blur-chunk kernel block computes, and the span columns one
# step of its walk covers at each tile size (csrc/blur_chunk.cu kRows, kC)
BLUR_ROWS = 16
BLUR_STEP = {16: 16, 32: 32, 64: 32, 128: 32}


def band_tables(ck: dict, t_size: int):
    """The nonzero columns [lo, hi) of a chunk's band operators: of BH's
    rows per (part, BLUR_ROWS-row block of the out span),
    (B * NOi * T / BLUR_ROWS, 2) int32, the rows a kernel block computes,
    and of BW's rows per (part, out-tile column), (B * NOj, 2) int32;
    lo = hi = 0 where the rows are all zero (a part smaller than its chunk
    pads with such tiles)."""

    def spans(m, rows):
        m = np.asarray(m)
        n_in = m.shape[-1]
        nz = (m.reshape(-1, rows, n_in) != 0).any(axis=1)
        has = nz.any(axis=-1)
        lo = np.where(has, nz.argmax(axis=-1), 0)
        hi = np.where(has, n_in - nz[:, ::-1].argmax(axis=-1), 0)
        return np.stack([lo, hi], axis=-1).astype(np.int32)

    return spans(ck["bh"], BLUR_ROWS), spans(ck["bw"], t_size)


class BlurLevel(NamedTuple):
    """A level's blur chunks packed for one blur-chunk launch
    (csrc/blur_chunk.cu): the chunks' arrays back to back on the device,
    with a per-chunk table of offsets, and the level's pool write."""

    chunks: list  # per chunk: its dict, arrays on the device (views of the below)
    order: tuple  # each packed chunk's index in the list pack_level was given
    lut: torch.Tensor  # (sum B * NSi * NSj,) int32
    bh: torch.Tensor  # (sum B * NOi * T * NSi * T,) f32
    bw: torch.Tensor  # (sum B * NOj * T * NSj * T,) f32
    src_alpha: torch.Tensor  # (sum B,) int32
    hband: torch.Tensor  # (sum B * NOi * T / BLUR_ROWS, 2) int32, band_tables
    wband: torch.Tensor  # (sum B * NOj, 2) int32
    table: torch.Tensor  # (chunks, LEVEL_TABLE_COLS) int32
    out_idx: torch.Tensor  # (n,) int32 out tiles of the level's output to keep
    pool_idx: torch.Tensor  # (n,) int32 their pool rows
    tiles: int  # the level's out tiles, sum B * NOi * NOj


def _level_table(chunks, t_size: int) -> np.ndarray:
    """The (chunks, LEVEL_TABLE_COLS) int64 table of a level's chunks: each
    one's first out tile, sizes, colorspace and offsets into the
    concatenated arrays (exclusive prefix sums of their sizes)."""
    t2 = t_size * t_size
    rows = []
    for ck in chunks:
        b, nsi, nsj, noi, noj = (int(ck[k]) for k in ("B", "NSi", "NSj", "NOi", "NOj"))
        rows.append((b * noi * noj, b, nsi, nsj, noi, noj, int(bool(ck["chain_linear"])),
                     b * nsi * nsj, b * noi * nsi * t2, b * noj * nsj * t2, b,
                     b * noi * t_size // BLUR_ROWS, b * noj))
    sizes = np.asarray(rows, np.int64).reshape(-1, LEVEL_TABLE_COLS)
    table = sizes.copy()
    for col in (LT_OUT, LT_LUT, LT_BH, LT_BW, LT_PART, LT_HB, LT_WB):
        table[:, col] = np.cumsum(sizes[:, col]) - sizes[:, col]
    return table


def _longest_walk(ck: dict, hband, wband, t_size: int) -> int:
    """Steps of the longest kernel block of a chunk (an upper bound: the
    widest BH band times the widest BW band of a part, plus its Z stages)."""
    step = BLUR_STEP[t_size]

    def steps(bands, n):
        lo, hi = bands[:, 0], bands[:, 1]
        k = np.where(lo < hi, -(-(hi - lo // step * step) // step), 0)
        return k.reshape(ck["B"], n).max(axis=1)

    n_h = steps(hband, ck["NOi"] * t_size // BLUR_ROWS)
    n_w = steps(wband, ck["NOj"])
    return int((n_h * n_w + n_w).max())


def pack_level(chunks, t_size: int, device) -> BlurLevel | None:
    """Pack a level's chunks (build_chunks' numpy dicts) into a BlurLevel
    on `device`, once per program; None for a level without chunks.

    The chunks are packed longest kernel walk first (BlurLevel.order), and
    each chunk's output lands at its first out tile of the level's output
    (table column LT_OUT), so the level's pool write is one gather:
    out_idx, each chunk's offset by its first out tile, into pool_idx.
    """
    if not chunks:
        return None
    dev = torch.device(device)
    bands = [band_tables(ck, t_size) for ck in chunks]
    # the chunks with the longest blocks first, so those start first
    order = sorted(range(len(chunks)),
                   key=lambda i: -_longest_walk(chunks[i], *bands[i], t_size))
    chunks, bands = [chunks[i] for i in order], [bands[i] for i in order]
    table = _level_table(chunks, t_size)
    cat = {
        "lut": np.concatenate([np.asarray(ck["lut"], np.int32).reshape(-1) for ck in chunks]),
        "bh": np.concatenate([np.asarray(ck["bh"], np.float32).reshape(-1) for ck in chunks]),
        "bw": np.concatenate([np.asarray(ck["bw"], np.float32).reshape(-1) for ck in chunks]),
        "src_alpha": np.concatenate([np.asarray(ck["src_alpha"]).astype(np.int32)
                                     for ck in chunks]),
    }
    if max(a.size for a in cat.values()) > _INT32_MAX:
        raise ValueError("pack_level: the level exceeds 32-bit offsets")
    up = {k: torch.from_numpy(v).to(dev) for k, v in cat.items()}
    out_idx = np.concatenate([np.asarray(ck["out_idx"], np.int64) + off
                              for ck, off in zip(chunks, table[:, LT_OUT])])
    pool_idx = np.concatenate([np.asarray(ck["pool_idx"], np.int64) for ck in chunks])

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    views = []
    for ck, row in zip(chunks, table):
        b, nsi, nsj, noi, noj = (int(v) for v in row[LT_B:LT_NOJ + 1])
        t = t_size
        views.append(dict(
            ck,
            lut=up["lut"][row[LT_LUT]:row[LT_LUT] + b * nsi * nsj].view(b, nsi * nsj),
            bh=up["bh"][row[LT_BH]:row[LT_BH] + b * noi * t * nsi * t].view(b, noi * t, nsi * t),
            bw=up["bw"][row[LT_BW]:row[LT_BW] + b * noj * t * nsj * t].view(b, noj * t, nsj * t),
            src_alpha=up["src_alpha"][row[LT_PART]:row[LT_PART] + b],
            out_idx=i32(ck["out_idx"]),
            pool_idx=i32(ck["pool_idx"]),
        ))
    return BlurLevel(
        chunks=views, order=tuple(order), **up,
        hband=i32(np.concatenate([h for h, _w in bands])),
        wband=i32(np.concatenate([w for _h, w in bands])),
        table=i32(table), out_idx=i32(out_idx), pool_idx=i32(pool_idx),
        tiles=int(table[-1, LT_OUT] + table[-1, LT_B] * table[-1, LT_NOI] * table[-1, LT_NOJ]),
    )


def apply_level(canvas, level: BlurLevel, t_size: int, linear_rgb: bool):
    """Plain version of a level's blur-chunk launch: apply_chunk per chunk,
    the outputs back to back, (level.tiles, T, T, 4)."""
    return torch.cat([apply_chunk(canvas, ck, t_size, linear_rgb) for ck in level.chunks])


def apply_chunk(canvas, ck: dict, t_size: int, linear_rgb: bool):
    """Plain version of the blur-chunk kernel: canvas rows (R, T, T, 4) ->
    every out-span tile of the chunk, (B * NOi * NOj, T, T, 4).

    The level's pool update picks the listed out tiles (ck["out_idx"]) and
    writes them to their pool rows (ck["pool_idx"]).  A torch copy of the
    XLA chain of the JAX package's apply_chunk in the interleaved layout;
    the band matmuls run in full f32.
    """
    dev = canvas.device
    T = t_size
    B, NSi, NSj, NOi, NOj = ck["B"], ck["NSi"], ck["NSj"], ck["NOi"], ck["NOj"]
    H, W = NSi * T, NSj * T

    # 1. span assembly: whole-tile-row gather; -1 reads the zero pad row
    lut = torch.as_tensor(ck["lut"], device=dev).long()
    rows = torch.cat([canvas, canvas.new_zeros((1, T, T, 4))], dim=0)[
        torch.where(lut < 0, canvas.shape[0], lut)
    ]  # (B, S, T, T, 4)
    span = (
        rows.reshape(B, NSi, NSj, T, T, 4)
        .permute(0, 5, 1, 3, 2, 4)
        .reshape(B, 4, H, W)
    )

    # 2. conversions (Layer.convert(pre_alpha=False, linear_rgb=chain))
    src_alpha = torch.as_tensor(ck["src_alpha"], device=dev).bool()
    amask = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=span.dtype, device=dev)
    span = torch.where(src_alpha[:, None, None, None],
                       span * amask[:, None, None], span)
    gamma_in, gamma_out = gammas(ck["chain_linear"], linear_rgb)
    span = _planar_convert(span, to_straight=True, gamma=gamma_in)

    # 3. crop + blur + placement as one pair of band matmuls per channel
    bh = torch.as_tensor(ck["bh"], device=dev)  # (B, Ho, H)
    bw = torch.as_tensor(ck["bw"], device=dev)  # (B, Wo, W)
    z = torch.matmul(bh[:, None], span)                   # (B, 4, Ho, W)
    out = torch.matmul(z, bw.transpose(1, 2)[:, None])    # (B, 4, Ho, Wo)
    out = _planar_convert(out, to_straight=False, gamma=gamma_out)

    # 4. back to (T, T, 4) tiles, out-span row-major per part
    return (
        out.reshape(B, 4, NOi, T, NOj, T)
        .permute(0, 2, 4, 3, 5, 1)
        .reshape(B * NOi * NOj, T, T, 4)
    )
