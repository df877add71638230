"""Minimal dependency-free PNG codec (8-bit RGBA).

The writer emits filter-0 rows with a zlib IDAT like the reference encoder
(svgrasterize.py:249-274); the reader implements full
defiltering (all 5 filter types) so tests can load golden PNGs.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import BinaryIO

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(output: BinaryIO, tag: bytes, data: bytes) -> None:
    output.write(struct.pack("!I", len(data)))
    output.write(tag)
    output.write(data)
    output.write(struct.pack("!I", 0xFFFFFFFF & zlib.crc32(data, zlib.crc32(tag))))


def write_png(image: np.ndarray, output: BinaryIO | None = None) -> BinaryIO:
    """Encode a float [0,1] or uint8 (h, w, 4) image as PNG."""
    if image.dtype != np.uint8:
        image = np.round(np.asarray(image, dtype=np.float64) * 255.0).astype(np.uint8)
    height, width = image.shape[:2]

    # prepend the per-row filter byte (filter 0 = None) and compress in one shot
    rows = np.zeros((height, 1 + width * 4), dtype=np.uint8)
    rows[:, 1:] = image.reshape(height, -1)
    idat = zlib.compress(rows.tobytes(), level=9)

    output = io.BytesIO() if output is None else output
    output.write(_SIGNATURE)
    _chunk(output, b"IHDR", struct.pack("!2I5B", width, height, 8, 6, 0, 0, 0))
    _chunk(output, b"IDAT", idat)
    _chunk(output, b"IEND", b"")
    return output


def read_png(data: bytes | BinaryIO) -> np.ndarray:
    """Decode an 8-bit PNG into a uint8 (h, w, 4) RGBA array."""
    if hasattr(data, "read"):
        data = data.read()
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")

    pos = 8
    width = height = None
    color_type = bit_depth = None
    idat = io.BytesIO()
    palette = None
    while pos < len(data):
        (length,) = struct.unpack("!I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack("!2I5B", body)
            if bit_depth != 8 or interlace != 0:
                raise NotImplementedError("only 8-bit non-interlaced PNGs supported")
        elif tag == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.write(body)
        elif tag == b"IEND":
            break

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(idat.getvalue()), dtype=np.uint8)
    stride = width * channels
    raw = raw.reshape(height, 1 + stride)
    filters, scan = raw[:, 0], raw[:, 1:].astype(np.int32)

    out = np.zeros((height, stride), dtype=np.int32)
    bpp = channels
    for r in range(height):
        line = scan[r].copy()
        prev = out[r - 1] if r > 0 else np.zeros(stride, dtype=np.int32)
        f = filters[r]
        if f == 0:
            out[r] = line
        elif f == 2:  # Up
            out[r] = (line + prev) & 0xFF
        elif f in (1, 3, 4):  # Sub / Average / Paeth need sequential recon
            rec = out[r]
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if f == 1:
                    val = line[i] + a
                elif f == 3:
                    val = line[i] + (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    val = line[i] + pred
                rec[i] = val & 0xFF
        else:
            raise ValueError(f"invalid PNG filter {f}")

    image = out.astype(np.uint8).reshape(height, width, channels)
    if color_type == 3:
        if palette is None:
            raise ValueError("paletted PNG without PLTE")
        image = palette[image[..., 0]]
        channels = 3
    if channels == 1:
        image = np.repeat(image, 3, axis=2)
        channels = 3
    elif channels == 2:
        gray, alpha = image[..., :1], image[..., 1:]
        image = np.concatenate([np.repeat(gray, 3, axis=2), alpha], axis=2)
        channels = 4
    if channels == 3:
        alpha = np.full((height, width, 1), 255, dtype=np.uint8)
        image = np.concatenate([image, alpha], axis=2)
    return image
