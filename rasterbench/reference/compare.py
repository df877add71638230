"""The comparison that decides `correct`: a frame against the reference.

- mean_gap: the mean absolute gap over every pixel and channel;
- block_gap: the largest mean absolute gap over one block of block x block
  pixels (a tile's worth of wrong pixels shows here, where the frame's mean
  would dilute it);
- max_gap: the widest gap of one channel of one pixel.  It is printed and
  not compared: a pixel astride a curve's edge or a repeating gradient's
  wrap swings by the program's flattening tolerance whatever else is right.

A gap that is not a number counts as infinite.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaps(frame: torch.Tensor, ref: torch.Tensor, block: int) -> dict:
    gap = torch.nan_to_num((frame.float() - ref.float()).abs(), nan=float("inf"))
    per_pixel = gap.mean(-1)
    blocks = F.avg_pool2d(per_pixel[None, None], block, ceil_mode=True)
    return {
        "mean_gap": float(per_pixel.mean()),
        "block_gap": float(blocks.max()),
        "max_gap": float(gap.max()),
    }
