"""Fill-rule mapping from winding fields to coverage masks: the twin of the
JAX package's ops/fill_rule.py.

Same formulas as the reference (svgrasterize.py:984-990): nonzero clamps the
absolute winding, evenodd folds it with a triangle wave; sub-1e-6 values are
rounded down to zero so fully-empty pixels stay exactly empty.
"""

from __future__ import annotations

import torch

NONZERO = "nonzero"
EVENODD = "evenodd"


def apply(winding, fill_rule: str | None = None):
    if fill_rule is None or fill_rule == NONZERO:
        mask = torch.clamp(torch.abs(winding), 0.0, 1.0)
    elif fill_rule == EVENODD:
        mask = torch.abs(torch.remainder(winding + 1.0, 2.0) - 1.0)
    else:
        raise ValueError(f"invalid fill rule: {fill_rule}")
    return torch.where(mask < 1e-6, torch.zeros_like(mask), mask)
