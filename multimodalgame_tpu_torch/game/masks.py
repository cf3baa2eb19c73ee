"""Stop-mask algebra and channel-corruption masks.

The exchange always runs ``max_exchange`` turns and carries termination
in the masks (see ``multimodalgame_tpu/game/masks.py``); the y-mask picks,
per example, the turn at which it stopped (model.py:1247-1262).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class LossMasks:
    """Per-loss mask stacks derived from the stop-mask chain, shapes
    ``(T[, -1], B, 1)`` (reference model.py:1247-1262)."""
    binary_s: torch.Tensor     # s_masks[:-1]  — pre-step masks, (T, B, 1)
    binary_rec: torch.Tensor   # s_masks[1:-1] — (T-1, B, 1)
    binary_sen: torch.Tensor   # s_masks[:-1]
    bas_rec: torch.Tensor      # s_masks[:-1]
    bas_sen: torch.Tensor      # s_masks[:-1]
    y: torch.Tensor            # min(1 - m_{t+1}, m_t) — (T, B, 1)


def assemble_loss_masks(stop_masks: torch.Tensor) -> LossMasks:
    """The five loss-mask views of the ``(T+1, B, 1)`` stop-mask chain
    (``stop_masks[0]`` all ones, ``stop_masks[-1]`` forced to zero,
    model.py:775, 870)."""
    pre = stop_masks[:-1]
    post = stop_masks[1:]
    return LossMasks(
        binary_s=pre,
        binary_rec=stop_masks[1:-1],
        binary_sen=pre,
        bas_rec=pre,
        bas_sen=pre,
        y=torch.minimum(1.0 - post, pre),
    )


def build_mask(region_str: str, size: int) -> np.ndarray:
    """Parse a bit-region spec like ``"0:3,5"`` into a 0/1 vector of
    length ``size`` (reference misc.py:388-402; half-open ranges)."""
    regions = [r.split(":") for r in region_str.split(",")]
    regions = [[int(r[0])] if len(r) == 1 else
               list(range(int(r[0]), int(r[1]))) for r in regions]
    index = list(itertools.chain(*regions))
    mask = np.zeros((size,), dtype=np.float32)
    mask[index] = 1.0
    return mask


def corrupt_message(z_binary: torch.Tensor,
                    corrupt_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Flip the masked bits of a binary message: ``|z - mask|``
    (model.py:814-820)."""
    if corrupt_mask is None:
        return z_binary
    return torch.abs(z_binary - corrupt_mask[None, :])
