"""Message quantization.

Eval mode rounds probabilities to bits deterministically; sampling for
training is not ported yet.
"""

from __future__ import annotations

import torch


def hard_round(probs: torch.Tensor) -> torch.Tensor:
    """``floor(p + 0.5)``: half rounds up, as the reference's
    ``torch.round`` did in its PyTorch version (model.py:229, 427, 462).
    Today's ``torch.round`` rounds half to even, so it is not used."""
    return torch.floor(probs + 0.5).detach()
