"""Masked prediction selection (reference model.py:879-904).

Only :func:`get_rec_outp`, which serving needs, is ported so far.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-8


def get_rec_outp(y: torch.Tensor, y_masks: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select each example's prediction at the turn it stopped.

    Args:
        y: per-turn class scores ``(T, B, D)``.
        y_masks: ``(T, B, 1)`` one-hot-over-T selection masks, or ``None``
            for fixed exchanges (-> the last turn's scores).

    Returns ``(outp (B, D), negentropy (T,))``; the negentropy is the
    batch-mean ``sum_d p log p`` per turn over the full batch, the
    reference's own approximation (model.py:884-886).
    """
    probs = torch.softmax(y, dim=-1)
    negent = (torch.log(probs + EPS) * probs).sum(-1).mean(-1)
    if y_masks is None:
        return y[-1], negent
    outp = (y * y_masks.detach()).sum(0)
    return outp, negent
