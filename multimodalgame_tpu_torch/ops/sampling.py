"""Message quantization and sampling.

Eval mode rounds probabilities to bits deterministically. Training draws
Bernoulli bits as ``u < p`` from pre-drawn uniforms ``u``, as the JAX
package's ``ops/sampling.py`` does: the uniforms come from the caller (a
test replaying JAX's draws, or ``ops/philox.py``), so the same uniforms
give the same bits in every path.
"""

from __future__ import annotations

from typing import Dict

import torch


def uniform_widths(cfg, train: bool) -> Dict[str, int]:
    """The uniform sets a conversation of ``cfg`` consumes, with their
    widths (game/exchange.py:169-180): ``s``, ``z`` and ``w`` in training
    (``s`` alone with a continuous channel), and the flipout sets ``fz``
    and ``fw`` in training or, with ``flipout_dev``, in eval."""
    widths = {}
    if train:
        widths["s"] = cfg.rec_s_dim
        if cfg.use_binary:
            widths["z"] = cfg.sender_out_dim
            widths["w"] = cfg.rec_w_dim
    if cfg.use_binary and (train or cfg.flipout_dev):
        if cfg.flipout_sen is not None:
            widths["fz"] = cfg.sender_out_dim
        if cfg.flipout_rec is not None:
            widths["fw"] = cfg.rec_w_dim
    return widths


def hard_round(probs: torch.Tensor) -> torch.Tensor:
    """``floor(p + 0.5)``: half rounds up, as the reference's
    ``torch.round`` did in its PyTorch version (model.py:229, 427, 462).
    Today's ``torch.round`` rounds half to even, so it is not used."""
    return torch.floor(probs + 0.5).detach()


def bernoulli_from_uniform(u: torch.Tensor, probs: torch.Tensor
                           ) -> torch.Tensor:
    """0/1 bits with ``P(1) = probs``: ``u < probs``, compared in the
    uniforms' dtype (f32 or wider), returned in ``probs``' dtype and
    detached (the reference re-wraps samples as fresh Variables)."""
    return (u < probs.detach().to(u.dtype)).to(probs.dtype)


def flipout_from_uniform(u: torch.Tensor, binary: torch.Tensor,
                         p: float) -> torch.Tensor:
    """Flip each bit where ``u < p`` (reference ``flipout``,
    model.py:554-568): ``|binary - mask|``."""
    mask = bernoulli_from_uniform(u, torch.full_like(binary, p))
    return torch.abs(binary - mask)
