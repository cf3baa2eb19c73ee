"""Losses: REINFORCE with learned baselines, entropy bonuses, masked
multi-turn averaging, NLL classification, baseline MSE regression.

Parity target: ``multimodalgame_tpu/game/losses.py`` (reference
model.py:571-577 and 879-988). Every function takes dense stacked
``(T, B, ...)`` tensors with ``(T, B, 1)`` masks instead of the
reference's ragged lists; turns after a virtual early break have all-zero
masks and add exactly zero to both numerator and denominator.

Rewards, baseline scores and sampled features are detached inside the
functions, as the reference re-wraps them (model.py:908-913): gradients
flow only through the probabilities, the class scores and the baseline
scores of the MSE losses.

As in the JAX package, a masked subset of one row or fewer has an
advantage std of 0 (no normalization), where the reference's torch
unbiased std would give NaN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-8


def loglikelihood(log_prob: torch.Tensor, target: torch.Tensor
                  ) -> torch.Tensor:
    """Per-example ``log_prob[b, target[b]]`` -> ``(B, 1)``
    (model.py:571-577)."""
    return torch.gather(log_prob, 1, target.reshape(-1, 1).long())


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


def _masked_unbiased_std(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Unbiased (N-1) std over the rows where ``m == 1``; 0 when fewer
    than two rows are selected."""
    n = m.sum()
    mean = (x * m).sum() / torch.clamp(n, min=1.0)
    var = (m * (x - mean) ** 2).sum() / torch.clamp(n - 1.0, min=1.0)
    return torch.where(n > 1, torch.sqrt(var), torch.zeros_like(var))


def calculate_loss_binary(binary_features: torch.Tensor,
                          binary_probs: torch.Tensor,
                          logs: torch.Tensor,
                          baseline_scores: torch.Tensor,
                          entropy_penalty: Optional[float],
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One turn's REINFORCE loss and two-sided negentropy
    (model.py:907-927; the masked form folds in the row selection of
    ``multistep_loss_binary``'s mapped_fn, model.py:932-945).

    Shapes: features and probs ``(B, W)``, logs and scores ``(B, 1)``,
    mask ``(B, 1)``. Returns ``(loss, negentropy)`` scalars.
    """
    feats = binary_features.detach()
    p = binary_probs
    log_p_z = (feats * torch.log(p + EPS)
               + (1.0 - feats) * torch.log(1.0 - p + EPS)).sum(-1)   # (B,)
    weight = (logs - baseline_scores).detach()[:, 0]                  # (B,)
    batch = binary_features.shape[0]
    per_row_negent = ((torch.log(p + EPS) * p).sum(-1)
                      + (torch.log((1.0 - p) + EPS) * (1.0 - p)).sum(-1))

    if mask is None:
        if batch > 1:  # the reference's ``logs.size(0) > 1`` (model.py:914)
            weight = weight / torch.clamp(weight.std(), min=1.0)
        loss = (-weight * log_p_z).mean()
        negentropy = per_row_negent.mean()
        if entropy_penalty is not None:
            loss = loss + entropy_penalty * negentropy
        return loss, negentropy

    m = mask[:, 0]
    n = m.sum()
    denom = torch.clamp(n, min=1.0)
    if batch > 1:
        weight = weight / torch.clamp(_masked_unbiased_std(weight, m),
                                      min=1.0)
    loss = (m * (-weight * log_p_z)).sum() / denom
    negentropy = (m * per_row_negent).sum() / denom
    if entropy_penalty is not None:
        loss = loss + entropy_penalty * negentropy
    # Zero-mask turns contribute exactly zero (the reference's mapped_fn
    # early return, model.py:933-934).
    zero = torch.zeros_like(loss)
    return torch.where(n > 0, loss, zero), torch.where(n > 0, negentropy,
                                                       zero)


def multistep_loss_binary(binary_features: torch.Tensor,
                          binary_probs: torch.Tensor,
                          logs: torch.Tensor,
                          baseline_scores: torch.Tensor,
                          masks: Optional[torch.Tensor],
                          entropy_penalty: Optional[float]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-weighted combination of per-turn REINFORCE losses
    (model.py:930-968): ``sum_t loss_t n_t / sum_t n_t``, or the plain
    mean over turns when ``masks`` is ``None`` (fixed exchange).

    Args are stacked ``(T', B, ...)``. Returns ``(loss, negentropies
    (T',))``.
    """
    turns = binary_features.shape[0]
    per_turn = [calculate_loss_binary(
        binary_features[t], binary_probs[t], logs, baseline_scores[t],
        entropy_penalty, None if masks is None else masks[t])
        for t in range(turns)]
    losses = torch.stack([lo for lo, _ in per_turn])
    negents = torch.stack([ne for _, ne in per_turn])
    if masks is None:
        return losses.sum() / turns, negents
    mask_sums = masks.sum(dim=(1, 2))
    return ((losses * mask_sums).sum()
            / torch.clamp(mask_sums.sum(), min=1.0)), negents


def calculate_loss_bas(baseline_scores: torch.Tensor, logs: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE of baseline scores against the detached rewards
    (model.py:971-973)."""
    sq = (baseline_scores - logs.detach()) ** 2                       # (B, 1)
    if mask is None:
        return sq.mean()
    n = mask.sum()
    loss = (sq * mask).sum() / torch.clamp(n, min=1.0)
    return torch.where(n > 0, loss, torch.zeros_like(loss))


def multistep_loss_bas(baseline_scores: torch.Tensor, logs: torch.Tensor,
                       masks: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask-weighted multi-turn baseline loss (model.py:976-988)."""
    turns = baseline_scores.shape[0]
    losses = torch.stack([calculate_loss_bas(
        baseline_scores[t], logs, None if masks is None else masks[t])
        for t in range(turns)])
    if masks is None:
        return losses.sum() / turns
    mask_sums = masks.sum(dim=(1, 2))
    return (losses * mask_sums).sum() / torch.clamp(mask_sums.sum(), min=1.0)


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood, ``nn.NLLLoss`` on log-softmax scores
    (model.py:1271)."""
    return -loglikelihood(log_probs, target).mean()


def topk_accuracy(dist: torch.Tensor, target: torch.Tensor, k: int,
                  denom: int) -> torch.Tensor:
    """Top-k accuracy (model.py:1332-1338): the targets among the k
    highest-scoring classes, over the *configured* batch size ``denom``.

    Counts rank with a strict ``>`` (the target is a top-k member iff
    fewer than k classes score strictly higher), as the JAX package does:
    ``torch.topk`` would break ties by position instead. ``k`` is clamped
    to the class count."""
    k_eff = min(k, dist.shape[-1])
    tscore = torch.gather(dist, -1, target.reshape(-1, 1).long())
    rank = (dist > tscore).sum(-1)
    return (rank < k_eff).sum().to(dist.dtype) / denom
