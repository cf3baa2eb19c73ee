"""Losses: REINFORCE with learned baselines, entropy bonuses, masked
multi-turn averaging, NLL classification, baseline MSE regression.

Parity target: ``multimodalgame_tpu/game/losses.py`` (reference
model.py:571-577 and 879-988). Every function takes dense stacked
``(T, B, ...)`` tensors with ``(T, B, 1)`` masks instead of the
reference's ragged lists; turns after a virtual early break have all-zero
masks and add exactly zero to both numerator and denominator. A
multi-turn loss computes all its turns in one pass over the stack, every
reduction over the batch (and width) axes alone, as the JAX package's
``vmap`` over the turns does: the number of operators it runs does not
grow with the turns.

Rewards, baseline scores and sampled features are detached inside the
functions, as the reference re-wraps them (model.py:908-913): gradients
flow only through the probabilities, the class scores and the baseline
scores of the MSE losses.

As in the JAX package, a masked subset of one row or fewer has an
advantage std of 0 (no normalization), where the reference's torch
unbiased std would give NaN.

**Data parallelism.** Every statistic over the batch is batch-global:
the advantages' unbiased std, the per-turn mask counts that divide the
losses and gate them, the turns' weights, and the batch means. Under
JAX's SPMD they become collectives by themselves (JAX
parallel/mesh.py:12-16); here a rank holds only its rows, so each
function takes ``reduce``: ``None`` off the mesh (the single-device code
path, unchanged), else an object whose ``sum(x)`` is the sum of a
detached tensor over the ranks and whose ``size`` is the number of
ranks (``parallel/mesh.py:Mesh``). The statistics are free of
gradients (advantages and masks are detached), so on the mesh they are
taken exactly (the counts and the std's two passes, a sum and then a sum
of squared deviations about the global mean, each one collective for
all turns), and each rank's loss is its rows' numerator over the global
denominator: the ranks' losses sum to the single-device loss, and their
gradients, summed by one all-reduce, to its gradient up to the order of
summation. A rank's returned losses and negentropies are its shares;
the trainer sums them over the ranks before they are logged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-8


def _batch_mean(x: torch.Tensor, reduce, dim: Optional[int] = None
                ) -> torch.Tensor:
    """The mean of ``x`` over its batch axis ``dim`` (every axis when
    ``None``, for ``(B,)`` and ``(B, 1)`` rows): ``x.mean`` off the mesh,
    else this rank's share of the global mean (its rows' sum over the
    global row count)."""
    if reduce is None:
        return x.mean() if dim is None else x.mean(dim)
    if dim is None:
        return x.sum() / (x.numel() * reduce.size)
    return x.sum(dim) / (x.shape[dim] * reduce.size)


def loglikelihood(log_prob: torch.Tensor, target: torch.Tensor
                  ) -> torch.Tensor:
    """Per-example ``log_prob[b, target[b]]`` -> ``(B, 1)``
    (model.py:571-577)."""
    return torch.gather(log_prob, 1, target.reshape(-1, 1).long())


def get_rec_outp(y: torch.Tensor, y_masks: Optional[torch.Tensor],
                 reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select each example's prediction at the turn it stopped.

    Args:
        y: per-turn class scores ``(T, B, D)``.
        y_masks: ``(T, B, 1)`` one-hot-over-T selection masks, or ``None``
            for fixed exchanges (-> the last turn's scores).

    Returns ``(outp (B, D), negentropy (T,))``; the negentropy is the
    batch-mean ``sum_d p log p`` per turn over the full batch, the
    reference's own approximation (model.py:884-886); on the mesh, this
    rank's share of it.
    """
    probs = torch.softmax(y, dim=-1)
    negent = _batch_mean((torch.log(probs + EPS) * probs).sum(-1), reduce,
                         dim=-1)
    if y_masks is None:
        return y[-1], negent
    outp = (y * y_masks.detach()).sum(0)
    return outp, negent


def turn_stats(weights: torch.Tensor, masks: Optional[torch.Tensor],
               reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each turn's ``(n, std)``: the row count (``masks.sum(-1)``, or the
    batch unmasked) and the unbiased (N-1) std of ``weights`` over those
    rows, 0 where fewer than two rows are selected. ``weights`` and
    ``masks`` are ``(..., B)``; the results ``(...)``. On the mesh
    (``reduce``) both are global over the ranks, exact, in two
    collectives for all turns: the counts and sums, then the squared
    deviations about the global means."""
    w = weights.detach()
    m = torch.ones_like(w) if masks is None else masks.detach()
    n, s1 = m.sum(-1), (w * m).sum(-1)
    if reduce is not None:
        n, s1 = reduce.sum(torch.stack([n, s1])).unbind(0)
    mean = s1 / torch.clamp(n, min=1.0)
    s2 = (m * (w - mean[..., None]) ** 2).sum(-1)
    if reduce is not None:
        s2 = reduce.sum(s2)
    std = torch.where(n > 1, torch.sqrt(s2 / torch.clamp(n - 1.0, min=1.0)),
                      torch.zeros_like(s2))
    return n, std


def calculate_loss_binary(binary_features: torch.Tensor,
                          binary_probs: torch.Tensor,
                          logs: torch.Tensor,
                          baseline_scores: torch.Tensor,
                          entropy_penalty: Optional[float],
                          mask: Optional[torch.Tensor] = None,
                          reduce=None,
                          stat: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The REINFORCE loss and two-sided negentropy of one turn, or of
    every turn of a stack at once (model.py:907-927; the masked form folds
    in the row selection of ``multistep_loss_binary``'s mapped_fn,
    model.py:932-945).

    Shapes: features and probs ``(..., B, W)``, logs ``(B, 1)``, scores
    and mask ``(..., B, 1)``; the leading axes (the turns, or none) are
    kept, every reduction is over the batch and the width, as the JAX
    package's ``vmap`` over the turns computes them. Returns ``(loss,
    negentropy)`` of shape ``(...)``. ``stat`` is the turns' ``(n, std)``
    (:func:`turn_stats`, taken here when not given and needed); on the
    mesh (``reduce``) they are global and the results are this rank's
    shares.
    """
    feats = binary_features.detach()
    p = binary_probs
    q = 1.0 - p
    log_p, log_q = torch.log(p + EPS), torch.log(q + EPS)
    log_p_z = (feats * log_p + (1.0 - feats) * log_q).sum(-1)     # (..., B)
    per_row_negent = (log_p * p + log_q * q).sum(-1)               # (..., B)
    weight = (logs - baseline_scores).detach()[..., 0]             # (..., B)
    batch = binary_features.shape[-2]
    m = None if mask is None else mask[..., 0]
    if reduce is not None:
        batch *= reduce.size
    if stat is None and (m is not None or reduce is not None):
        stat = turn_stats(weight, m, reduce)

    if mask is None:
        if batch > 1:  # the reference's ``logs.size(0) > 1`` (model.py:914)
            std = weight.std(-1) if stat is None else stat[1]
            weight = weight / torch.clamp(std, min=1.0)[..., None]
        loss = _batch_mean(-weight * log_p_z, reduce, dim=-1)
        negentropy = _batch_mean(per_row_negent, reduce, dim=-1)
        if entropy_penalty is not None:
            loss = loss + entropy_penalty * negentropy
        return loss, negentropy

    n, std = stat
    denom = torch.clamp(n, min=1.0)
    if batch > 1:
        weight = weight / torch.clamp(std, min=1.0)[..., None]
    loss = (m * (-weight * log_p_z)).sum(-1) / denom
    negentropy = (m * per_row_negent).sum(-1) / denom
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
                          entropy_penalty: Optional[float],
                          reduce=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-weighted combination of per-turn REINFORCE losses
    (model.py:930-968): ``sum_t loss_t n_t / sum_t n_t``, or the plain
    mean over turns when ``masks`` is ``None`` (fixed exchange).

    Args are stacked ``(T', B, ...)`` and every turn is computed in one
    call of :func:`calculate_loss_binary`. Returns ``(loss, negentropies
    (T',))``; on the mesh (``reduce``) this rank's shares, with the
    turns' global statistics taken in two collectives.
    """
    stat = None
    if masks is not None or reduce is not None:
        stat = turn_stats((logs - baseline_scores)[..., 0],
                          None if masks is None else masks[..., 0], reduce)
    losses, negents = calculate_loss_binary(
        binary_features, binary_probs, logs, baseline_scores,
        entropy_penalty, masks, reduce, stat)
    if masks is None:
        return losses.sum() / binary_features.shape[0], negents
    n = stat[0]
    return (losses * n).sum() / torch.clamp(n.sum(), min=1.0), negents


def calculate_loss_bas(baseline_scores: torch.Tensor, logs: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, reduce=None,
                       n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE of baseline scores against the detached rewards
    (model.py:971-973), of one turn or of every turn of a stack: scores
    and mask ``(..., B, 1)``, logs ``(B, 1)``, the result ``(...)``. On
    the mesh (``reduce``) this rank's share, over the global mask counts
    ``n`` (taken here when not given)."""
    sq = (baseline_scores - logs.detach()) ** 2                   # (..., B, 1)
    if mask is None:
        return _batch_mean(sq[..., 0], reduce, dim=-1)
    if n is None:
        n = mask.sum((-2, -1))
        if reduce is not None:
            n = reduce.sum(n)
    loss = (sq * mask).sum((-2, -1)) / torch.clamp(n, min=1.0)
    return torch.where(n > 0, loss, torch.zeros_like(loss))


def multistep_loss_bas(baseline_scores: torch.Tensor, logs: torch.Tensor,
                       masks: Optional[torch.Tensor],
                       reduce=None) -> torch.Tensor:
    """Mask-weighted multi-turn baseline loss (model.py:976-988), every
    turn in one call of :func:`calculate_loss_bas`; on the mesh
    (``reduce``) this rank's share, the turns' global mask counts taken
    in one collective."""
    if masks is None:
        losses = calculate_loss_bas(baseline_scores, logs, None, reduce)
        return losses.sum() / baseline_scores.shape[0]
    n = masks.detach().sum((1, 2))
    if reduce is not None:
        n = reduce.sum(n)
    losses = calculate_loss_bas(baseline_scores, logs, masks, reduce, n)
    return (losses * n).sum() / torch.clamp(n.sum(), min=1.0)


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor,
             reduce=None) -> torch.Tensor:
    """Mean negative log-likelihood, ``nn.NLLLoss`` on log-softmax scores
    (model.py:1271); on the mesh (``reduce``) this rank's share."""
    ll = loglikelihood(log_probs, target)
    return -_batch_mean(ll, reduce)


def topk_accuracy(dist: torch.Tensor, target: torch.Tensor, k: int,
                  denom: int) -> torch.Tensor:
    """Top-k accuracy (model.py:1332-1338): the targets among the k
    highest-scoring classes, over the *configured* batch size ``denom``.

    Counts rank with a strict ``>`` (the target is a top-k member iff
    fewer than k classes score strictly higher), as the JAX package does:
    ``torch.topk`` would break ties by position instead. ``k`` is clamped
    to the class count. ``denom`` is the whole batch's, so on the mesh a
    rank's count over it is its share of the accuracy."""
    k_eff = min(k, dist.shape[-1])
    tscore = torch.gather(dist, -1, target.reshape(-1, 1).long())
    rank = (dist > tscore).sum(-1)
    return (rank < k_eff).sum().to(dist.dtype) / denom
