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

from typing import List, Optional, Sequence, Tuple

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


def _masked_unbiased_std(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Unbiased (N-1) std over the rows where ``m == 1``; 0 when fewer
    than two rows are selected."""
    n = m.sum()
    mean = (x * m).sum() / torch.clamp(n, min=1.0)
    var = (m * (x - mean) ** 2).sum() / torch.clamp(n - 1.0, min=1.0)
    return torch.where(n > 1, torch.sqrt(var), torch.zeros_like(var))


def global_turn_stats(weights: Sequence[torch.Tensor],
                      masks: Optional[Sequence[torch.Tensor]], reduce
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each turn's global ``(n, std)`` over the ranks: the row count
    (``masks[t].sum()``, or the global batch unmasked) and the unbiased
    std of ``weights[t]`` over those rows, exact, in two collectives for
    every turn: the counts and sums, then the squared deviations about
    the global means. ``weights[t]`` and ``masks[t]`` are ``(B,)``."""
    w = torch.stack([x.detach() for x in weights])                  # (T, B)
    m = (torch.ones_like(w) if masks is None
         else torch.stack([x.detach() for x in masks]))
    n, s1 = reduce.sum(torch.stack([m.sum(-1), (w * m).sum(-1)])).unbind(0)
    mean = s1 / torch.clamp(n, min=1.0)
    s2 = reduce.sum((m * (w - mean[:, None]) ** 2).sum(-1))
    std = torch.where(n > 1, torch.sqrt(s2 / torch.clamp(n - 1.0, min=1.0)),
                      torch.zeros_like(s2))
    return list(zip(n.unbind(0), std.unbind(0)))


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
    """One turn's REINFORCE loss and two-sided negentropy
    (model.py:907-927; the masked form folds in the row selection of
    ``multistep_loss_binary``'s mapped_fn, model.py:932-945).

    Shapes: features and probs ``(B, W)``, logs and scores ``(B, 1)``,
    mask ``(B, 1)``. Returns ``(loss, negentropy)`` scalars. On the mesh
    (``reduce``), ``stat`` is the turn's global ``(n, std)``
    (:func:`global_turn_stats`, taken here when not given) and the
    results are this rank's shares.
    """
    feats = binary_features.detach()
    p = binary_probs
    log_p_z = (feats * torch.log(p + EPS)
               + (1.0 - feats) * torch.log(1.0 - p + EPS)).sum(-1)   # (B,)
    weight = (logs - baseline_scores).detach()[:, 0]                  # (B,)
    batch = binary_features.shape[0]
    per_row_negent = ((torch.log(p + EPS) * p).sum(-1)
                      + (torch.log((1.0 - p) + EPS) * (1.0 - p)).sum(-1))

    m = None if mask is None else mask[:, 0]
    if reduce is not None:
        batch *= reduce.size
        if stat is None:
            stat = global_turn_stats([weight], None if m is None else [m],
                                     reduce)[0]

    if mask is None:
        if batch > 1:  # the reference's ``logs.size(0) > 1`` (model.py:914)
            std = weight.std() if stat is None else stat[1]
            weight = weight / torch.clamp(std, min=1.0)
        loss = _batch_mean(-weight * log_p_z, reduce)
        negentropy = _batch_mean(per_row_negent, reduce)
        if entropy_penalty is not None:
            loss = loss + entropy_penalty * negentropy
        return loss, negentropy

    n = m.sum() if stat is None else stat[0]
    denom = torch.clamp(n, min=1.0)
    if batch > 1:
        std = _masked_unbiased_std(weight, m) if stat is None else stat[1]
        weight = weight / torch.clamp(std, min=1.0)
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
                          entropy_penalty: Optional[float],
                          reduce=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-weighted combination of per-turn REINFORCE losses
    (model.py:930-968): ``sum_t loss_t n_t / sum_t n_t``, or the plain
    mean over turns when ``masks`` is ``None`` (fixed exchange).

    Args are stacked ``(T', B, ...)``. Returns ``(loss, negentropies
    (T',))``; on the mesh (``reduce``) this rank's shares, with the
    turns' global statistics taken in two collectives.
    """
    turns = binary_features.shape[0]
    stats = [None] * turns
    if reduce is not None:
        stats = global_turn_stats(
            [(logs - baseline_scores[t]).detach()[:, 0]
             for t in range(turns)],
            None if masks is None else [masks[t][:, 0]
                                        for t in range(turns)], reduce)
    per_turn = [calculate_loss_binary(
        binary_features[t], binary_probs[t], logs, baseline_scores[t],
        entropy_penalty, None if masks is None else masks[t], reduce,
        stats[t]) for t in range(turns)]
    losses = torch.stack([lo for lo, _ in per_turn])
    negents = torch.stack([ne for _, ne in per_turn])
    if masks is None:
        return losses.sum() / turns, negents
    mask_sums = (masks.sum(dim=(1, 2)) if reduce is None
                 else torch.stack([n for n, _ in stats]))
    return ((losses * mask_sums).sum()
            / torch.clamp(mask_sums.sum(), min=1.0)), negents


def calculate_loss_bas(baseline_scores: torch.Tensor, logs: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, reduce=None,
                       n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE of baseline scores against the detached rewards
    (model.py:971-973). On the mesh (``reduce``) this rank's share, over
    the global mask count ``n`` (taken here when not given)."""
    sq = (baseline_scores - logs.detach()) ** 2                       # (B, 1)
    if mask is None:
        return _batch_mean(sq, reduce)
    if n is None:
        n = mask.sum() if reduce is None else reduce.sum(mask.sum())
    loss = (sq * mask).sum() / torch.clamp(n, min=1.0)
    return torch.where(n > 0, loss, torch.zeros_like(loss))


def multistep_loss_bas(baseline_scores: torch.Tensor, logs: torch.Tensor,
                       masks: Optional[torch.Tensor],
                       reduce=None) -> torch.Tensor:
    """Mask-weighted multi-turn baseline loss (model.py:976-988); on the
    mesh (``reduce``) this rank's share, the turns' global mask counts
    taken in one collective."""
    turns = baseline_scores.shape[0]
    counts = [None] * turns
    if reduce is not None and masks is not None:
        counts = reduce.sum(masks.detach().sum(dim=(1, 2))).unbind(0)
    losses = torch.stack([calculate_loss_bas(
        baseline_scores[t], logs, None if masks is None else masks[t],
        reduce, counts[t]) for t in range(turns)])
    if masks is None:
        return losses.sum() / turns
    mask_sums = (masks.sum(dim=(1, 2)) if reduce is None
                 else torch.stack(counts))
    return (losses * mask_sums).sum() / torch.clamp(mask_sums.sum(), min=1.0)


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
