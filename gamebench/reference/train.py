"""The reference's training readings: a few updates of a game from a
given state, what a trainer's checked steps should give.

The program's trainer takes its checked steps in two calls of its driver,
from a step ``start`` that is a log step: step ``start`` alone (its log
shows every row's sampled bits, and a dev sweep follows it), then the
next ``steps - 1`` (each call's batch plan starts again at epoch 0's
first batch, so the ``t``-th checked step trains on batch ``t - 1``). The
reference takes the same steps on the same rows from the same weights
and RMSprop state. At the first it takes the trainer's bits and judges
each against its own Philox draw (keyed by ``(seed, step)``), so that its
losses, gradients and update are those of the same conversation; later
steps draw their own bits. It reads what the program's run shows: the
first step's bits, its six logged losses and each leaf's clipped
gradient, the dev sweep's accuracy after it, and each leaf's change over
all the steps.
"""

from typing import Dict, List, Optional

import torch

from gamebench.reference.game import dev_accuracy, train_step
from gamebench.reference.plan import epoch_batches


def step_rows(n_rows: int, batch: int, steps: int):
    """The plan rows of each checked step, as the two driver calls take
    them."""
    plan = epoch_batches(n_rows, 0, True, batch)
    return [plan[0]] + [plan[t - 1] for t in range(1, steps)]


def follow(cfg: dict, sets: dict, weights: Dict[str, torch.Tensor],
           seed: int, steps: int, prec: str = "f32",
           fault: Optional[str] = None, forced: Optional[dict] = None,
           start: int = 0, nu: Optional[Dict[str, torch.Tensor]] = None,
           flip=frozenset(), dev: bool = True) -> dict:
    """The readings of ``steps`` updates from step ``start``, ``weights``
    and RMSprop state ``nu`` (zeros where None; neither is changed): the
    first on ``forced`` (a trainer's bits) where given; the products in
    ``prec`` (the control's lower precision) or with a planted ``fault``:
    ``half`` (half of each batch left out), ``flip`` (one message bit of
    row 0 flipped where it is drawn), ``frozen`` (the state left
    unchanged). The draws at each ``(step, turn, name, row, unit)`` of
    ``flip`` go the other way; ``ties`` lists the draws that lie within
    ``TIE`` of their probability as ``(distance, step, turn, name, row,
    unit)``. With ``dev`` False the dev sweep is left out."""
    P = {k: v.detach().clone() for k, v in weights.items()}
    nu = {k: (torch.zeros_like(v) if nu is None else nu[k].detach().clone())
          for k, v in P.items()}
    train, dev_set = sets["train"], sets["dev"]
    obs = {"ties": []}
    for t, rows in enumerate(step_rows(train["labels"].shape[0],
                                       cfg["batch_size"], steps)):
        rows = torch.as_tensor(rows, device=train["feats"].device)
        ctx = None if train["ctx"] is None else train["ctx"][rows]
        out = train_step(P, nu, cfg, train["feats"][rows],
                         train["labels"][rows], sets["desc"], ctx, seed,
                         start + t, prec=prec, fault=fault,
                         forced=forced if t == 0 else None,
                         flip={f[1:] for f in flip if f[0] == t})
        obs["ties"] += [(d, t) + tuple(rest) for d, *rest in out["ties"]]
        if t == 0:
            obs.update(losses=out["losses"], grad_norms=out["grad_norms"],
                       bits=out["bits"], bit_gap=out["bit_gap"])
            if dev:
                batches = epoch_batches(dev_set["labels"].shape[0], 0, False,
                                        cfg["batch_size_dev"],
                                        keep_tail=True)
                obs["dev_acc"] = dev_accuracy(
                    P, cfg, dev_set["feats"], dev_set["labels"],
                    sets["desc"], batches, dev_set["ctx"], cfg["top_k_dev"],
                    prec=prec)
    obs["change_norms"] = {k: float((P[k] - weights[k]).double().norm())
                           for k in P}
    return obs


def follow_branches(cfg: dict, sets: dict, weights: Dict[str, torch.Tensor],
                    seed: int, steps: int, **kw) -> List[dict]:
    """:func:`follow`'s readings, then the same steps again with each of
    its ``BRANCHES`` nearest ties taken the other way, one at a time: the
    trajectories a float32 program can take where a draw falls between
    its probability and the reference's. The first is the reference's
    own; the others share its first step's readings."""
    base = follow(cfg, sets, weights, seed, steps, **kw)
    out = [base]
    for tie in sorted(base["ties"])[:BRANCHES]:
        alt = follow(cfg, sets, weights, seed, steps, flip={tie[1:]},
                     dev=False, **kw)
        out.append({**alt, "dev_acc": base["dev_acc"]})
    return out


# The ties a follower takes the other way, nearest first.
BRANCHES = 4
