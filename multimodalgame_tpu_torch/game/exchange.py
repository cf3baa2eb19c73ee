"""The multi-turn Sender/Receiver conversation, eval mode.

Parity target: reference ``exchange()`` (model.py:725-876) in eval mode,
as ``multimodalgame_tpu/game/exchange.py`` runs it with ``train=False``:
rounded messages, the (optionally cumulative) stop product, optional
bit-flip corruption of every sender message. The conversation always
runs ``max_exchange`` turns; termination is carried by the masks, and
``n_steps`` reports how many turns the reference's ``break_early`` loop
would have run.

This is the plain PyTorch path for every config the port supports, and
the reference that the fused CUDA kernel (ops/cuda_exchange.py) is held
to. Training mode (sampled bits, baselines) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.masks import corrupt_message
from multimodalgame_tpu_torch.ops.sampling import hard_round


class ExchangeOutputs(NamedTuple):
    """Stacked per-turn conversation record, ``(T, B, ...)``."""
    stop_masks: torch.Tensor   # (T+1, B, 1); [0]=ones, [-1] forced zero
    stop_feats: torch.Tensor   # (T, B, 1)
    stop_probs: torch.Tensor   # (T, B, 1)
    sen_feats: torch.Tensor    # (T, B, sender_out_dim) — post-corruption
    sen_probs: torch.Tensor    # (T, B, sender_out_dim)
    rec_feats: torch.Tensor    # (T, B, rec_w_dim) — post-ignore
    rec_probs: torch.Tensor    # (T, B, rec_w_dim)
    y: torch.Tensor            # (T, B, D)
    bs: torch.Tensor           # (T, B, 1) sender-baseline scores (zeros)
    br: torch.Tensor           # (T, B, 1) receiver-baseline scores (zeros)
    n_steps: torch.Tensor      # () int32
    attn_scores: Optional[torch.Tensor]


def finalize_stop_masks(masks: torch.Tensor, fixed_exchange: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(T+1, B, 1)`` stop-mask chain and the reference's break-early
    turn count from the per-turn cumulative masks ``(T, B, 1)``.

    Prepends the all-ones turn-0 mask and forces the last mask to zero
    (model.py:870). Turn 0 always runs; turn t+1 runs iff some example is
    still active after turn t (model.py:866-867).
    """
    T, batch = masks.shape[0], masks.shape[1]
    stop_masks = torch.cat(
        [torch.ones((1, batch, 1), dtype=masks.dtype, device=masks.device),
         masks], dim=0)
    stop_masks[-1] = 0.0
    if fixed_exchange:
        n_steps = torch.tensor(T, dtype=torch.int32, device=masks.device)
    else:
        alive = masks.sum(dim=(1, 2)) > 0
        n_steps = (1 + alive[:-1].sum()).to(torch.int32)
    return stop_masks, n_steps


def exchange(modules: AgentModules, data: torch.Tensor, desc: torch.Tensor,
             corrupt_mask: Optional[torch.Tensor] = None) -> ExchangeOutputs:
    """Run a batched eval conversation.

    Args:
        modules: the Sender and Receiver (carry the :class:`GameConfig`).
        data: image features ``(B, feat_dim)``.
        desc: class-description CBOW matrix ``(D, wv_dim)``.
        corrupt_mask: optional ``(w_dim,)`` bit-flip mask applied to every
            sender message (model.py:814-820).
    """
    cfg = modules.cfg
    if cfg.flipout_dev and (cfg.flipout_sen is not None
                            or cfg.flipout_rec is not None):
        raise NotImplementedError(
            "eval-time flipout needs the sampling path of training, which "
            "is not ported to PyTorch yet")
    sender, receiver = modules.sender, modules.receiver
    batch = data.shape[0]
    T = cfg.max_exchange
    sen_cache = sender.precompute(data)
    rec_cache = receiver.precompute(desc)

    # The Receiver opens with a query of ``first_rec``s (model.py:786-787).
    w_prev = torch.full((batch, cfg.rec_w_dim), cfg.first_rec,
                        dtype=data.dtype, device=data.device)
    h_z = torch.zeros((batch, cfg.rec_hidden), dtype=data.dtype,
                      device=data.device)
    mask = torch.ones((batch, 1), dtype=data.dtype, device=data.device)
    sprod = torch.ones((batch, 1), dtype=data.dtype, device=data.device)

    outs = {k: [] for k in ("mask", "s_feat", "s_prob", "z", "z_prob",
                            "w", "w_prob", "y")}
    for t in range(T):
        # --- Sender turn (model.py:806-811) ---
        sen_logits = sender.step(w_prev.detach(), t, sen_cache)
        if cfg.use_binary:
            z_probs = torch.sigmoid(sen_logits)
            z = hard_round(z_probs)
        else:
            z = sen_logits
            z_probs = torch.zeros_like(sen_logits)
        z = corrupt_message(z, corrupt_mask)

        # --- Receiver turn (model.py:826-829) ---
        h_z, s_logits, y, w_logits = receiver.step(z.detach(), h_z,
                                                   rec_cache)

        # Eval STOP rule: round the (cumulative) stop probability
        # (model.py:414-429). sprod starts at ones, so 1.0 * x is exact
        # at t == 0.
        s_prob = torch.sigmoid(s_logits)
        sprod = sprod * s_prob if cfg.s_prob_prod else s_prob
        s_bit = hard_round(sprod)

        # Receiver query back to the Sender (model.py:452-468).
        if cfg.use_binary:
            w_probs = torch.sigmoid(w_logits)
            w_feats = hard_round(w_probs)
            if cfg.ignore_receiver:
                w_feats = torch.zeros_like(w_feats)
        else:
            w_feats = w_logits
            w_probs = torch.zeros_like(w_logits)

        mask = torch.minimum(mask, s_bit)                 # model.py:852
        for k, v in (("mask", mask), ("s_feat", s_bit), ("s_prob", s_prob),
                     ("z", z), ("z_prob", z_probs), ("w", w_feats),
                     ("w_prob", w_probs), ("y", y)):
            outs[k].append(v)
        w_prev = w_feats

    st = {k: torch.stack(v) for k, v in outs.items()}
    stop_masks, n_steps = finalize_stop_masks(st["mask"], cfg.fixed_exchange)
    zeros = torch.zeros((T, batch, 1), dtype=data.dtype, device=data.device)
    return ExchangeOutputs(
        stop_masks=stop_masks, stop_feats=st["s_feat"],
        stop_probs=st["s_prob"], sen_feats=st["z"], sen_probs=st["z_prob"],
        rec_feats=st["w"], rec_probs=st["w_prob"], y=st["y"],
        bs=zeros, br=zeros, n_steps=n_steps, attn_scores=None)
