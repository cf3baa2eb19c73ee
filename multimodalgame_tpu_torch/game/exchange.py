"""The multi-turn Sender/Receiver conversation.

Parity target: reference ``exchange()`` (model.py:725-876), as
``multimodalgame_tpu/game/exchange.py`` runs it. The conversation always
runs ``max_exchange`` turns; termination is carried by the masks, and
``n_steps`` reports how many turns the reference's ``break_early`` loop
would have run.

* Eval mode: rounded messages, the (optionally cumulative) stop product,
  optional bit-flip corruption of every sender message.
* Train mode: Bernoulli bits ``u < p`` for the message, the stop bit and
  the query, flipout on both channels, and the two baselines scored on
  detached inputs. The uniforms ``u`` come from the caller, in the JAX
  exchange's layout (exchange.py:164-180): a dict with ``s``, ``z``,
  ``w`` and, with flipout, ``fz`` and ``fw``, each ``(T, B, dim)``.

Every channel crossing is detached (model.py:807-811, 826-829, 836, 843),
so the four agents' autograd graphs stay apart. Under visual attention the
Sender's ``h_x`` changes every turn, and the Sender baseline reads that
turn's ``h_x`` (JAX exchange.py:188, 241-244).

This is the plain PyTorch path for every config the port supports, and
the reference that the fused CUDA kernel (ops/cuda_exchange.py) is held
to.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.masks import corrupt_message
from multimodalgame_tpu_torch.ops.sampling import (bernoulli_from_uniform,
                                                   flipout_from_uniform,
                                                   hard_round,
                                                   uniform_widths)


class ExchangeOutputs(NamedTuple):
    """Stacked per-turn conversation record, ``(T, B, ...)``."""
    stop_masks: torch.Tensor   # (T+1, B, 1); [0]=ones, [-1] forced zero
    stop_feats: torch.Tensor   # (T, B, 1)
    stop_probs: torch.Tensor   # (T, B, 1)
    sen_feats: torch.Tensor    # (T, B, sender_out_dim) — post-corruption
    sen_probs: torch.Tensor    # (T, B, sender_out_dim)
    rec_feats: torch.Tensor    # (T, B, rec_w_dim) — post-flipout/ignore
    rec_probs: torch.Tensor    # (T, B, rec_w_dim)
    y: torch.Tensor            # (T, B, D)
    bs: torch.Tensor           # (T, B, 1) sender-baseline scores (train)
    br: torch.Tensor           # (T, B, 1) receiver-baseline scores (train)
    n_steps: torch.Tensor      # () int32
    attn_scores: Optional[torch.Tensor]   # (T, B, N) with visual attention


def description_inputs(pack: Any, cfg, device) -> Dict[str, Any]:
    """A description pack's tensors as the conversation takes them:
    ``desc`` ``(D, wv)`` and, under description attention,
    ``desc_set_padded`` ``(D, L, wv)`` and ``desc_set_mask`` ``(D, L)``
    (else ``None``), float32 on ``device``."""
    def put(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    return {"desc": put(pack.desc),
            "desc_set_padded": (put(pack.desc_set_padded)
                                if cfg.desc_attn else None),
            "desc_set_mask": (put(pack.desc_set_mask)
                              if cfg.desc_attn else None)}


def finalize_stop_masks(masks: torch.Tensor, fixed_exchange: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(T+1, B, 1)`` stop-mask chain and the reference's break-early
    turn count from the per-turn cumulative masks ``(T, B, 1)``.

    Prepends the all-ones turn-0 mask and forces the last mask to zero
    (model.py:870). Turn 0 always runs; turn t+1 runs iff some example is
    still active after turn t (model.py:866-867).
    """
    batch = masks.shape[1]
    stop_masks = torch.cat(
        [torch.ones((1, batch, 1), dtype=masks.dtype, device=masks.device),
         masks], dim=0)
    stop_masks[-1] = 0.0
    return stop_masks, turns_run(stop_masks, fixed_exchange)


def turns_run(stop_masks: torch.Tensor, fixed_exchange: bool
              ) -> torch.Tensor:
    """The reference's break-early turn count of a ``(T+1, B, 1)``
    stop-mask chain: turn 0 always runs, turn t+1 iff some row is still
    active after turn t (model.py:866-867). A batch-global count: rows
    gathered from data-parallel shards give the whole batch's."""
    T = stop_masks.shape[0] - 1
    if fixed_exchange:
        return torch.full((), T, dtype=torch.int32,
                          device=stop_masks.device)
    alive = stop_masks[1:T].sum(dim=(1, 2)) > 0
    return (1 + alive.sum()).to(torch.int32)


def needed_uniforms(cfg, train: bool,
                    uniforms: Optional[Dict[str, torch.Tensor]]
                    ) -> Tuple[str, ...]:
    """The keys of the uniform sets a conversation of ``cfg`` consumes
    (``ops/sampling.py:uniform_widths``); ``ValueError`` when ``uniforms``
    lacks one of them."""
    need = tuple(uniform_widths(cfg, train))
    missing = [k for k in need if uniforms is None or k not in uniforms]
    if missing:
        raise ValueError(f"this conversation needs the uniforms {missing}")
    return need


def exchange(modules: AgentModules, data: torch.Tensor, desc: torch.Tensor,
             corrupt_mask: Optional[torch.Tensor] = None, *,
             train: bool = False,
             uniforms: Optional[Dict[str, torch.Tensor]] = None,
             score_baselines: bool = True,
             data_context: Optional[torch.Tensor] = None,
             desc_set_padded: Optional[torch.Tensor] = None,
             desc_set_mask: Optional[torch.Tensor] = None
             ) -> ExchangeOutputs:
    """Run a batched conversation.

    Args:
        modules: the four agents (carry the :class:`GameConfig`).
        data: image features ``(B, feat_dim)``, or the map
            ``(B, feat_dim, H, W)`` under visual attention.
        desc: class-description CBOW matrix ``(D, wv_dim)``.
        corrupt_mask: optional ``(w_dim,)`` bit-flip mask applied to every
            sender message (model.py:814-820).
        train: sampled bits and scored baselines (model.py:222-229,
            414-429) instead of rounding.
        uniforms: the pre-drawn uniforms, needed in train mode and for
            eval-time flipout (``flipout_dev``); see
            ``ops/sampling.py:uniform_widths``.
        score_baselines: in train mode, score the baselines; when False
            ``bs``/``br`` are zeros (the fast path scores them batched).
        data_context: the ``fc`` context ``(B, attn_context_dim)`` of
            visual attention with ``attn_extra_context`` (model.py:127-136).
        desc_set_padded, desc_set_mask: the padded word sets ``(D, L,
            wv_dim)`` and their 0/1 mask ``(D, L)``, for description
            attention.
    """
    cfg = modules.cfg
    need = needed_uniforms(cfg, train, uniforms)
    sender, receiver = modules.sender, modules.receiver
    batch = data.shape[0]
    T = cfg.max_exchange
    flip_sen = "fz" in need
    flip_rec = "fw" in need
    sen_cache = sender.precompute(data, data_context)
    rec_cache = receiver.precompute(desc, desc_set_padded, desc_set_mask)

    # The Receiver opens with a query of ``first_rec``s (model.py:786-787).
    w_prev = torch.full((batch, cfg.rec_w_dim), cfg.first_rec,
                        dtype=data.dtype, device=data.device)
    h_z = torch.zeros((batch, cfg.rec_hidden), dtype=data.dtype,
                      device=data.device)
    mask = torch.ones((batch, 1), dtype=data.dtype, device=data.device)
    sprod = torch.ones((batch, 1), dtype=data.dtype, device=data.device)
    zeros = torch.zeros((batch, 1), dtype=data.dtype, device=data.device)

    outs = {k: [] for k in ("mask", "s_feat", "s_prob", "z", "z_prob",
                            "w", "w_prob", "y", "bs", "br", "attn")}
    for t in range(T):
        u = {k: uniforms[k][t] for k in need}
        # --- Sender turn (model.py:806-811) ---
        z_r = w_prev.detach()
        sen_logits, h_x, attn = sender.step(z_r, t, sen_cache)
        if cfg.use_binary:
            z_probs = torch.sigmoid(sen_logits)
            z = (bernoulli_from_uniform(u["z"], z_probs) if train
                 else hard_round(z_probs))
            if flip_sen:
                z = flipout_from_uniform(u["fz"], z, cfg.flipout_sen)
        else:
            z = sen_logits
            z_probs = torch.zeros_like(sen_logits)
        z = corrupt_message(z, corrupt_mask)

        # --- Receiver turn (model.py:826-829) ---
        z_s = z.detach()
        h_z, s_logits, y, w_logits = receiver.step(z_s, h_z, rec_cache)

        # STOP bit: sampled in training; in eval the (cumulative) stop
        # probability rounded (model.py:414-429). sprod starts at ones, so
        # 1.0 * x is exact at t == 0.
        s_prob = torch.sigmoid(s_logits)
        if train:
            s_bit = bernoulli_from_uniform(u["s"], s_prob)
        else:
            sprod = sprod * s_prob if cfg.s_prob_prod else s_prob
            s_bit = hard_round(sprod)

        # Receiver query back to the Sender (model.py:452-468).
        if cfg.use_binary:
            w_probs = torch.sigmoid(w_logits)
            w_feats = (bernoulli_from_uniform(u["w"], w_probs) if train
                       else hard_round(w_probs))
            if flip_rec:
                w_feats = flipout_from_uniform(u["fw"], w_feats,
                                               cfg.flipout_rec)
            if cfg.ignore_receiver:
                w_feats = torch.zeros_like(w_feats)
        else:
            w_feats = w_logits
            w_probs = torch.zeros_like(w_logits)

        # --- Baselines, train only, on detached inputs (model.py:831-843)
        if train and score_baselines:
            bs = modules.baseline_sen(h_x.detach(), z_r, None)
            br = modules.baseline_rec(None, z_s, h_z.detach())
        else:
            bs = br = zeros

        mask = torch.minimum(mask, s_bit)                 # model.py:852
        for k, v in (("mask", mask), ("s_feat", s_bit), ("s_prob", s_prob),
                     ("z", z), ("z_prob", z_probs), ("w", w_feats),
                     ("w_prob", w_probs), ("y", y), ("bs", bs), ("br", br),
                     ("attn", attn)):
            outs[k].append(v)
        w_prev = w_feats

    st = {k: None if v[0] is None else torch.stack(v)
          for k, v in outs.items()}
    stop_masks, n_steps = finalize_stop_masks(st["mask"], cfg.fixed_exchange)
    return ExchangeOutputs(
        stop_masks=stop_masks, stop_feats=st["s_feat"],
        stop_probs=st["s_prob"], sen_feats=st["z"], sen_probs=st["z_prob"],
        rec_feats=st["w"], rec_probs=st["w_prob"], y=st["y"],
        bs=st["bs"], br=st["br"], n_steps=n_steps, attn_scores=st["attn"])
