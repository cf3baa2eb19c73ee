"""The plain reference of the referential game, in plain PyTorch.

It follows the equations of the original PyTorch implementation
(nyu-dl/MultimodalGame, model.py) that the port reproduces, written out
again from them and independent of the program:

* Sender (model.py:49-238): ``h_x = W_img x + b`` (with visual attention,
  ``x`` pooled over the map's positions by ``softmax(U tanh(W_w w + W_x x_n
  + W_g g))``, uniform at turn 0); ``h_w = W_code sigmoid(code_bias)`` at
  turn 0, else ``W_code w``; message logits ``W_bin tanh(h_x + h_w)``.
* Receiver (model.py:241-477): a GRU cell over the message, the stop unit
  ``W_s h``, class scores ``y_i = y2 relu(y1 [h, desc_i])``, and the query
  ``W tanh(W_h h + W_d sum_i softmax(y)_i desc_i)`` (the scores detached).
* Train mode: Bernoulli bits ``u < p`` from the Philox stream; eval mode:
  ``floor(p + 0.5)`` and the cumulative stop product (model.py:640).
* Losses (model.py:879-988, 1264-1305): NLL of the answer at the turn each
  row stopped, REINFORCE on the message, query and stop bits with learned
  baselines, masked over the turns and scaled by the advantage's unbiased
  std (at least 1), entropy bonuses, and the baselines' squared error.
* Optimizers: per agent a clip to global norm 1 (optax's rule) and
  RMSprop (decay 0.99, epsilon 1e-8 outside the square root).

``prec`` runs the conversation's products in another precision: ``tf32``
rounds both operands of every product to TF32's 10-bit mantissa and sums
in float32, as the card's tensor cores do with TF32 on (the control of a
float32 configuration whose TF32 is off); ``bf16`` runs the conversation
in bfloat16. The losses and the optimizer stay in float32.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from gamebench.reference.philox import train_uniforms

EPS = 1e-8
AGENTS = ("sender", "receiver", "baseline_sen", "baseline_rec")
CLIP, DECAY, RMS_EPS = 1.0, 0.99, 1e-8
# A draw this close to its probability could fall the other way in a
# float32 program whose probability differs from the reference's by
# rounding (a few parts in 10**7): a tie, which a follower may take either
# way (``reference/train.py:follow_branches``).
TIE = 2e-6


_PREC = {"prec": "f32"}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even); the
    gradient passes as through the identity."""
    i = x.detach().float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - x).detach()


def _mm(a, b):
    if _PREC["prec"] == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


def _lin(P, name, x):
    out = _mm(x, P[name + ".weight"].t())
    b = P.get(name + ".bias")
    return out if b is None else out + b


def _dtype(prec):
    return torch.bfloat16 if prec == "bf16" else torch.float32


def _round(p):
    return torch.floor(p + 0.5)


def conversation(P: Dict[str, torch.Tensor], cfg: dict, data, desc,
                 ctx=None, mode: str = "train",
                 uniforms: Optional[Dict[str, torch.Tensor]] = None,
                 forced: Optional[dict] = None, prec: str = "f32",
                 fault: Optional[str] = None, flip=frozenset()) -> dict:
    """One batched conversation of ``max_exchange`` turns.

    ``mode`` is ``train`` (bits ``u < p`` from ``uniforms``) or ``eval``
    (rounded). With ``forced`` (``z`` and ``w`` of shape ``(n, B, W)``,
    ``s`` the stop masks ``(n, B)``: what the program drew or served in
    its first ``n`` turns) the conversation takes those bits instead, and
    records in ``gap`` how far each lies on the wrong side of the draw or
    the rounding that should have given it; a training conversation's
    turns from ``n`` on, where every row has stopped, take zeros, and an
    eval conversation stops at ``n``. A training conversation that draws
    its own bits lists in ``ties`` each draw within ``TIE`` of its
    probability as ``(distance, turn, name, row, unit)``, and takes the
    other bit at each ``(turn, name, row, unit)`` in ``flip``. Returns the
    per-turn records."""
    _PREC["prec"] = prec
    dtype = _dtype(prec)
    P = {k: v.to(dtype) for k, v in P.items()}
    data = data.to(dtype)
    desc = desc.to(dtype)
    B = data.shape[0]
    T = cfg["max_exchange"]
    n = T if forced is None else forced["z"].shape[0]
    if mode == "eval" and forced is not None:
        T = n
    R = cfg["rec_hidden"]
    attn = cfg["visual_attn"]
    W1 = P["receiver.y1.weight"]
    desc_proj = _mm(desc, W1[:, R:].t())
    if attn:
        x_flat = data.reshape(B, data.shape[1], -1).transpose(1, 2)
        keys = _lin(P, "sender.attn_W_x", x_flat)
        if cfg["attn_extra_context"]:
            keys = keys + _lin(P, "sender.attn_W_g", ctx.to(dtype))[:, None]
    else:
        h_x_fixed = _lin(P, "sender.image_layer", data)
    h_w0 = _lin(P, "sender.code_layer",
                torch.sigmoid(P["sender.code_bias"])[None, :])
    w_prev = torch.full((B, cfg["rec_w_dim"]), float(cfg["first_rec"]),
                        dtype=dtype, device=data.device)
    h = torch.zeros((B, R), dtype=dtype, device=data.device)
    sprod = torch.ones((B, 1), dtype=dtype, device=data.device)
    rec = {k: [] for k in ("z", "zp", "w", "wp", "s", "sp", "sprod", "y",
                           "bs", "br", "gap")}
    ties = []

    def draw(name, t, u, p):
        """``u < p``, with its ties listed and the bits in ``flip``
        taken the other way."""
        p = p.detach().float()
        bit = (u < p).to(dtype)
        near = ((u - p).abs() < TIE).nonzero().tolist()
        ties.extend((float((u - p)[i, j].abs()), t, name, i, j)
                    for i, j in near)
        for (ft, fname, i, j) in flip:
            if ft == t and fname == name:
                bit[i, j] = 1 - bit[i, j]
        return bit
    for t in range(T):
        if attn:
            if t == 0:
                a = torch.full(x_flat.shape[:2], 1.0 / x_flat.shape[1],
                               dtype=dtype, device=data.device)
            else:
                pre = torch.tanh(_lin(P, "sender.attn_W_w", w_prev)[:, None]
                                 + keys)
                a = torch.softmax(_lin(P, "sender.attn_U", pre)[..., 0], -1)
            h_x = _lin(P, "sender.image_layer",
                       _mm(a[:, None, :], x_flat)[:, 0])
        else:
            h_x = h_x_fixed
        h_w = h_w0 if t == 0 else _lin(P, "sender.code_layer", w_prev)
        zp = torch.sigmoid(_lin(P, "sender.binary_layer",
                                torch.tanh(h_x + h_w)))
        gaps = []
        if forced is not None:
            z = (forced["z"][t].to(dtype) if t < n
                 else torch.zeros_like(zp))
            if t < n:
                gaps.append(_wrong_draw(z, uniforms["z"][t], zp)
                            if mode == "train" else _wrong_side(z, zp))
        elif mode == "train":
            z = draw("z", t, uniforms["z"][t], zp)
            if fault == "flip" and t == 0:
                z = z.clone()
                z[0, 0] = 1 - z[0, 0]
        else:
            z = _round(zp.detach())
        # Receiver turn.
        gi = _mm(z, P["receiver.rnn.weight_ih"].t()) + \
            P["receiver.rnn.bias_ih"]
        gh = _mm(h, P["receiver.rnn.weight_hh"].t()) + \
            P["receiver.rnn.bias_hh"]
        i_r, i_z, i_n = gi.chunk(3, -1)
        h_r, h_z, h_n = gh.chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        u = torch.sigmoid(i_z + h_z)
        h = (1 - u) * torch.tanh(i_n + r * h_n) + u * h
        sp = torch.sigmoid(_lin(P, "receiver.s", h))
        y_hid = torch.relu((_mm(h, W1[:, :R].t())
                            + P["receiver.y1.bias"])[:, None]
                           + desc_proj[None])
        y = _lin(P, "receiver.y2", y_hid)[..., 0]
        wd = _mm(torch.softmax(y, -1).detach(), desc)
        wp = torch.sigmoid(_lin(P, "receiver.w", torch.tanh(
            _lin(P, "receiver.w_h", h) + _lin(P, "receiver.w_d", wd))))
        sprod = sprod * sp.detach()
        if forced is not None:
            if t < n:
                s = forced["s"][t].to(dtype)[:, None]
                w = forced["w"][t].to(dtype)
                if mode == "train" and t == T - 1:
                    # The log shows the last turn's mask forced to zero,
                    # not its stop bit: the reference draws that one.
                    s = (uniforms["s"][t] < sp.detach().float()).to(dtype)
                    gaps.append(_wrong_draw(w, uniforms["w"][t], wp))
                elif mode == "train":
                    # A stop bit is seen only while its row talks.
                    alive = (torch.ones_like(s) if t == 0 else
                             forced["s"][t - 1].to(dtype)[:, None])
                    gaps += [_wrong_draw(s, uniforms["s"][t], sp) * alive,
                             _wrong_draw(w, uniforms["w"][t], wp)]
                else:
                    gaps += [_wrong_side(s, sprod), _wrong_side(w, wp)]
            else:
                s, w = torch.zeros_like(sp), torch.zeros_like(wp)
        elif mode == "train":
            s = draw("s", t, uniforms["s"][t], sp)
            w = draw("w", t, uniforms["w"][t], wp)
        else:
            s = _round(sprod)
            w = _round(wp.detach())
        if mode == "train":
            rec["bs"].append(_lin(P, "baseline_sen.linear2", torch.relu(_lin(
                P, "baseline_sen.linear1",
                torch.cat([h_x.detach(), w_prev], -1)))))
            rec["br"].append(_lin(P, "baseline_rec.linear2", torch.relu(_lin(
                P, "baseline_rec.linear1", torch.cat([z, h.detach()], -1)))))
        for k, v in (("z", z), ("zp", zp), ("w", w), ("wp", wp), ("s", s),
                     ("sp", sp), ("sprod", sprod), ("y", y)):
            rec[k].append(v)
        if gaps:
            rec["gap"].append(torch.stack([g.max() for g in gaps]).max())
        w_prev = w
    out = {k: torch.stack(v) for k, v in rec.items() if v}
    out["ties"] = ties
    return out


def _wrong_draw(bit, u, p):
    """How far the draw ``u < p`` lies on the wrong side of ``bit``."""
    p = p.detach().float()
    return torch.where(bit > 0.5, (u - p).clamp(min=0),
                       (p - u).clamp(min=0))


def _wrong_side(bit, p):
    """How far ``p`` lies on the wrong side of the rounding that should
    have given ``bit`` (``floor(p + 0.5)``): 0 where it agrees."""
    p = p.detach().float()
    bit = bit.float()
    return torch.where(bit > 0.5, (0.5 - p).clamp(min=0),
                       (p - 0.5).clamp(min=0))


def stop_chain(s: torch.Tensor) -> torch.Tensor:
    """The ``(T+1, B, 1)`` mask chain of the stop bits ``(T, B, 1)``:
    ones, then the running minimum, the last forced to zero."""
    masks = torch.cummin(s, dim=0).values
    chain = torch.cat([torch.ones_like(masks[:1]), masks])
    chain[-1] = 0
    return chain


def _binary_loss(feats, probs, logs, scores, mask, penalty):
    """One turn's masked REINFORCE loss with its negentropy bonus."""
    feats = feats.detach()
    log_p = (feats * torch.log(probs + EPS)
             + (1 - feats) * torch.log(1 - probs + EPS)).sum(-1)
    weight = (logs - scores).detach()[:, 0]
    m = mask[:, 0]
    n = m.sum()
    if feats.shape[0] > 1:
        mean = (weight * m).sum() / n.clamp(min=1)
        var = (m * (weight - mean) ** 2).sum() / (n - 1).clamp(min=1)
        std = torch.where(n > 1, var.sqrt(), torch.zeros_like(var))
        weight = weight / std.clamp(min=1)
    negent = ((torch.log(probs + EPS) * probs).sum(-1)
              + (torch.log(1 - probs + EPS) * (1 - probs)).sum(-1))
    loss = (m * -weight * log_p).sum() / n.clamp(min=1)
    loss = loss + penalty * (m * negent).sum() / n.clamp(min=1)
    return torch.where(n > 0, loss, torch.zeros_like(loss)), n


def _turns(losses_ns):
    losses = torch.stack([lo for lo, _ in losses_ns])
    ns = torch.stack([n for _, n in losses_ns])
    return (losses * ns).sum() / ns.sum().clamp(min=1)


def _bas_loss(scores, logs, mask):
    m = mask
    n = m.sum()
    loss = (((scores - logs.detach()) ** 2) * m).sum() / n.clamp(min=1)
    return torch.where(n > 0, loss, torch.zeros_like(loss)), n


def losses(cfg: dict, rec: dict, target: torch.Tensor) -> dict:
    """Every loss term of a training conversation and their total, in
    float32."""
    f = {k: v.float() for k, v in rec.items() if torch.is_tensor(v)}
    T = f["y"].shape[0]
    chain = stop_chain(f["s"])
    pre, post = chain[:-1], chain[1:]
    y_mask = torch.minimum(1 - post, pre)
    dist = torch.log_softmax((f["y"] * y_mask).sum(0), -1)
    logs = dist.gather(1, target[:, None]).detach()
    nll = -dist.gather(1, target[:, None]).mean()
    out = {"nll_loss": nll}
    out["loss_binary_s"] = _turns([_binary_loss(
        f["s"][t], f["sp"][t], logs, f["br"][t], pre[t], cfg["entropy_s"])
        for t in range(T)])
    out["loss_binary_rec"] = _turns([_binary_loss(
        f["w"][t], f["wp"][t], logs, f["br"][t], chain[t + 1],
        cfg["entropy_rec"]) for t in range(T - 1)])
    out["loss_sen"] = _turns([_binary_loss(
        f["z"][t], f["zp"][t], logs, f["bs"][t], pre[t], cfg["entropy_sen"])
        for t in range(T)])
    out["loss_bas_rec"] = _turns([_bas_loss(f["br"][t], logs, pre[t])
                                  for t in range(T)])
    out["loss_bas_sen"] = _turns([_bas_loss(f["bs"][t], logs, pre[t])
                                  for t in range(T)])
    out["total"] = sum(out[k] for k in ("nll_loss", "loss_binary_s",
                                        "loss_binary_rec", "loss_sen",
                                        "loss_bas_rec", "loss_bas_sen"))
    return out


LOGGED = ("loss_sen", "nll_loss", "loss_binary_rec", "loss_binary_s",
          "loss_bas_sen", "loss_bas_rec")


def train_step(P: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
               cfg: dict, data, target, desc, ctx, seed: int, step: int,
               prec: str = "f32", fault: Optional[str] = None,
               forced: Optional[dict] = None, flip=frozenset()) -> dict:
    """One update of the four agents in place: the conversation on the
    Philox bits of ``(seed, step)`` (or on ``forced``, the bits a trainer
    drew, see :func:`conversation`), the losses, the gradients, each
    agent's clip and RMSprop. Returns the logged losses,
    each leaf's clipped gradient norm, the bits as a trainer's log shows
    them (the turns run; the stop bits as the rows' masks) and, with
    ``forced``, the widest gap by which a forced bit lies on the wrong
    side of its draw; and the conversation's ``ties`` (see
    :func:`conversation`, which takes ``flip``)."""
    B, T = data.shape[0], cfg["max_exchange"]
    if fault == "half":
        # The second half's rows replaced by the first half's.
        keep = torch.arange(B, device=data.device) % (B // 2)
        data, target = data[keep], target[keep]
        ctx = None if ctx is None else ctx[keep]
    widths = {"z": cfg["sender_out_dim"], "s": 1, "w": cfg["rec_w_dim"]}
    u = train_uniforms(widths, T, data.shape[0], seed, step, data.device)
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    rec = conversation(leaves, cfg, data, desc, ctx, "train", u,
                       forced=forced, prec=prec, fault=fault, flip=flip)
    out = losses(cfg, rec, target)
    out["total"].backward()
    norms = {}
    with torch.no_grad():
        for agent in AGENTS:
            names = [k for k in P if k.split(".")[0] == agent]
            grads = [leaves[k].grad if leaves[k].grad is not None
                     else torch.zeros_like(P[k]) for k in names]
            total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = 1.0 if total < CLIP else float(CLIP / total)
            for k, g in zip(names, grads):
                g = (g * scale).float()
                norms[k] = float(g.double().norm())
                if fault == "frozen":
                    continue
                nu[k] = (1 - DECAY) * g ** 2 + DECAY * nu[k]
                P[k] = P[k] - cfg["learning_rate"] * g / (nu[k].sqrt()
                                                          + RMS_EPS)
    masks = stop_chain(rec["s"].float())
    n = int(1 + (masks[1:T].sum(dim=(1, 2)) > 0).sum())
    return {"losses": {k: float(out[k].detach()) for k in LOGGED},
            "grad_norms": norms,
            "bits": {"z": rec["z"][:n].detach().float(),
                     "w": rec["w"][:n].detach().float(),
                     "s": masks[1:n + 1, :, 0]},
            "bit_gap": (float(rec["gap"].max()) if "gap" in rec else 0.0),
            "ties": rec["ties"]}


def eval_answers(P, cfg: dict, data, desc, ctx=None, prec: str = "f32"
                 ) -> dict:
    """A free-running eval conversation of one batch, as a predictor
    returns it: the answer's log-probabilities, the conversation length
    of each row, the messages of the turns run and their count."""
    with torch.no_grad():
        rec = conversation(P, cfg, data, desc, ctx, "eval", prec=prec)
    s = rec["s"].float()
    chain = stop_chain(s)
    T = s.shape[0]
    alive = chain[1:T].sum(dim=(1, 2)) > 0
    n = int(1 + alive.sum())
    length = s[:n, :, 0].sum(0)
    turn = torch.clamp(length.long(), max=T - 1)
    y = rec["y"].float()
    logp = torch.log_softmax(y[turn, torch.arange(y.shape[1])], -1)
    return {"log_probs": logp, "conversation_length": length,
            "sender_messages": rec["z"][:n].float(),
            "receiver_messages": rec["w"][:n].float(), "n_steps": n}


def judge_answers(P, cfg: dict, data, desc, served: dict, ctx=None) -> dict:
    """The reference run over a served batch with the served messages and
    stop decisions in place of its own: the widest gap by which a served
    bit lies on the wrong side of the reference's rounding, the largest
    difference of the answer's log-probabilities, and the widest gap by
    which the served prediction's log-probability lies below the
    reference's best."""
    n = int(served["n_steps"])
    length = torch.as_tensor(np.asarray(served["conversation_length"]),
                             device=data.device).float()
    forced = {"z": torch.as_tensor(np.asarray(served["sender_messages"]),
                                   device=data.device),
              "w": torch.as_tensor(np.asarray(served["receiver_messages"]),
                                   device=data.device),
              "s": (torch.arange(n, device=data.device)[:, None]
                    < length[None]).float()}
    with torch.no_grad():
        rec = conversation(P, cfg, data, desc, ctx, "eval", forced=forced)
    T = cfg["max_exchange"]
    turn = torch.clamp(length.long(), max=min(T, n) - 1)
    logp = torch.log_softmax(rec["y"][turn, torch.arange(data.shape[0])], -1)
    got = torch.as_tensor(np.asarray(served["log_probs"]),
                          device=data.device).float()
    pred = got.argmax(-1)
    # A row still talking after the last served turn, short of the last
    # turn, is a conversation ended early: a stop decision on the wrong
    # side by the whole half.
    late = 0.5 if n < T and bool((length >= n).any()) else 0.0
    return {"bit_gap": max(float(rec["gap"].max()), late),
            "logprob_gap": float((got - logp).abs().max()),
            "answer_gap": float((logp.max(-1).values
                                 - logp.gather(1, pred[:, None])[:, 0]).max())}


def dev_accuracy(P, cfg: dict, feats, targets, desc, batches: List,
                 ctx=None, top_k: int = 6, prec: str = "f32") -> float:
    """The dev sweep's top-k accuracy: each batch's conversation, the
    answer at the turn each row stopped among the turns the batch ran."""
    hits = 0
    T = cfg["max_exchange"]
    for rows in batches:
        rows = torch.as_tensor(rows, device=feats.device)
        with torch.no_grad():
            rec = conversation(P, cfg, feats[rows], desc,
                               None if ctx is None else ctx[rows], "eval",
                               prec=prec)
        s = rec["s"].float()
        chain = stop_chain(s)
        n = int(1 + (chain[1:T].sum(dim=(1, 2)) > 0).sum())
        length = s[:n, :, 0].sum(0)
        turn = torch.clamp(length.long(), max=n - 1)
        y = rec["y"].float()[turn, torch.arange(len(rows))]
        dist = torch.log_softmax(y, -1)
        tgt = targets[rows].long()
        rank = (dist > dist.gather(1, tgt[:, None])).sum(-1)
        hits += int((rank < min(top_k, dist.shape[-1])).sum())
    return hits / float(sum(len(r) for r in batches))
