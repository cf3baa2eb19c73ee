"""Receiver agent: GRU over incoming messages, class prediction, STOP
bit, and a query back to the Sender.

Parity target: reference ``Receiver`` (model.py:241-477), as ported in
``multimodalgame_tpu/models/receiver.py``:

    h_z = GRUCell(z, h_z)                                 (model.py:340)
    s   = W_s h_z                                         (model.py:414)
    y_i = y2(relu(y1([h_z, desc_i])))  for every class i  (model.py:431-433)
    wd  = sum_i softmax(y)_i.detach() * desc_i            (model.py:439-449)
    w   = W tanh(W_h h_z + W_d wd)                        (model.py:452-454)

``y1`` is stored as the reference's single ``(hid, hid + desc)`` Linear and
consumed split: its description block is projected once per conversation
in :meth:`precompute`, and its ``h_z`` block joins ``s`` and ``w_h`` in one
fused ``h_z`` head matmul.

Description attention (model.py:267-271, 344-410) scores every word of
every class's description against ``h_z`` (``d_attn(tanh(d_d(word) +
d_h(h_z)))``), takes a masked softmax within each class over the dense
``(D, L)`` padded word set, and pools the words into one vector a class.
That vector takes the CBOW row's place in ``y1`` and in the query's
mixing. Under it the reference concatenates ``[desc, h_z]``
(model.py:409-410), so the first ``desc`` columns of ``y1.weight`` are
its description block.

Under tensor parallelism with a class-sharded head (``tp``, the seam of
``parallel/tensor.py``; ``None`` is the single-device path) a rank scores
its block of the classes: the head's ``h_z`` block of ``y1`` (and ``d_h``)
leaves the fused matmul and reads ``h_z`` through ``f``, the class scores
are gathered whole for the softmax, and under description attention the
pooled words' mixing is summed over the model axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodalgame_tpu_torch.models.gru import GRUCell
from multimodalgame_tpu_torch.models.init import init_linear_


class Receiver(nn.Module):
    def __init__(self, z_dim: int, desc_dim: int, hid_dim: int,
                 out_dim: int, w_dim: int, s_dim: int,
                 desc_attn: bool = False, desc_attn_dim: int = 64):
        super().__init__()
        if out_dim != 1:
            # Dead configuration space in the reference (model.py:433,
            # 439-449); rejected as in the JAX package.
            raise NotImplementedError(
                "rec_out_dim must be 1: the prediction/query pipeline is "
                "per-class scalar scores")
        if s_dim != 1:
            raise NotImplementedError(
                "rec_s_dim must be 1: the stop bit is a scalar per "
                "example in the exchange mask chain")
        self.tp = None
        self.hid_dim = hid_dim
        self.desc_dim = desc_dim
        self.desc_attn = desc_attn
        # Registration order is the reference's (JAX
        # utils/torch_interop.py:138-151): optimizer slots keep their
        # positions.
        self.rnn = GRUCell(z_dim, hid_dim)
        self.w_h = nn.Linear(hid_dim, hid_dim)
        self.w_d = nn.Linear(desc_dim, hid_dim, bias=False)
        self.w = nn.Linear(hid_dim, w_dim)
        self.y1 = nn.Linear(hid_dim + desc_dim, hid_dim)
        self.y2 = nn.Linear(hid_dim, out_dim)
        self.s = nn.Linear(hid_dim, s_dim)
        if desc_attn:
            self.d_d = nn.Linear(desc_dim, desc_attn_dim)
            self.d_h = nn.Linear(hid_dim, desc_attn_dim)
            self.d_attn = nn.Linear(desc_attn_dim, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.rnn.reset_parameters(generator)
        for layer in self.children():
            if layer is not self.rnn:
                init_linear_(layer, generator)

    def precompute(self, desc: torch.Tensor,
                   desc_set_padded: Optional[torch.Tensor] = None,
                   desc_set_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Conversation-invariant pieces and the fused ``h_z`` head matrix
        ``[s | y1_h | w_h (| d_h)]``. Without description attention, the
        description block of ``y1`` applied to the CBOW matrix ``desc``
        ``(D, wv)`` -> ``(D, hid)``; with it, ``d_d`` applied to the padded
        word sets ``desc_set_padded`` ``(D, L, wv)``, whose 0/1
        ``desc_set_mask`` ``(D, L)`` marks the real words."""
        hid, w1 = self.hid_dim, self.y1.weight
        cache = {"desc": desc}
        parts_w = [self.s.weight, None, self.w_h.weight]
        parts_b = [self.s.bias, self.y1.bias, self.w_h.bias]
        split = self.tp is not None and self.tp.classes
        if split:
            lo, hi = self.tp.class_block(desc.shape[0])
            cache["classes"] = (lo, hi)
        if self.desc_attn:
            parts_w[1] = w1[:, self.desc_dim:]
            parts_w.append(self.d_h.weight)
            parts_b.append(self.d_h.bias)
            if split:
                desc_set_padded = desc_set_padded[lo:hi]
                desc_set_mask = desc_set_mask[lo:hi]
            cache.update(dd=self.d_d(desc_set_padded),
                         padded=desc_set_padded, mask=desc_set_mask)
        else:
            parts_w[1] = w1[:, :hid]
            cache["desc_proj"] = (desc[lo:hi] if split else desc) \
                @ w1[:, hid:].t()
        if split:
            # [s | w_h] stay fused; the class head's [y1_h (| d_h)] apart.
            head = [1] + list(range(3, len(parts_w)))
            cache["head_w"] = torch.cat([parts_w[i] for i in head], dim=0)
            cache["head_b"] = torch.cat([parts_b[i] for i in head])
            parts_w = [parts_w[0], parts_w[2]]
            parts_b = [parts_b[0], parts_b[2]]
        cache["hz_w"] = torch.cat(parts_w, dim=0)
        cache["hz_b"] = torch.cat(parts_b)
        return cache

    def step(self, z: torch.Tensor, h_z: torch.Tensor,
             cache: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
        """One receiver turn: ``(h_z_new, s_logits, y, w_logits)``."""
        h_z_new = self.rnn(z, h_z)
        s_logits, y, w_logits = self.heads(h_z_new, cache)
        return h_z_new, s_logits, y, w_logits

    def heads(self, h_z: torch.Tensor, cache: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """STOP, prediction and query heads on an updated hidden state:
        ``(s_logits (B, 1), y (B, D), w_logits (B, w_dim))``."""
        hid = self.hid_dim
        fused = h_z @ cache["hz_w"].t() + cache["hz_b"]
        s_logits = fused[:, :1]
        split = "classes" in cache
        if split:
            # The class-sharded head: this rank's classes, h_z through f.
            w_h_out = fused[:, 1:1 + hid]
            head = self.tp.enter(h_z) @ cache["head_w"].t() + cache["head_b"]
            y1h, dh = head[:, :hid], head[:, hid:]
        else:
            y1h = fused[:, 1:1 + hid]             # h_z @ y1_h + y1_bias
            w_h_out = fused[:, 1 + hid:1 + 2 * hid]
            dh = fused[:, 1 + 2 * hid:]

        if self.desc_attn:
            # Word attention (model.py:344-410): scores of every word
            # against h_z, a softmax over each class's real words, then
            # the words pooled into one vector a class.
            pre = torch.tanh(cache["dd"][None] + dh[:, None, None, :])
            scores = self.d_attn(pre)[..., 0]             # (B, D, L)
            scores = scores.masked_fill(cache["mask"][None] <= 0,
                                        torch.finfo(scores.dtype).min)
            alpha = torch.softmax(scores, dim=-1)
            descs = torch.einsum("bdl,dlv->bdv", alpha, cache["padded"])
            # y1 with the concat order [desc, h_z] (model.py:409-410).
            y_hid = torch.relu(descs @ self.y1.weight[:, :self.desc_dim].t()
                               + y1h[:, None, :])
        else:
            # y1 with build_inp's concat order [h_z, desc] (model.py:548).
            y_hid = torch.relu(y1h[:, None, :] + cache["desc_proj"][None])
        # y2 as a multiply-reduce over the hidden axis.
        y = (y_hid * self.y2.weight[0][None, None, :]).sum(-1) + self.y2.bias
        if split:
            y = self.tp.whole(y)              # every class, for the softmax

        # Confidence-weighted description mixing; scores detached
        # (model.py:441).
        y_scores = torch.softmax(y, dim=-1).detach()
        if self.desc_attn:
            if split:
                lo, hi = cache["classes"]
                wd_inp = self.tp.reduce(torch.einsum(
                    "bd,bdv->bv", y_scores[:, lo:hi], descs))
            else:
                wd_inp = torch.einsum("bd,bdv->bv", y_scores, descs)
        else:
            wd_inp = y_scores @ cache["desc"]
        h_w = torch.tanh(w_h_out + self.w_d(wd_inp))
        return s_logits, y, self.w(h_w)
