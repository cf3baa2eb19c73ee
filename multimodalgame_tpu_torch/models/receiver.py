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
fused ``h_z`` head matmul. Description attention is not ported yet and
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from multimodalgame_tpu_torch.models.gru import GRUCell
from multimodalgame_tpu_torch.models.init import init_linear_


class Receiver(nn.Module):
    def __init__(self, z_dim: int, desc_dim: int, hid_dim: int,
                 out_dim: int, w_dim: int, s_dim: int,
                 desc_attn: bool = False):
        super().__init__()
        if desc_attn:
            raise NotImplementedError(
                "description attention is not ported to PyTorch yet")
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
        self.hid_dim = hid_dim
        self.desc_dim = desc_dim
        self.rnn = GRUCell(z_dim, hid_dim)
        self.w_h = nn.Linear(hid_dim, hid_dim)
        self.w_d = nn.Linear(desc_dim, hid_dim, bias=False)
        self.w = nn.Linear(hid_dim, w_dim)
        self.y1 = nn.Linear(hid_dim + desc_dim, hid_dim)
        self.y2 = nn.Linear(hid_dim, out_dim)
        self.s = nn.Linear(hid_dim, s_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.rnn.reset_parameters(generator)
        for layer in (self.w_h, self.w_d, self.w, self.y1, self.y2, self.s):
            init_linear_(layer, generator)

    def precompute(self, desc: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Conversation-invariant pieces: the description block of ``y1``
        applied to the CBOW matrix ``desc`` ``(D, wv)`` -> ``(D, hid)``,
        and the fused ``h_z`` head matrix ``[s | y1_h | w_h]``."""
        hid = self.hid_dim
        k_desc = self.y1.weight[:, hid:]                  # (hid, desc)
        return {
            "desc": desc,
            "desc_proj": desc @ k_desc.t(),
            "hz_w": torch.cat([self.s.weight, self.y1.weight[:, :hid],
                               self.w_h.weight], dim=0),  # (1+2hid, hid)
            "hz_b": torch.cat([self.s.bias, self.y1.bias, self.w_h.bias]),
        }

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
        y1h = fused[:, 1:1 + hid]             # h_z @ y1_h + y1_bias
        w_h_out = fused[:, 1 + hid:1 + 2 * hid]

        # y1 with build_inp's concat order [h_z, desc] (model.py:548),
        # then y2 as a multiply-reduce over the hidden axis.
        y_hid = torch.relu(y1h[:, None, :] + cache["desc_proj"][None])
        y = (y_hid * self.y2.weight[0][None, None, :]).sum(-1) + self.y2.bias

        # Confidence-weighted description mixing; scores detached
        # (model.py:441).
        y_scores = torch.softmax(y, dim=-1).detach()
        wd_inp = y_scores @ cache["desc"]
        h_w = torch.tanh(w_h_out + self.w_d(wd_inp))
        return s_logits, y, self.w(h_w)
