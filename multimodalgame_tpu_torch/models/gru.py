"""GRU cell in the reference's ``nn.GRUCell`` parameter layout.

The reference Receiver's recurrence (model.py:256, 340):

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Parameters are torch's stacked ``[r | z | n]`` matrices, ``weight_ih``
``(3H, in)`` and ``weight_hh`` ``(3H, H)``, so a reference checkpoint's
``rnn.*`` entries load as they are. The gate math is written out (not
``torch.nn.GRUCell``) so the plain path reads line by line like the CUDA
kernel (csrc/fused_exchange.cu).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodalgame_tpu_torch.models.init import xavier_normal_


class GRUCell(nn.Module):
    def __init__(self, in_dim: int, hid_dim: int):
        super().__init__()
        self.in_dim = in_dim
        self.hid_dim = hid_dim
        self.weight_ih = nn.Parameter(torch.empty(3 * hid_dim, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(3 * hid_dim, hid_dim))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hid_dim))
        self.bias_hh = nn.Parameter(torch.zeros(3 * hid_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-normal over the stacked fan (model.py:281-288), zero
        biases."""
        H = self.hid_dim
        xavier_normal_(self.weight_ih, generator,
                       fan_override=(self.in_dim, 3 * H))
        xavier_normal_(self.weight_hh, generator, fan_override=(H, 3 * H))
        self.bias_ih.zero_()
        self.bias_hh.zero_()

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gi = x @ self.weight_ih.t() + self.bias_ih
        gh = h @ self.weight_hh.t() + self.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h
