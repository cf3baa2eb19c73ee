"""REINFORCE value-baseline network.

Parity target: reference ``Baseline`` (model.py:480-516), as ported in
``multimodalgame_tpu/models/baseline.py``: ``linear2(relu(linear1(cat)))``
over the concatenation of whichever of ``(x, binary, inp)`` are given,
regressing the per-example log-likelihood reward. The Sender baseline
takes ``(h_x, z_r)`` (model.py:834-836), the Receiver baseline
``(z_s, h_z)`` (model.py:841-843).

The reference never resets a Baseline, so its parameters keep PyTorch's
default Linear init (models/init.py), drawn here from the caller's
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalgame_tpu_torch.models.init import (torch_default_bias,
                                                  torch_default_linear)


class Baseline(nn.Module):
    def __init__(self, hid_dim: int, x_dim: int, binary_dim: int,
                 inp_dim: int):
        super().__init__()
        self.tp = None      # the tensor-parallel seam (parallel/tensor.py)
        self.in_dim = x_dim + binary_dim + inp_dim
        self.linear1 = nn.Linear(self.in_dim, hid_dim)
        self.linear2 = nn.Linear(hid_dim, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.linear1, self.linear2):
            torch_default_linear(layer.weight, generator)
            torch_default_bias(layer.bias, layer.in_features, generator)

    def forward(self, x: Optional[torch.Tensor],
                binary: Optional[torch.Tensor],
                inp: Optional[torch.Tensor]) -> torch.Tensor:
        """Scores ``(..., 1)``; the inputs share their leading dims and are
        joined along the last one in the order ``x, binary, inp``."""
        features = torch.cat([f for f in (x, binary, inp) if f is not None],
                             dim=-1)
        if self.tp is None or not self.tp.column:
            return self.linear2(torch.relu(self.linear1(features)))
        # Megatron's block: linear1 column-parallel, linear2 row-parallel.
        hidden = torch.relu(self.tp.column_linear(self.linear1, features))
        return self.tp.row_linear(self.linear2, hidden)
