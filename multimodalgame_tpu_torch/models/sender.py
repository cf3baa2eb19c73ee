"""Sender agent: image features + the Receiver's last query -> message
logits.

Parity target: reference ``Sender`` (model.py:49-238), as ported in
``multimodalgame_tpu/models/sender.py``:

    h_x = image_layer(x)
    h_w = code_layer(sigmoid(code_bias))   at t == 0  (model.py:196-200)
        = code_layer(w)                    at t  > 0
    feats = binary_layer(tanh(mix(h_x, h_w)))   mix in {sum, prod}
                                                 (model.py:208-221)

``ignore_code`` drops ``h_w`` from the mix. The module emits logits only;
rounding and sampling live in the exchange. Visual attention and the
``mou`` mix are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from multimodalgame_tpu_torch.models.init import init_linear_, std_normal_


class Sender(nn.Module):
    def __init__(self, feat_dim: int, h_dim: int, w_dim: int,
                 bin_dim_out: int, use_attn: bool = False,
                 sender_mix: str = "sum",
                 ignore_code: bool = False):
        super().__init__()
        if use_attn:
            raise NotImplementedError(
                "visual attention is not ported to PyTorch yet")
        if sender_mix not in ("sum", "prod"):
            raise NotImplementedError(
                f"sender_mix={sender_mix!r} is not ported to PyTorch yet")
        self.sender_mix = sender_mix
        self.ignore_code = ignore_code
        self.code_bias = nn.Parameter(torch.empty(bin_dim_out))
        self.image_layer = nn.Linear(feat_dim, h_dim)
        self.code_layer = nn.Linear(w_dim, h_dim)
        self.binary_layer = nn.Linear(h_dim, bin_dim_out)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        std_normal_(self.code_bias, generator)
        for layer in (self.image_layer, self.code_layer, self.binary_layer):
            init_linear_(layer, generator)

    def precompute(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Conversation-invariant projections: ``h_x`` ``(B, h_dim)`` and
        the first turn's code ``code_layer(sigmoid(code_bias))``
        ``(1, h_dim)``, which depends on parameters only."""
        return {
            "h_x": self.image_layer(x),
            "h_w_first": self.code_layer(
                torch.sigmoid(self.code_bias)[None, :]),
        }

    def step(self, w: torch.Tensor, t: int,
             cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One sender turn on the Receiver's previous query ``w``
        ``(B, w_dim)``: the message logits ``(B, bin_dim_out)``."""
        h_x = cache["h_x"]
        if self.ignore_code:
            mixed = torch.tanh(h_x)
        else:
            if t == 0:
                h_w = cache["h_w_first"].expand_as(h_x)
            else:
                h_w = self.code_layer(w)
            if self.sender_mix == "prod":
                mixed = torch.tanh(h_x * h_w)
            else:
                mixed = torch.tanh(h_x + h_w)
        return self.binary_layer(mixed)

    def step_all(self, w_prev: torch.Tensor,
                 cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Every turn at once, given the query each turn saw,
        ``w_prev`` ``(T, B, w_dim)`` (turn 0's is not read): the message
        logits ``(T, B, bin_dim_out)``. The training fast path's batched
        recompute (game/fast_train.py)."""
        h_x = cache["h_x"]
        turns = w_prev.shape[0]
        if self.ignore_code:
            mixed = torch.tanh(h_x).expand(turns, *h_x.shape)
        else:
            h_w = torch.cat([cache["h_w_first"].expand_as(h_x)[None],
                             self.code_layer(w_prev[1:])], dim=0)
            if self.sender_mix == "prod":
                mixed = torch.tanh(h_x * h_w)
            else:
                mixed = torch.tanh(h_x + h_w)
        return self.binary_layer(mixed)
