"""Sender agent: image features + the Receiver's last query -> message
logits.

Parity target: reference ``Sender`` (model.py:49-238), as ported in
``multimodalgame_tpu/models/sender.py``:

    h_x = image_layer(x)                   x optionally attention-pooled
    h_w = code_layer(sigmoid(code_bias))   at t == 0  (model.py:196-200)
        = code_layer(w)                    at t  > 0
    feats = binary_layer(tanh(mix(h_x, h_w)))   mix in {sum, prod, mou}
                                                 (model.py:208-221)

``mou`` feeds ``[h_x, h_w, h_x - h_w, h_x * h_w]`` to a ``binary_layer``
of input width ``4 * h_dim``. ``ignore_code`` drops ``h_w`` from the sum
and prod mixes; with ``mou`` it replaces the query's code at t > 0 by a
second learned constant, ``code_layer(sigmoid(code_bias_mou))``
(model.py:201-205).

Visual attention (model.py:114-142, 168-191) pools the ``(B, C, H, W)``
feature map over its ``N = H * W`` positions with the scores
``softmax(U tanh(W_w w + W_x x_n [+ W_g g]))``, uniform ``1/N`` at
t == 0, so ``h_x`` is computed every turn. The module emits logits only;
rounding and sampling live in the exchange.

Under tensor parallelism (``parallel/tensor.py``) ``tp`` is the agent's
seam: ``image_layer`` and ``code_layer`` give this rank's block of the
hidden width, ``binary_layer`` is row-parallel (partial products summed
over the model axis) and the ``h_x`` handed to the baseline is whole.
``None`` (the default) is the single-device path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodalgame_tpu_torch.models.init import init_linear_, std_normal_

MIXES = ("sum", "prod", "mou")


class Sender(nn.Module):
    def __init__(self, feat_dim: int, h_dim: int, w_dim: int,
                 bin_dim_out: int, use_attn: bool = False,
                 attn_dim: int = 256, attn_extra_context: bool = False,
                 attn_context_dim: int = 4096, sender_mix: str = "sum",
                 ignore_code: bool = False):
        super().__init__()
        if sender_mix not in MIXES:
            raise ValueError(f"sender_mix must be one of {MIXES}, got "
                             f"{sender_mix!r}")
        self.tp = None
        self.use_attn = use_attn
        self.attn_extra_context = use_attn and attn_extra_context
        self.sender_mix = sender_mix
        self.ignore_code = ignore_code
        # Registration order is the reference's, so that optimizer slots
        # keep their positions (JAX utils/torch_interop.py:129-136).
        self.code_bias = nn.Parameter(torch.empty(bin_dim_out))
        if sender_mix == "mou" and ignore_code:
            self.code_bias_mou = nn.Parameter(torch.empty(bin_dim_out))
        self.image_layer = nn.Linear(feat_dim, h_dim)
        self.code_layer = nn.Linear(w_dim, h_dim)
        self.binary_layer = nn.Linear(
            4 * h_dim if sender_mix == "mou" else h_dim, bin_dim_out)
        if use_attn:
            self.attn_W_x = nn.Linear(feat_dim, attn_dim)
            self.attn_W_w = nn.Linear(w_dim, attn_dim)
            self.attn_U = nn.Linear(attn_dim, 1)
            if attn_extra_context:
                self.attn_W_g = nn.Linear(attn_context_dim, attn_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        std_normal_(self.code_bias, generator)
        if hasattr(self, "code_bias_mou"):
            std_normal_(self.code_bias_mou, generator)
        for layer in self.children():
            init_linear_(layer, generator)

    def precompute(self, x: torch.Tensor, g: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Conversation-invariant pieces: the first turn's code
        ``code_layer(sigmoid(code_bias))`` ``(1, h_dim)`` (and the
        ``mou`` + ``ignore_code`` constant code); without attention
        ``h_x`` ``(B, h_dim)``; with it the flattened map ``x_flat``
        ``(B, N, C)``, its keys ``attn_W_x(x_flat)`` and, with the
        context ``g`` ``(B, context)``, ``attn_W_g(g)`` ``(B, 1, A)``."""
        cache = {"h_w_first": self._column(
            self.code_layer, torch.sigmoid(self.code_bias)[None, :])}
        if hasattr(self, "code_bias_mou"):
            cache["h_w_mou"] = self._column(
                self.code_layer, torch.sigmoid(self.code_bias_mou)[None, :])
        if not self.use_attn:
            cache["h_x"] = self._column(self.image_layer, x)
            cache["h_x_whole"] = self._whole(cache["h_x"])
            return cache
        x_flat = x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)
        cache["x_flat"] = x_flat
        cache["h_x_attn"] = self.attn_W_x(x_flat)
        if self.attn_extra_context:
            cache["h_g"] = self.attn_W_g(g)[:, None, :]
        return cache

    def _attend(self, w: torch.Tensor, cache: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """Attention scores over the map's positions for queries ``w``
        ``(..., B, w_dim)``: ``(..., B, N)``, a softmax over N."""
        pre = self.attn_W_w(w)[..., None, :] + cache["h_x_attn"]
        if self.attn_extra_context:
            pre = pre + cache["h_g"]
        return torch.softmax(self.attn_U(torch.tanh(pre))[..., 0], dim=-1)

    def _column(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer: this rank's block of its outputs under
        tensor parallelism, else all of them."""
        return layer(x) if self.tp is None else self.tp.column_linear(
            layer, x)

    def _whole(self, h_x: torch.Tensor) -> torch.Tensor:
        """``h_x`` over the whole hidden width (the baseline's input)."""
        if self.tp is None or not self.tp.column:
            return h_x
        return self.tp.whole(h_x)

    def _binary(self, h_x: torch.Tensor,
                h_w: Optional[torch.Tensor]) -> torch.Tensor:
        """``binary_layer`` of the mix. Row-parallel under tensor
        parallelism: on the mix's own block where the shards line up
        (sum and prod on sharded columns), else on this rank's block of
        the whole mix (``mou``, whose ``4 * h_dim`` rows are blocked
        apart from the hidden width's, or replicated columns)."""
        tp = self.tp
        if tp is None or not tp.row:
            return self.binary_layer(self._mix(h_x, h_w))
        if tp.column and self.sender_mix != "mou":
            local = self._mix(h_x, h_w)
        else:
            local = tp.own(self._mix(
                self._whole(h_x), None if h_w is None else self._whole(h_w)))
        return tp.row_linear(self.binary_layer, local)

    def _mix(self, h_x: torch.Tensor, h_w: torch.Tensor) -> torch.Tensor:
        if self.sender_mix == "mou":
            return torch.tanh(torch.cat([h_x, h_w, h_x - h_w, h_x * h_w],
                                        dim=-1))
        if self.ignore_code:
            return torch.tanh(h_x)
        if self.sender_mix == "prod":
            return torch.tanh(h_x * h_w)
        return torch.tanh(h_x + h_w)

    def _later_code(self, w: torch.Tensor, cache: Dict[str, torch.Tensor]
                    ) -> Optional[torch.Tensor]:
        """``h_w`` of turns t > 0: the constant ``mou`` code under
        ``ignore_code``, nothing for the other mixes under it, else
        ``code_layer(w)``."""
        if "h_w_mou" in cache:
            return cache["h_w_mou"]
        if self.ignore_code:
            return None
        return self._column(self.code_layer, w)

    def step(self, w: torch.Tensor, t: int, cache: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """One sender turn on the Receiver's previous query ``w``
        ``(B, w_dim)``: ``(logits (B, bin_dim_out), h_x (B, h_dim),
        attn_scores (B, N) or None)``. ``h_x`` feeds the Sender baseline
        (model.py:832-836)."""
        attn = None
        if self.use_attn:
            x_flat = cache["x_flat"]
            if t == 0:
                attn = x_flat.new_full(x_flat.shape[:2],
                                       1.0 / x_flat.shape[1])
            else:
                attn = self._attend(w, cache)
            h_x = self._column(self.image_layer,
                               torch.einsum("bn,bnc->bc", attn, x_flat))
            h_x_whole = self._whole(h_x)
        else:
            h_x, h_x_whole = cache["h_x"], cache["h_x_whole"]
        h_w = (cache["h_w_first"] if t == 0
               else self._later_code(w, cache))
        h_w = None if h_w is None else h_w.expand_as(h_x)
        return self._binary(h_x, h_w), h_x_whole, attn

    def step_all(self, w_prev: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
        """Every turn at once, given the query each turn saw,
        ``w_prev`` ``(T, B, w_dim)`` (turn 0's is not read): what
        :meth:`step` gives, each stacked over T. The training fast path's
        batched recompute (game/fast_train.py)."""
        turns = w_prev.shape[0]
        attn = None
        if self.use_attn:
            x_flat = cache["x_flat"]
            first = x_flat.new_full((1,) + x_flat.shape[:2],
                                    1.0 / x_flat.shape[1])
            attn = torch.cat([first, self._attend(w_prev[1:], cache)])
            h_x = self._column(self.image_layer,
                               torch.einsum("tbn,bnc->tbc", attn, x_flat))
            h_x_whole = self._whole(h_x)
        else:
            h_x = cache["h_x"].expand(turns, *cache["h_x"].shape)
            h_x_whole = cache["h_x_whole"].expand(
                turns, *cache["h_x_whole"].shape)
        later = self._later_code(w_prev[1:], cache)
        h_w = None
        if later is not None:
            shape = (turns - 1,) + h_x.shape[1:]
            h_w = torch.cat([cache["h_w_first"].expand_as(h_x[0])[None],
                             later.expand(shape)])
        return self._binary(h_x, h_w), h_x_whole, attn
