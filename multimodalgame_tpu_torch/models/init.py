"""Weight initialization matching the reference's schemes.

The reference applies Xavier-normal (misc.py:349-385) to every
Linear/GRU weight matrix with zero biases (model.py:90-97, 275-288) and
draws the Sender's ``code_bias`` from a standard normal (model.py:97).
The stacked GRU matrices take their fan over the whole ``[r|z|n]`` stack
(model.py:281-288). The Baseline networks are never reset, so they keep
PyTorch's default Linear init, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for
weight and bias alike (model.py:480-516).

Tensors here are in torch layout: a Linear ``weight`` is ``(out, in)``,
so ``fan_in = shape[1]`` and ``fan_out = shape[0]``. Randomness comes
from a ``torch.Generator``; the values match the JAX init in
distribution, not element by element.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


@torch.no_grad()
def xavier_normal_(weight: torch.Tensor, generator: torch.Generator,
                   fan_override: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """In place ``N(0, sqrt(2 / (fan_in + fan_out)))``.

    ``fan_override=(fan_in, fan_out)`` covers the stacked-GRU case."""
    if fan_override is not None:
        fan_in, fan_out = fan_override
    else:
        fan_out, fan_in = weight.shape
    std = math.sqrt(2.0 / (fan_in + fan_out))
    sample = torch.randn(weight.shape, generator=generator,
                         dtype=weight.dtype, device=generator.device)
    return weight.copy_(sample.mul_(std))


@torch.no_grad()
def std_normal_(tensor: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """In place standard normal (the Sender's ``code_bias``)."""
    sample = torch.randn(tensor.shape, generator=generator,
                         dtype=tensor.dtype, device=generator.device)
    return tensor.copy_(sample)


@torch.no_grad()
def init_linear_(layer: torch.nn.Linear,
                 generator: torch.Generator) -> None:
    """Xavier-normal weight, zero bias (model.py:90-97)."""
    xavier_normal_(layer.weight, generator)
    if layer.bias is not None:
        layer.bias.zero_()


@torch.no_grad()
def torch_default_linear(weight: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
    """In place ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` on a ``(out, in)``
    Linear weight: PyTorch's default, drawn from ``generator``."""
    return _uniform_(weight, 1.0 / math.sqrt(weight.shape[1]), generator)


@torch.no_grad()
def torch_default_bias(bias: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> torch.Tensor:
    """In place ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` on a Linear bias."""
    return _uniform_(bias, 1.0 / math.sqrt(fan_in), generator)


def _uniform_(tensor: torch.Tensor, bound: float,
              generator: torch.Generator) -> torch.Tensor:
    sample = torch.rand(tensor.shape, generator=generator,
                        dtype=tensor.dtype, device=generator.device)
    return tensor.copy_(sample.mul_(2.0 * bound).sub_(bound))
