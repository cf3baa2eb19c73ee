"""Philox4x32-10 uniforms, frozen for the benchmark's reference.

The port's training kernel draws its Bernoulli bits from Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11)
keyed by ``(seed, step)``. This copy computes the same numbers in plain
PyTorch so that the reference can sample the same bits without importing
anything of the program.

Layout: the uniform of stream ``k``, turn ``t``, batch row ``r`` and
column ``c`` is word ``c % 4`` of ``philox(counter=(c // 4, r, t, k),
key=(seed, step))``, as ``(x >> 8) * 2**-24``. Streams: ``z`` 0, ``s`` 2,
``w`` 3 (the message, stop and query bits of a training conversation).
Words are 32-bit unsigned integers held in int64 tensors.
"""

from typing import Dict

import torch

STREAMS = {"z": 0, "fz": 1, "s": 2, "w": 3, "fw": 4}
_MASK = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    p = a * m
    return (p >> 32) & _MASK, p & _MASK


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Ten rounds of Philox4x32 on int64 tensors of 32-bit words."""
    k0, k1 = k0 & _MASK, k1 & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK, (k1 + 0xBB67AE85) & _MASK
    return c0, c1, c2, c3


def train_uniforms(widths: Dict[str, int], turns: int, batch: int,
                   seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    """``{name: (turns, batch, widths[name])}`` float32 uniforms of one
    training step, rows 0 to ``batch - 1``."""
    out = {}
    for name, width in widths.items():
        quads = -(-width // 4)
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
        shape = (turns, batch, quads)
        c0 = ar(quads).view(1, 1, -1).expand(shape)
        c1 = ar(batch).view(1, -1, 1).expand(shape)
        c2 = ar(turns).view(-1, 1, 1).expand(shape)
        c3 = torch.full(shape, STREAMS[name], dtype=torch.int64,
                        device=device)
        words = philox(c0, c1, c2, c3, seed, step)
        x = torch.stack(words, dim=-1).reshape(turns, batch, 4 * quads)
        out[name] = ((x >> 8).to(torch.float32) * 2.0 ** -24)[..., :width]
    return out
