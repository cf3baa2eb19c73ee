"""Philox4x32-10 uniforms: the plain version of the train-mode kernel's
random numbers.

Counterpart of ``multimodalgame_tpu/ops/pallas_exchange.py:_uniform01``
(75-81), which draws from the TPU core's own generator. A Hopper kernel
cannot reproduce those bits, so the port's kernel (csrc/fused_exchange.cu,
train mode) runs Philox4x32-10 (Salmon et al., SC'11, the Random123
generator) keyed by ``(seed, step)``. This module computes the same
numbers with numpy, for the CPU path and the tests.

Layout, the kernel's own: the uniform of stream ``k``, turn ``t``, global
batch row ``r`` and column ``c`` is word ``c % 4`` of
``philox(counter=(c // 4, r, t, k), key=(seed, step))``. It depends on
nothing else, so the numbers do not change with the kernel's row tiling
or the batch size (row ``r`` of a batch of 100 equals row ``r`` of a batch
of 7), and a step's numbers depend only on its global step index, so
splitting a run into chunks cannot change its trajectory. Streams are
numbered as the JAX exchange orders its per-turn keys
(game/exchange.py:155-180). A uniform is ``(x >> 8) * 2**-24``: 24 bits,
exact in float32, in ``[0, 1)``.

An eval conversation under ``flipout_dev`` draws its ``fz``/``fw`` from
the same generator, on counter words ``8 * (1 + slot) + stream`` that no
training stream uses (:func:`philox_eval_uniforms`): slot
:data:`EVAL_DUMP_SLOT` for a log window's eval dump, slot ``1 + i`` for
batch ``i`` of a dev sweep.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multimodalgame_tpu_torch.ops.sampling import uniform_widths

# Stream index of each uniform set (the JAX exchange's split order).
STREAMS = {"z": 0, "fz": 1, "s": 2, "w": 3, "fw": 4}
# Counter-word stride between the eval slots, above the training streams.
EVAL_SLOT_STRIDE = 8
EVAL_DUMP_SLOT = 0

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint32(0x9E3779B9), np.uint32(0xBB67AE85)
_LO = np.uint64(0xFFFFFFFF)


def philox4x32_10(counter: Tuple[np.ndarray, ...], key: Tuple[int, int]
                  ) -> Tuple[np.ndarray, ...]:
    """Philox4x32 with 10 rounds on broadcastable uint32 arrays.

    ``counter`` is four arrays ``(c0, c1, c2, c3)``, ``key`` two 32-bit
    integers. Returns the four output words."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint32) for c in counter)
    c0, c1, c2, c3 = np.broadcast_arrays(c0, c1, c2, c3)
    k0, k1 = np.uint32(key[0] & 0xFFFFFFFF), np.uint32(key[1] & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        for _ in range(10):
            p0 = _M0 * c0.astype(np.uint64)
            p1 = _M1 * c2.astype(np.uint64)
            hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), \
                (p0 & _LO).astype(np.uint32)
            hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), \
                (p1 & _LO).astype(np.uint32)
            c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
            k0, k1 = k0 + _W0, k1 + _W1
    return c0, c1, c2, c3


def uniforms_for(stream: int, turns: int, batch: int, width: int,
                 seed: int, step: int) -> np.ndarray:
    """The ``(turns, batch, width)`` float32 uniforms of one stream."""
    t = np.arange(turns, dtype=np.uint32)[:, None, None]
    r = np.arange(batch, dtype=np.uint32)[None, :, None]
    c = np.arange(width, dtype=np.uint32)[None, None, :]
    words = philox4x32_10((c >> np.uint32(2), r, t, np.uint32(stream)),
                          (seed, step))
    stacked = np.stack(words, axis=-1)                  # (T, B, W, 4)
    x = np.take_along_axis(stacked, (c % 4)[..., None].astype(np.intp),
                           axis=-1)[..., 0]
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def philox_uniforms(cfg, batch: int, seed: int, step: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """The uniforms the train-mode kernel draws for ``(seed, step)``:
    ``{s, z, w[, fz, fw]}``, each ``(max_exchange, batch, dim)`` float32,
    on ``device`` (the CPU by default)."""
    return {name: torch.from_numpy(uniforms_for(
        STREAMS[name], cfg.max_exchange, batch, width, seed, step)).to(
            device or "cpu")
        for name, width in uniform_widths(cfg, train=True).items()}


def philox_eval_uniforms(cfg, batch: int, seed: int, step: int, slot: int,
                         device=None) -> Optional[Dict[str, torch.Tensor]]:
    """The ``fz``/``fw`` uniforms of one eval conversation under
    ``flipout_dev``, keyed by ``(seed, step)`` and ``slot``, each
    ``(max_exchange, batch, dim)`` float32 on ``device``; ``None`` when the
    config's eval conversation draws nothing."""
    widths = uniform_widths(cfg, train=False)
    if not widths:
        return None
    base = EVAL_SLOT_STRIDE * (1 + slot)
    return {name: torch.from_numpy(uniforms_for(
        base + STREAMS[name], cfg.max_exchange, batch, width, seed,
        step)).to(device or "cpu")
        for name, width in widths.items()}
