"""Philox4x32-10 uniforms: the plain version of the train-mode kernel's
random numbers.

Counterpart of ``multimodalgame_tpu/ops/pallas_exchange.py:_uniform01``
(75-81), which draws from the TPU core's own generator. A Hopper kernel
cannot reproduce those bits, so the port's kernel (csrc/fused_exchange.cu,
train mode) runs Philox4x32-10 (Salmon et al., SC'11, the Random123
generator) keyed by ``(seed, step)``. This module computes the same
numbers in torch, on any device: the plain sampler's uniforms, the CPU
path of the kernel's wrapper, and the tests.

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

A shard of a data-parallel batch (``parallel/mesh.py``) whose first row
is global row ``row_base`` draws with ``row_base``: its row ``r`` takes
the counter of global row ``row_base + r``, so the shards' draws are the
rows of the whole batch's draw.

Member ``m`` of a population (``parallel/population.py``) draws what a
single game draws, training streams and eval slots alike, with the first
counter word ``c // 4`` raised by ``(m + 1) << 16``
(:data:`MEMBER_SHIFT`): ``counter = (((m + 1) << 16) + c // 4, r, t, k)``
under the same key ``(seed, step)``. A single game's first counter word
is below ``2**16`` for every width below ``2**18``, so no member shares a
counter with a single game's training streams or eval slots, nor with
another member. :func:`member_uniforms` draws every member of a step in
one vectorized call on the population's device; a shard of the member
axis whose first member is ``member_base`` draws those members' numbers.

The words are 32-bit unsigned integers held in int64 tensors. A product
of two of them wraps around in int64, but its low 64 bits are exact, so
its high and low words are bits 32-63 and 0-31 (:func:`_mulhilo`).

The key ``(seed, step)`` and the row base are Python integers or 0-dim
int64 tensors on the draw's device (a captured training step's key, which
the step advances on the device itself, ``game/train.py``,
``parallel/population.py``); both give the
same numbers bit for bit. Every index the draw needs is made on the
device (``arange``, ``fill_``), never copied from the host, so a draw can
be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from multimodalgame_tpu_torch.ops.sampling import uniform_widths

# Stream index of each uniform set (the JAX exchange's split order).
STREAMS = {"z": 0, "fz": 1, "s": 2, "w": 3, "fw": 4}
# Counter-word stride between the eval slots, above the training streams.
EVAL_SLOT_STRIDE = 8
EVAL_DUMP_SLOT = 0
# Member m's first counter word is offset by (m + 1) << MEMBER_SHIFT.
MEMBER_SHIFT = 16

_MASK32 = 0xFFFFFFFF

# A key word or a row base: a Python integer or a 0-dim int64 tensor.
Word = Union[int, torch.Tensor]


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The high and low 32-bit words of ``m * a`` for 32-bit ``a`` held in
    int64 (the product's low 64 bits survive its wraparound)."""
    p = a * m
    return (p >> 32) & _MASK32, p & _MASK32


def philox4x32_10(counter, key: Tuple[Word, Word]
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32 with 10 rounds.

    ``counter`` is four broadcastable int64 tensors (or integers) holding
    32-bit words ``(c0, c1, c2, c3)``, ``key`` two 32-bit words (integers
    or 0-dim int64 tensors on the counter's device). Returns the four
    output words, int64 tensors of the broadcast shape on the counter's
    device."""
    dev = next((c.device for c in counter if isinstance(c, torch.Tensor)),
               None)
    c0, c1, c2, c3 = torch.broadcast_tensors(*(
        torch.as_tensor(c, dtype=torch.int64, device=dev) for c in counter))
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def _ints(values: Sequence[int], device) -> torch.Tensor:
    """A 1-D int64 tensor of ``values``, made on ``device`` by fills
    rather than copied from the host."""
    out = torch.empty(len(values), dtype=torch.int64, device=device)
    for i, v in enumerate(values):
        out[i:i + 1].fill_(v)
    return out


def _draw(streams: Dict[str, int], widths: Dict[str, int], turns: int,
          batch: int, seed: Word, step: Word, members: Optional[int],
          device, row_base: Word = 0, member_base: int = 0
          ) -> Dict[str, torch.Tensor]:
    """Each set ``name``'s ``(turns, batch, widths[name])`` float32
    uniforms on stream ``streams[name]`` (with a leading ``members`` axis
    and the member in the first counter word, when ``members`` is given),
    in one vectorized call on ``device`` (the CPU by default). Rows are
    the global rows ``row_base + r``, members ``member_base + m``."""
    names = list(widths)
    quads = -(-max(widths.values()) // 4)
    dev = torch.device(device or "cpu")

    def axis(values: torch.Tensor, dim):
        shape = [1] * 5
        shape[dim] = -1
        return values.reshape(shape)

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=dev)

    # (streams, members, turns, rows, column quads)
    q = axis(arange(quads), 4)
    word0 = q if members is None else (
        (axis(arange(members) + (member_base + 1), 1)) << MEMBER_SHIFT) + q
    shape = (len(names), members or 1, turns, batch, quads)
    words = philox4x32_10(
        tuple(w.expand(shape) for w in (
            word0, axis(arange(batch) + row_base, 3), axis(arange(turns), 2),
            axis(_ints([streams[n] for n in names], dev), 0))),
        (seed, step))
    x = torch.stack(words, dim=-1).reshape(shape[:-1] + (4 * quads,))
    u = (x >> 8).to(torch.float32) * (2.0 ** -24)
    if members is None:
        u = u[:, 0]
    return {n: u[i, ..., :widths[n]].contiguous()
            for i, n in enumerate(names)}


def uniforms_for(stream: int, turns: int, batch: int, width: int,
                 seed: Word, step: Word, device=None,
                 row_base: Word = 0) -> torch.Tensor:
    """The ``(turns, batch, width)`` float32 uniforms of one stream, for
    global rows ``row_base`` on."""
    return _draw({"u": stream}, {"u": width}, turns, batch, seed, step,
                 None, device, row_base)["u"]


def philox_uniforms(cfg, batch: int, seed: Word, step: Word,
                    device=None, row_base: Word = 0
                    ) -> Dict[str, torch.Tensor]:
    """The uniforms the train-mode kernel draws for ``(seed, step)``:
    ``{s, z, w[, fz, fw]}``, each ``(max_exchange, batch, dim)`` float32,
    on ``device`` (the CPU by default), for global rows ``row_base`` to
    ``row_base + batch - 1`` (a data-parallel shard's rows)."""
    return _draw(STREAMS, uniform_widths(cfg, train=True), cfg.max_exchange,
                 batch, seed, step, None, device, row_base)


def _eval_streams(slot: int) -> Dict[str, int]:
    """The stream numbers of eval slot ``slot``."""
    return {name: EVAL_SLOT_STRIDE * (1 + slot) + index
            for name, index in STREAMS.items()}


def philox_eval_uniforms(cfg, batch: int, seed: Word, step: Word,
                         slot: int, device=None, row_base: Word = 0
                         ) -> Optional[Dict[str, torch.Tensor]]:
    """The ``fz``/``fw`` uniforms of one eval conversation under
    ``flipout_dev``, keyed by ``(seed, step)`` and ``slot``, each
    ``(max_exchange, batch, dim)`` float32 on ``device``, for global rows
    ``row_base`` on; ``None`` when the config's eval conversation draws
    nothing."""
    widths = uniform_widths(cfg, train=False)
    if not widths:
        return None
    return _draw(_eval_streams(slot), widths, cfg.max_exchange, batch, seed,
                 step, None, device, row_base)


def member_uniforms(cfg, batch: int, seed: Word, step: Word, members: int,
                    device=None, slot: Optional[int] = None,
                    member_base: int = 0
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The uniforms of population members ``member_base`` to
    ``member_base + members - 1`` for ``(seed, step)``, drawn in one
    vectorized call on ``device`` (the CPU by default): each ``(members,
    max_exchange, batch, dim)`` float32. With ``slot`` None the training
    streams (``{s, z, w[, fz, fw]}``), else the eval slot's ``fz``/``fw``
    under ``flipout_dev`` (``None`` when the eval conversation draws
    nothing). ``seed`` and ``step`` are integers or 0-dim int64 tensors
    on ``device`` (a captured population step's counter), bit for bit
    the same numbers; ``member_base`` is fixed per rank, an integer."""
    widths = uniform_widths(cfg, train=slot is None)
    if not widths:
        return None
    streams = STREAMS if slot is None else _eval_streams(slot)
    return _draw(streams, widths, cfg.max_exchange, batch, seed, step,
                 members, device, member_base=member_base)
