"""The rotation of q and k in each block of Qwen2.5-VL's vision tower
(``models/qwen_vision.py:VisionTower``) as one CUDA kernel, which also
writes q, k and v where attention reads them.

The kernel source is ``csrc/vision_rotary.cu``, compiled for ``sm_90a``
at first use and called through ``ctypes`` (``ops/cuda_build.py``).
:func:`rotary_qkv` takes the qkv product ``(B, N, 3C)`` as ``F.linear``
leaves it (its bias added) and returns q, k and v, each ``(B * N, heads,
d)``: q and k rotated in float32 and rounded once to the product's
dtype, v as it came, token ``t`` of image ``b`` at row ``B * start + b *
length + (t - start)``, with ``(start, length)`` token ``t``'s entry of
``dest``. A :class:`~multimodalgame_tpu_torch.models.qwen_vision.Layout`
holds two such maps: in a windowed block each window group's ``(B, n,
s)`` windows are one contiguous block (``(B * n, s, heads, d)`` as a
view), in a full block the rows are in ``(B, N)`` order.

The wrapper launches the kernel for a CUDA tensor (a failed build or
launch raises) and runs its plain version, :func:`rotary_qkv_reference`,
for a CPU one. The kernel runs on PyTorch's current stream and allocates
nothing: the wrapper allocates the output. Each launch adds one to
``rotary_qkv.launches``; a graph that records it adds its count at each
replay (``utils/cuda_graph.py:Captured``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from multimodalgame_tpu_torch.ops import cuda_build

SOURCE = "vision_rotary.cu"
VECTOR_BYTES = 16


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = cuda_build.load(SOURCE)
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.mmg_vit_rotary_qkv.argtypes = [ptr] * 5 + [num] * 5 + [ptr]
    lib.mmg_vit_rotary_qkv.restype = ctypes.c_int
    lib.mmg_vit_error_string.argtypes = [ctypes.c_int]
    lib.mmg_vit_error_string.restype = ctypes.c_char_p
    return lib


def rotate_halves(qk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                  ) -> torch.Tensor:
    """The rotation of q and k together (``qk``: ``(B, N, 2, heads, d)``)
    in float32, back in ``qk``'s dtype: ``x * cos + rotate_half(x) *
    sin``, ``rotate_half`` taken as two multiply-adds on the halves."""
    half = qk.shape[-1] // 2
    out = qk * cos      # float32, as cos is
    out[..., :half].addcmul_(qk[..., half:], sin[..., :half], value=-1)
    out[..., half:].addcmul_(qk[..., :half], sin[..., half:])
    return out.to(qk.dtype)


def destination_rows(dest: torch.Tensor, batch: int) -> torch.Tensor:
    """``(batch, N)``: the output row of token ``t`` of image ``b``,
    ``batch * start + b * length + (t - start)``, from ``dest``'s
    ``(start, length)`` of each token."""
    start, length = dest.long().unbind(1)
    t = torch.arange(dest.shape[0], device=dest.device)
    b = torch.arange(batch, device=dest.device)[:, None]
    return batch * start + b * length + (t - start)


def rotary_qkv_reference(qkv: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, dest: torch.Tensor, heads: int
                         ) -> Tuple[torch.Tensor, ...]:
    """:func:`rotary_qkv`'s plain version: :func:`rotate_halves`, then q,
    k and v copied to their rows."""
    B, N, width = qkv.shape
    d = width // 3 // heads
    x = qkv.reshape(B, N, 3, heads, d)
    q, k = rotate_halves(x[:, :, :2], cos, sin).unbind(2)
    out = qkv.new_empty((3, B * N, heads, d))
    rows = destination_rows(dest, B).reshape(-1)
    for o, t in zip(out, (q, k, x[:, :, 2])):
        o.index_copy_(0, rows, t.reshape(B * N, heads, d))
    return out.unbind(0)


def _check(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           dest: torch.Tensor, heads: int) -> None:
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qkv has dtype {qkv.dtype}, expected bfloat16 or "
                         f"float32")
    if qkv.dim() != 3 or heads <= 0 or qkv.shape[2] % (3 * heads) \
            or qkv.shape[2] // (3 * heads) % 2:
        raise ValueError(f"qkv has shape {tuple(qkv.shape)}, expected (B, "
                         f"N, 3 * {heads} heads of an even width)")
    B, N, width = qkv.shape
    d = width // 3 // heads
    for name, t, dtype, shape in (("cos", cos, torch.float32, (N, 1, 1, d)),
                                  ("sin", sin, torch.float32, (N, 1, 1, d)),
                                  ("dest", dest, torch.int32, (N, 2))):
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    for name, t in (("qkv", qkv), ("cos", cos), ("sin", sin),
                    ("dest", dest)):
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def rotary_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               dest: torch.Tensor, heads: int) -> Tuple[torch.Tensor, ...]:
    """q, k and v ``(B * N, heads, d)`` from the qkv product ``(B, N,
    3C)`` (bfloat16 or float32, contiguous): q and k rotated by the angle
    tables ``cos`` and ``sin`` ``(N, 1, 1, d)`` (float32, both halves of
    each row equal), each token's rows placed by ``dest`` ``(N, 2)``
    (int32 ``(start, length)`` of its group). Views of one ``(3, B * N,
    heads, d)`` buffer. One kernel on a card: the product read once, q, k
    and v written once."""
    _check(qkv, cos, sin, dest, heads)
    if qkv.device.type != "cuda":
        return rotary_qkv_reference(qkv, cos, sin, dest, heads)
    B, N, width = qkv.shape
    d = width // 3 // heads
    if d // 2 * qkv.element_size() % VECTOR_BYTES or dest.data_ptr() % 8 \
            or any(t.data_ptr() % VECTOR_BYTES for t in (qkv, cos, sin)):
        raise ValueError(f"half a head of {d // 2} {qkv.dtype} values, or "
                         f"a table, is not {VECTOR_BYTES}-byte aligned")
    out = torch.empty((3, B * N, heads, d), dtype=qkv.dtype,
                      device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.mmg_vit_rotary_qkv(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), dest.data_ptr(),
            out.data_ptr(), B, N, heads, d, qkv.element_size(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("mmg_vit_rotary_qkv kernel launch failed: "
                           + lib.mmg_vit_error_string(rc).decode())
    rotary_qkv.launches += 1
    return out.unbind(0)


rotary_qkv.launches = 0
