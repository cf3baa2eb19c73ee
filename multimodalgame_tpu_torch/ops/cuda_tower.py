"""The served ResNet-34 tower's elementwise passes, one after each
convolution (``models/resnet.py:PixelTower``), as three CUDA kernels.

The kernel source is ``csrc/tower_epilogue.cu``, compiled for ``sm_90a``
at first use and called through ``ctypes`` (``ops/cuda_build.py``). The
tower's batch norms are folded into its convolutions
(``resnet.py:fold_batch_norms``: the weights scaled, the shift a bias),
and cuDNN computes each convolution without its bias:

* :func:`normalize_pixels`: uint8 pixels to float32, ToTensor +
  Normalize(.5, .5), in one pass;
* :func:`stem`: conv1's output to ``max_pool(relu(y + b))`` (3x3, stride
  2, padding 1), computed as ``relu(max(window) + b)``, which is exact;
* :func:`block_epilogue`: ``act(y + b [+ (r + rb)])`` in place over a
  convolution's output, with a block's shortcut ``r`` (and the
  downsample's bias ``rb``) where it has one, ``act`` ReLU or none.

Each wrapper launches its kernel for a CUDA tensor (a failed build or
launch raises) and runs its plain version, ``<name>_reference`` beside
it, for a CPU one. The kernels run on PyTorch's current stream and
allocate nothing: the wrappers allocate the outputs. Each launch adds one
to the wrapper's ``launches`` (:data:`COUNTED`); a graph that records
them adds its counts at each replay (``utils/cuda_graph.py:Captured``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from multimodalgame_tpu_torch.ops import cuda_build

SOURCE = "tower_epilogue.cu"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    lib = cuda_build.load(SOURCE)
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.mmg_tower_normalize.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
    lib.mmg_tower_stem.argtypes = [ptr, ptr, ptr] + [num] * 6 + [ptr]
    lib.mmg_tower_epilogue.argtypes = [ptr] * 4 + [num] * 4 + [ptr]
    for fn in (lib.mmg_tower_normalize, lib.mmg_tower_stem,
               lib.mmg_tower_epilogue):
        fn.restype = ctypes.c_int
    lib.mmg_tower_error_string.argtypes = [ctypes.c_int]
    lib.mmg_tower_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.mmg_tower_error_string(rc).decode())


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           dims: Optional[int], device: torch.device, align: int) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if dims is not None and x.dim() != dims:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{dims} dimensions")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"{name} is not contiguous and {align}-byte "
                         f"aligned")


def _bias(name: str, b: torch.Tensor, channels: int,
          device: torch.device) -> None:
    _check(name, b, torch.float32, 1, device, 4)
    if b.shape[0] != channels:
        raise ValueError(f"{name} has {b.shape[0]} values, expected "
                         f"{channels}")


def _channel(b: torch.Tensor) -> torch.Tensor:
    return b.view(1, -1, 1, 1)


# ------------------------------------------------------------- normalize

def normalize_pixels_reference(pixels: torch.Tensor) -> torch.Tensor:
    """:func:`normalize_pixels`'s plain version."""
    return pixels.float().div_(255).sub_(0.5).div_(0.5)


def normalize_pixels(pixels: torch.Tensor) -> torch.Tensor:
    """uint8 pixels ``(B, 3, H, W)`` as the reference's ToTensor +
    Normalize(.5, .5) leave them (utils/package_data.py:171-178):
    ``(x / 255 - 0.5) / 0.5``, float32, in one kernel on a card. The
    kernel rounds each step as PyTorch's passes round it there (the
    division by 255 a product by its float32 reciprocal), so the two are
    equal bit for bit."""
    if pixels.device.type != "cuda":
        return normalize_pixels_reference(pixels)
    _check("pixels", pixels, torch.uint8, None, pixels.device, 4)
    out = torch.empty(pixels.shape, dtype=torch.float32,
                      device=pixels.device)
    if pixels.numel():
        _launch("mmg_tower_normalize", pixels.device, pixels.data_ptr(),
                out.data_ptr(), pixels.numel())
        normalize_pixels.launches += 1
    return out


normalize_pixels.launches = 0


# ------------------------------------------------------------------ stem

def stem_reference(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """:func:`stem`'s plain version: the max first, then the bias and the
    ReLU, as the kernel computes it."""
    return torch.relu(F.max_pool2d(y, 3, 2, 1) + _channel(bias))


def stem(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv1's output ``y`` ``(B, C, H, W)`` (its batch norm's scale
    folded in) and the norm's shift ``bias`` ``(C,)`` to torchvision's
    ``maxpool(relu(y + bias))``: 3x3 windows, stride 2, padding 1,
    computed as ``relu(max(window) + bias)``; equal bit for bit, since
    rounding ``y + bias`` and the ReLU are both monotone. One kernel on a
    card: one read of ``y``, one write of the pooled planes."""
    if y.device.type != "cuda":
        return stem_reference(y, bias)
    _check("y", y, torch.float32, 4, y.device, 4)
    n, c, h, w = y.shape
    _bias("bias", bias, c, y.device)
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.empty((n, c, oh, ow), dtype=torch.float32, device=y.device)
    if out.numel():
        _launch("mmg_tower_stem", y.device, y.data_ptr(), bias.data_ptr(),
                out.data_ptr(), n, c, h, w, oh, ow)
        stem.launches += 1
    return out


stem.launches = 0


# -------------------------------------------------------- block epilogue

def block_epilogue_reference(y: torch.Tensor, bias: torch.Tensor,
                             residual: Optional[torch.Tensor] = None,
                             residual_bias: Optional[torch.Tensor] = None,
                             relu: bool = True) -> torch.Tensor:
    """:func:`block_epilogue`'s plain version, in place, in the kernel's
    order."""
    y.add_(_channel(bias))
    if residual is not None:
        y.add_(residual if residual_bias is None
               else residual + _channel(residual_bias))
    return y.relu_() if relu else y


def block_epilogue(y: torch.Tensor, bias: torch.Tensor,
                   residual: Optional[torch.Tensor] = None,
                   residual_bias: Optional[torch.Tensor] = None,
                   relu: bool = True) -> torch.Tensor:
    """A convolution's output ``y`` ``(B, C, H, W)`` finished in place:
    ``act(y + bias [+ (residual + residual_bias)])``, ``bias`` and
    ``residual_bias`` ``(C,)``, ``residual`` shaped as ``y`` (a block's
    shortcut: its input, or its downsample convolution's output with that
    convolution's bias), ``act`` ReLU where ``relu``. Returns ``y``. One
    kernel on a card: ``y`` (and the shortcut) read once, ``y`` written
    once."""
    if y.device.type != "cuda":
        return block_epilogue_reference(y, bias, residual, residual_bias,
                                        relu)
    dev = y.device
    _check("y", y, torch.float32, 4, dev, 16)
    n, c, h, w = y.shape
    _bias("bias", bias, c, dev)
    if residual is not None:
        _check("residual", residual, torch.float32, 4, dev, 16)
        if residual.shape != y.shape:
            raise ValueError(f"residual has shape {tuple(residual.shape)}, "
                             f"expected {tuple(y.shape)}")
    if residual_bias is not None:
        if residual is None:
            raise ValueError("residual_bias without a residual")
        _bias("residual_bias", residual_bias, c, dev)
    if (c * h * w) % 4 or c * h * w >= 2 ** 31:
        raise ValueError(f"an image of {c * h * w} values: the kernel takes "
                         f"a multiple of 4 below 2**31")
    if y.numel():
        _launch("mmg_tower_epilogue", dev, y.data_ptr(), bias.data_ptr(),
                None if residual is None else residual.data_ptr(),
                None if residual_bias is None else residual_bias.data_ptr(),
                n, c, h * w, int(relu))
        block_epilogue.launches += 1
    return y


block_epilogue.launches = 0

# The wrappers whose launches are counted.
COUNTED = (normalize_pixels, stem, block_epilogue)
