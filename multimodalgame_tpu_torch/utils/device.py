"""Device selection for the port's entry points.

Entry points run on ``cuda`` by default. The CPU is used only when the
caller asks for it explicitly (``device="cpu"``, as the tests do); a
default or CUDA request on a machine without a GPU raises instead of
carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` when a CUDA device
    is requested and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the Python entry points take "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
