"""Flat packing of device tensors for one device-to-host copy.

The port of ``multimodalgame_tpu/utils/device_pack.py``. Everything the
host needs from one log window or one dev sweep is concatenated on the
device into one float32 vector, copied to the host once, and sliced
apart there. Integer fields (step counts, class indices, bits) survive
the float32 round trip exactly below 2**24.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


class PackSpec:
    """A fixed schema of named fields packed into one flat f32 vector.

    ``fields`` is a sequence of ``(name, shape)``; order defines the
    layout. ``pack`` runs on the tensors' device; ``unpack`` on the host.
    """

    def __init__(self, fields: Sequence[Tuple[str, Tuple[int, ...]]]):
        self.fields: List[Tuple[str, Tuple[int, ...]]] = [
            (name, tuple(shape)) for name, shape in fields]
        self._offsets: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        off = 0
        for name, shape in self.fields:
            size = int(np.prod(shape)) if shape else 1
            self._offsets[name] = (off, off + size, shape)
            off += size
        self.total = off

    def pack(self, values: Dict[str, torch.Tensor],
             device: torch.device) -> torch.Tensor:
        """Concatenate ``values`` (keyed by field name) into one
        ``(total,)`` float32 tensor on ``device``. Missing fields are
        zero-filled."""
        parts = []
        for name, shape in self.fields:
            v = values.get(name)
            size = int(np.prod(shape)) if shape else 1
            if v is None:
                parts.append(torch.zeros(size, dtype=torch.float32,
                                         device=device))
            else:
                parts.append(torch.as_tensor(v, device=device)
                             .to(torch.float32).reshape(size))
        if not parts:
            return torch.zeros(0, dtype=torch.float32, device=device)
        return torch.cat(parts)

    def unpack(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        flat = np.asarray(flat)
        out: Dict[str, np.ndarray] = {}
        for name, (a, b, shape) in self._offsets.items():
            out[name] = flat[a:b].reshape(shape) if shape else flat[a]
        return out
