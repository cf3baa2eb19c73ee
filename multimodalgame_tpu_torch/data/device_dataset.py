"""A feature set held on the device: staged once, gathered by index.

Port of ``multimodalgame_tpu/data/device_dataset.py`` for feature files.
The game's sets are small (30 classes x 100 examples of ``avgpool_512``
is 6 MB), so the whole set goes to the device once and every batch is a
gather ``feats[idx]`` by a ``(K, B)`` index plan made on the host. A set
beyond the staging limit is refused: a streaming loader is the tool for
it, and silent device-memory exhaustion is not.

:meth:`DeviceDataset.epoch_indices` gives the reference loader's order
(``seed(11 + epoch)`` then ``shuffle`` over ``range(N)``, fixed-size
batches, ascending indices in a batch, misc.py:269-284), the same plan as
``data/hdf5_loader.py`` yields. ``h5py`` is imported only by
:meth:`DeviceDataset.from_hdf5`. The CIFAR path is not ported yet.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Optional, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.data.hdf5_loader import _squeeze_keep_batch
from multimodalgame_tpu_torch.utils.device import resolve_device

# Refuse to stage sets beyond this many bytes (as the JAX package does).
DEFAULT_LIMIT_BYTES = int(os.environ.get("MMG_DEVICE_DATA_LIMIT",
                                         4 * 1024 ** 3))


class DeviceDataset:
    """Features and mapped labels on one device.

    Attributes:
        feats: ``(N, ...)`` float32 tensor of the image features:
            ``(N, F)`` vectors, or ``(N, C, H, W)`` maps (``layer4_2``)
            for visual attention.
        context: optional ``(N, C)`` float32 tensor of the attention
            context features (``fc``), gathered with ``feats`` by the
            same indices, else ``None``.
        targets: ``(N,)`` int64 tensor of mapped labels.
        targets_host: int32 numpy copy of ``targets`` (the log's
            "Predictions" line reads it without a device read).
        size: N.
    """

    def __init__(self, feats, targets, context=None,
                 device: Optional[Union[str, torch.device]] = None):
        dev = resolve_device(device)
        self.targets_host = np.asarray(targets, dtype=np.int32)
        self.size = int(self.targets_host.shape[0])
        self.feats = torch.as_tensor(np.asarray(feats, np.float32),
                                     device=dev)
        if self.feats.shape[0] != self.size:
            raise ValueError(f"{self.feats.shape[0]} feature rows for "
                             f"{self.size} labels")
        self.targets = torch.as_tensor(self.targets_host.astype(np.int64),
                                       device=dev)
        self.context = (None if context is None else torch.as_tensor(
            np.asarray(context, np.float32), device=dev))

    @classmethod
    def from_hdf5(cls, hdf5_file: str, feat_key: str,
                  map_labels: Callable[[int], int] = int,
                  context_key: Optional[str] = None,
                  limit_bytes: int = DEFAULT_LIMIT_BYTES,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> "DeviceDataset":
        """Load a whole feature file (the reference's schema) and stage
        it on ``device``; raises ``MemoryError`` beyond ``limit_bytes``."""
        import h5py

        with h5py.File(os.path.expanduser(hdf5_file), "r") as f:
            targets = [map_labels(int(t)) for t in np.asarray(f["Target"])]
            feats = _squeeze_keep_batch(np.asarray(f[feat_key], np.float32))
            context = (None if context_key is None else _squeeze_keep_batch(
                np.asarray(f[context_key], np.float32)))
        nbytes = feats.nbytes + (0 if context is None else context.nbytes)
        if nbytes > limit_bytes:
            raise MemoryError(
                f"dataset {hdf5_file} is {nbytes / 1e9:.1f} GB — beyond the "
                f"device-staging limit ({limit_bytes / 1e9:.1f} GB); raise "
                "MMG_DEVICE_DATA_LIMIT or shard the file")
        return cls(feats, targets, context, device=device)

    def epoch_indices(self, epoch: int, shuffle: bool, batch_size: int,
                      truncate_final_batch: bool = False) -> np.ndarray:
        """The epoch's ``(nb, batch_size)`` int64 batch plan in the
        reference loader's order. With ``truncate_final_batch`` the ragged
        tail comes too, padded with -1 (training never truncates)."""
        order = list(range(self.size))
        if shuffle:
            random.Random(11 + epoch).shuffle(order)
        nb = self.size // batch_size
        rows = np.sort(np.asarray(order[:nb * batch_size], np.int64)
                       .reshape(nb, batch_size), axis=1)
        if truncate_final_batch and self.size > nb * batch_size:
            tail = np.full((1, batch_size), -1, np.int64)
            rest = sorted(order[nb * batch_size:])
            tail[0, :len(rest)] = rest
            rows = np.concatenate([rows, tail], axis=0)
        return rows
