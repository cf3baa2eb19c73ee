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
:meth:`DeviceDataset.from_hdf5`.

A set given uint8 features is a CIFAR pixel set
(:meth:`DeviceDataset.from_cifar`, or pixels made elsewhere): it holds
the resized pixels as stored, uint8 ``(N, 3, 227, 227)`` (1.55 GB for the
10,000 test images), and the driver normalizes each gathered batch on
the device (``data/cifar.py:normalize``). Its plan is the streaming
loader's: ``RandomState(11 + epoch)``, unsorted rows, whatever
``shuffle`` says. The dtype is the one decision: staging and plan both
follow from it.
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
            for visual attention; uint8 ``(N, 3, H, W)`` pixels for a
            CIFAR set.
        context: optional ``(N, C)`` float32 tensor of the attention
            context features (``fc``), gathered with ``feats`` by the
            same indices, else ``None``.
        targets: ``(N,)`` int64 tensor of mapped labels.
        targets_host: int32 numpy copy of ``targets`` (the log's
            "Predictions" line reads it without a device read).
        size: N.
        cifar: whether ``feats`` are uint8 pixels, kept as stored and
            planned by :func:`data.cifar.cifar_epoch_perm` instead of the
            reference loader's order.

    ``feats`` may be a numpy array or a tensor (made on the device, say);
    uint8 pixels are kept, any other dtype is stored as float32.
    """

    def __init__(self, feats, targets, context=None,
                 device: Optional[Union[str, torch.device]] = None):
        dev = resolve_device(device)
        self.targets_host = np.asarray(targets, dtype=np.int32)
        self.size = int(self.targets_host.shape[0])
        if not isinstance(feats, torch.Tensor):
            feats = torch.from_numpy(np.ascontiguousarray(feats))
        self.cifar = feats.dtype == torch.uint8
        self.feats = feats.to(dev) if self.cifar else feats.to(
            dev, torch.float32)
        if self.feats.shape[0] != self.size:
            raise ValueError(f"{self.feats.shape[0]} feature rows for "
                             f"{self.size} labels")
        self.targets = torch.as_tensor(self.targets_host.astype(np.int64),
                                       device=dev)
        self.context = (None if context is None else torch.as_tensor(
            np.asarray(context, np.float32), device=dev))

    def to(self, device: Union[str, torch.device]) -> "DeviceDataset":
        """A copy of the set on ``device`` (the tensors moved, the host
        labels shared): a data-parallel rank's copy of the same set."""
        out = object.__new__(DeviceDataset)
        out.__dict__.update(self.__dict__)
        dev = torch.device(device)
        out.feats, out.targets = self.feats.to(dev), self.targets.to(dev)
        out.context = None if self.context is None else self.context.to(dev)
        return out

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

    @classmethod
    def from_cifar(cls, root: str = "./", image_size: int = 227,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "DeviceDataset":
        """Stage the CIFAR-10 test split as resized uint8 pixels with the
        streaming loader's shuffle (data/cifar.py; PIL needed)."""
        from multimodalgame_tpu_torch.data.cifar import load_cifar_staged
        pixels, labels = load_cifar_staged(root, image_size)
        return cls(pixels, labels, device=device)

    def epoch_indices(self, epoch: int, shuffle: bool, batch_size: int,
                      truncate_final_batch: bool = False) -> np.ndarray:
        """The epoch's ``(nb, batch_size)`` int64 batch plan in the
        reference loader's order. With ``truncate_final_batch`` the ragged
        tail comes too, padded with -1 (training never truncates).

        A CIFAR set (``cifar``) takes the streaming loader's plan
        and ignores ``shuffle``: neither that loader nor the reference's
        CIFAR ``DataLoader`` has an unshuffled mode, so
        ``-noshuffle_train`` cannot change its order either; it has no
        truncated plan."""
        if self.cifar:
            if truncate_final_batch:
                raise ValueError(
                    "truncate_final_batch is not defined for CIFAR-staged "
                    "datasets: the streaming loader drops the ragged tail")
            from multimodalgame_tpu_torch.data.cifar import cifar_epoch_perm
            return cifar_epoch_perm(self.size, epoch, batch_size)
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
