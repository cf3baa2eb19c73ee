"""CIFAR-10 as the image source (``-images cifar``).

The port of ``multimodalgame_tpu/data/cifar.py``, which re-derives the
reference's ``images=cifar`` branch (model.py:1195-1206) without
torchvision: the CIFAR-10 test split, each 32x32 image scaled to 227 by
PIL's bilinear resize (torchvision's ``Scale(227)``), then ``[0, 1]``
floats normalized with mean and std 0.5, fed as raw-pixel "features".
The python-format pickle (``cifar-10-batches-py/test_batch``) must be on
disk under ``root``; nothing is downloaded. Batches are shuffled by
``RandomState(11 + epoch)``, as every loader of the package is seeded.

PIL is imported only where an image is resized, as ``h5py`` is only
where a feature file is read: a machine without it stages the pixels
elsewhere and hands them to ``train.run(inputs=...)`` in memory.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Tuple

import numpy as np

_BATCH_FILE = os.path.join("cifar-10-batches-py", "test_batch")


def _read_test_batch(root: str) -> Tuple[np.ndarray, np.ndarray]:
    """``(images (N, 3, 32, 32) uint8, labels (N,) int64)``."""
    path = os.path.join(os.path.expanduser(root), _BATCH_FILE)
    if not os.path.exists(path):
        raise NotImplementedError(
            "images=cifar requires a local CIFAR-10 python-format copy at "
            f"{path!r} (no network egress available to download it)")
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
    return data, np.asarray(d[b"labels"], np.int64)


def _resize_u8(img: np.ndarray, size: int) -> np.ndarray:
    """One ``(3, 32, 32)`` uint8 image resized bilinearly by PIL to
    ``(3, size, size)`` uint8."""
    from PIL import Image
    pil = Image.fromarray(np.transpose(img, (1, 2, 0)))
    return np.transpose(np.asarray(pil.resize((size, size), Image.BILINEAR),
                                   np.uint8), (2, 0, 1))


def load_cifar_staged(root: str = "./", image_size: int = 227
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The whole test split, resized once for staging on the device:
    ``(pixels (N, 3, S, S) uint8, labels (N,) int32)``. PIL's bilinear
    resize of a uint8 image is uint8, so the pixels are staged losslessly
    at a quarter of the float32 size, and the normalization runs on the
    device (:func:`normalize`), bit-equal to :func:`load_cifar`'s."""
    data, labels = _read_test_batch(root)
    out = np.empty((data.shape[0], 3, image_size, image_size), np.uint8)
    for i, img in enumerate(data):
        out[i] = _resize_u8(img, image_size)
    return out, labels.astype(np.int32)


def cifar_epoch_perm(n: int, epoch: int, batch_size: int) -> np.ndarray:
    """:func:`load_cifar`'s batch plan as an ``(nb, B)`` index array:
    ``RandomState(11 + epoch).permutation`` order, rows unsorted, the
    ragged tail dropped."""
    perm = np.random.RandomState(11 + epoch).permutation(n)
    nb = n // batch_size
    return perm[:nb * batch_size].reshape(nb, batch_size).astype(np.int64)


def normalize(pixels):
    """``(x / 255 - 0.5) / 0.5`` in float32, for numpy arrays and torch
    tensors alike (``Normalize((.5,)*3, (.5,)*3)`` after ``ToTensor``)."""
    if isinstance(pixels, np.ndarray):
        x = pixels.astype(np.float32) / np.float32(255.0)
        return (x - np.float32(0.5)) / np.float32(0.5)
    return (pixels.float() / 255.0 - 0.5) / 0.5


def load_cifar(batch_size: int, epoch: int, root: str = "./",
               image_size: int = 227) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled CIFAR batches under the HDF5 loader's batch contract: the
    normalized pixels as ``layer4_2`` ``(B, 3, S, S)`` and flattened as
    ``avgpool_512`` and ``fc``. The ragged final batch is dropped, as the
    HDF5 train loader drops it (misc.py:274-278)."""
    data, labels = _read_test_batch(root)
    for idx in cifar_epoch_perm(len(labels), epoch, batch_size):
        pixels = normalize(np.stack([_resize_u8(data[i], image_size)
                                     for i in idx]))
        flat = pixels.reshape(pixels.shape[0], -1)
        yield {"target": labels[idx], "example_ids": idx,
               "avgpool_512": flat, "layer4_2": pixels, "fc": flat}
