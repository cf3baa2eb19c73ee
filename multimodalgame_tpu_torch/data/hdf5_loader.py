"""HDF5 batch loader with the reference's exact ordering semantics.

Parity target: ``load_hdf5`` (reference misc.py:257-302), as in
``multimodalgame_tpu/data/hdf5_loader.py``:

* epoch-seeded shuffle with Python's ``random`` module — ``seed(11 +
  epoch)`` then ``random.shuffle`` over ``range(dataset_size)``;
* fixed-size batches, optional truncated final batch;
* in-batch indices sorted ascending (h5py fancy-indexing constraint), so
  examples within a batch arrive in file order;
* yields ``target`` (label-mapped), ``example_ids`` and the feature sets
  present, squeezed of their stored singleton axis.

``h5py`` is imported when a file is read, not when this module is.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Dict, Iterator

import numpy as np


def _squeeze_keep_batch(a: np.ndarray) -> np.ndarray:
    """Drop singleton axes except axis 0."""
    keep = [a.shape[0]] + [s for s in a.shape[1:] if s != 1]
    return a.reshape(keep)


def load_hdf5(hdf5_file: str, batch_size: int, random_seed: int,
              shuffle: bool, truncate_final_batch: bool = False,
              map_labels: Callable[[int], int] = int,
              ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batch dicts ``{target, example_ids, layer4_2, avgpool_512, fc}``
    with the reference's shuffle/batching semantics."""
    import h5py

    path = os.path.expanduser(hdf5_file)
    with h5py.File(path, "r") as f:
        dataset_size = f["Target"].shape[0]

    order = list(range(dataset_size))
    if shuffle:
        random.seed(11 + random_seed)
        random.shuffle(order)

    num_batches = dataset_size // batch_size
    if truncate_final_batch and dataset_size - num_batches * batch_size > 0:
        num_batches += 1

    with h5py.File(path, "r") as f:
        for i in range(num_batches):
            batch_indices = sorted(order[i * batch_size:(i + 1) * batch_size])
            batch: Dict[str, np.ndarray] = {}
            batch["target"] = np.asarray(
                [map_labels(int(t)) for t in f["Target"][batch_indices]],
                dtype=np.int64)
            batch["example_ids"] = f["Location"][batch_indices]
            for key in ("layer4_2", "avgpool_512", "fc"):
                if key in f:
                    batch[key] = _squeeze_keep_batch(
                        np.asarray(f[key][batch_indices], dtype=np.float32))
            yield batch
