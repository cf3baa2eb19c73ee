"""The batch plan of an epoch, frozen: which rows each step trains on.

The reference loader's order (model.py's shuffled data loader, as the
port stages it): the row indices shuffled by Python's
``random.Random(11 + epoch)`` when shuffling, cut into whole batches,
each batch's rows sorted; the ragged tail is dropped in training and
kept (as a last, shorter batch) in a dev sweep.
"""

import random
from typing import List

import numpy as np


def epoch_batches(size: int, epoch: int, shuffle: bool, batch: int,
                  keep_tail: bool = False) -> List[np.ndarray]:
    order = list(range(size))
    if shuffle:
        random.Random(11 + epoch).shuffle(order)
    nb = size // batch
    rows = np.sort(np.asarray(order[:nb * batch], np.int64)
                   .reshape(nb, batch), axis=1)
    out = list(rows)
    if keep_tail and size > nb * batch:
        out.append(np.sort(np.asarray(order[nb * batch:], np.int64)))
    return out
