"""Synthetic fixtures: HDF5 feature files, description CSVs, fake GloVe.

A copy of ``multimodalgame_tpu/data/synthetic.py``, with ``h5py``
imported only by :func:`write_feature_hdf5`. The reference has no test
fixtures beyond ``wv_type="fake"``
(model.py:1067-1069); these builders produce files with the exact on-disk
schema of the real pipeline (``utils/package_data.py:238-243``: ``Target``,
``Location``, ``layer4_2`` (N,1,512,8,8), ``avgpool_512`` (N,1,512),
``fc`` (N,1,1000)) so tests, the end-to-end smoke train, and the benchmark
exercise the same code paths as production data.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_WORDS = [
    "nocturnal", "burrowing", "mammal", "grasslands", "africa", "feeds",
    "termites", "lizard", "warm", "regions", "frog", "aquatic", "voice",
    "arthropod", "flattened", "body", "segments", "legs", "songbird",
    "grey", "black", "america", "duck", "wild", "domestic", "adult",
    "male", "bird", "plumage", "crest", "tail", "marine", "shell",
    "venomous", "spider", "hairy", "tropical", "brightly", "colored",
    "long", "small", "large", "predatory", "insect", "water", "flying",
]


def write_descriptions_csv(path: str, num_classes: int,
                           label_ids: Optional[Sequence[int]] = None,
                           seed: int = 0) -> None:
    """Write a ``label_id,label,description`` CSV (format documented in
    reference misc.py:24-38). ``label_ids`` need not be contiguous."""
    rng = np.random.RandomState(seed)
    if label_ids is None:
        label_ids = list(range(num_classes))
    with open(path, "w") as f:
        for i in range(num_classes):
            nwords = int(rng.randint(4, 9))
            words = [
                _WORDS[int(j)] for j in
                rng.choice(len(_WORDS), size=nwords, replace=False)]
            f.write("{},{},{}\n".format(
                label_ids[i], "class%d" % i, " ".join(words)))


def write_fake_glove(path: str, wv_dim: int = 100, seed: int = 1,
                     extra_vocab: int = 0) -> None:
    """Write a GloVe-format text file covering the synthetic vocabulary.

    ``extra_vocab`` pads the file with that many filler entries so the
    single-pass scan in ``embed()`` (reference misc.py:305-320) can be
    exercised at the real ``glove.6B`` file's vocabulary scale (~400k
    lines) rather than toy size. The game words are spread evenly
    through the whole file (one every ``total/len(_WORDS)`` lines) so a
    scan that stopped early would be caught."""
    rng = np.random.RandomState(seed)

    def line(word):
        return word + " " + " ".join(
            "%.5f" % v for v in rng.randn(wv_dim)) + "\n"

    stride = max(1, (extra_vocab + len(_WORDS)) // max(1, len(_WORDS)))
    words = iter(_WORDS)
    with open(path, "w") as f:
        if not extra_vocab:
            for w in _WORDS:
                f.write(line(w))
            return
        for i in range(extra_vocab + len(_WORDS)):
            if i % stride == 0:
                w = next(words, None)
                if w is not None:
                    f.write(line(w))
                    continue
            f.write(line("pad%07d" % i))
        for w in words:   # stride rounding left any game words unwritten
            f.write(line(w))


def write_feature_hdf5(path: str, num_examples: int, num_classes: int,
                       label_ids: Optional[Sequence[int]] = None,
                       seed: int = 0, single_class_blocks: bool = False,
                       feature_keys: Sequence[str] = ("layer4_2",
                                                      "avgpool_512", "fc"),
                       ) -> None:
    """Write an HDF5 feature file with the reference pipeline's schema.

    ``single_class_blocks`` lays examples out contiguously by class in file
    order, matching the real dataset build (ImageFolder iterates class by
    class, utils/package_data.py:181-183) — required by the extraction
    path's single-target-batch assertion (binary_vectors.py:96-97).

    ``feature_keys`` selects which feature sets to materialize — large
    fixtures (the benchmark's canonical-scale file) skip the 131 KB/example
    ``layer4_2`` map when only ``avgpool_512`` is consumed.
    """
    import h5py

    rng = np.random.RandomState(seed)
    if label_ids is None:
        label_ids = list(range(num_classes))
    if single_class_blocks:
        per = num_examples // num_classes
        targets = np.repeat(np.asarray(label_ids)[:num_classes], per)
        targets = np.concatenate(
            [targets,
             np.full(num_examples - len(targets), label_ids[0])])[:num_examples]
    else:
        targets = np.asarray(label_ids)[rng.randint(0, num_classes,
                                                    size=num_examples)]
    locations = np.asarray(
        ["img_%05d.jpg" % i for i in range(num_examples)], dtype="S50")

    # Class-conditional features: per-class prototypes plus noise, so the
    # game is actually learnable from synthetic data (feature rng is seeded
    # separately from the class prototypes so train/dev share prototypes).
    id_to_cls = {int(lid): c for c, lid in enumerate(label_ids)}
    cls_idx = np.asarray([id_to_cls[int(t)] for t in targets])
    proto_rng = np.random.RandomState(1234)
    proto_pool = proto_rng.randn(num_classes, 512).astype(np.float32)
    proto_fc = proto_rng.randn(num_classes, 1000).astype(np.float32)
    proto_map = proto_rng.randn(num_classes, 512, 8, 8).astype(np.float32)

    with h5py.File(path, "w") as f:
        f.create_dataset("Target", data=targets.astype(np.int64))
        f.create_dataset("Location", data=locations)
        # Draw order (avgpool, fc, layer4) matches the all-keys layout, so
        # an avgpool-only fixture has the same avgpool as the full one.
        if "avgpool_512" in feature_keys:
            avgpool = np.abs(proto_pool[cls_idx] + 0.3 * rng.randn(
                num_examples, 512)).astype(np.float32)
            f.create_dataset("avgpool_512", data=avgpool[:, None])
        if "fc" in feature_keys:
            fc = (proto_fc[cls_idx] + 0.3 * rng.randn(
                num_examples, 1000)).astype(np.float32)
            f.create_dataset("fc", data=fc[:, None])
        if "layer4_2" in feature_keys:
            layer4 = (proto_map[cls_idx] + 0.3 * rng.randn(
                num_examples, 512, 8, 8)).astype(np.float32)
            f.create_dataset("layer4_2", data=layer4[:, None])


def build_synthetic_dataset(root: str, num_classes: int = 10,
                            train_per_class: int = 8, dev_per_class: int = 4,
                            wv_dim: int = 100, seed: int = 0,
                            glove_extra_vocab: int = 0) -> dict:
    """Create a full synthetic dataset directory: train/dev HDF5 + CSV +
    fake GloVe (optionally padded to ``glove_extra_vocab`` filler
    entries — real-file scale). Returns the file paths."""
    os.makedirs(root, exist_ok=True)
    paths = {
        "descr": os.path.join(root, "descriptions.csv"),
        "glove": os.path.join(root, "glove.txt"),
        "train": os.path.join(root, "train.hdf5"),
        "dev": os.path.join(root, "dev.hdf5"),
    }
    write_descriptions_csv(paths["descr"], num_classes, seed=seed)
    write_fake_glove(paths["glove"], wv_dim=wv_dim, seed=seed + 1,
                     extra_vocab=glove_extra_vocab)
    write_feature_hdf5(paths["train"], num_classes * train_per_class,
                       num_classes, seed=seed + 2, single_class_blocks=True)
    write_feature_hdf5(paths["dev"], num_classes * dev_per_class,
                       num_classes, seed=seed + 3, single_class_blocks=True)
    return paths
