"""Dataset build: images -> ResNet-34 features -> HDF5.

The port of ``tools/package_data.py`` (parity target: the reference's
``utils/package_data.py``), with its flags, preprocessing, skip rule and
HDF5 schema: walk an ImageFolder-style directory (``root/<class>/
<image>``, classes and files sorted), preprocess each image (shorter
side to 227, center crop 227, normalize to (.5, .5);
utils/package_data.py:171-178), skip the unreadable ones
(utils/package_data.py:198-208), run ResNet-34 (``models/resnet.py``)
for the requested taps (default ``layer4_2,avgpool_512,fc``) one batch
at a time, and write ``Target``, ``Location`` and one ``(N, 1, ...)``
dataset a tap (utils/package_data.py:238-243).

Usage:
    python -m multimodalgame_tpu_torch.package_data -load_imgs ./imgs/train \\
        -save_hdf5 train.hdf5 -load_desc descriptions.csv \\
        [-weights resnet34.pth] [-batch_size 32]

Without ``-weights`` a deterministic random-weight network is used
(``models/resnet.py:random_params``, the JAX package's draws): features
for pipeline testing; real deployments pass torchvision's ``resnet34``
``.pth``. It runs on ``cuda`` unless ``main``'s caller passes ``device``.
PIL and h5py are imported when it runs.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.utils.device import resolve_device

IMAGE_SIZE = 227


def preprocess_image(path: str) -> np.ndarray:
    """PIL equivalent of Scale(227) + CenterCrop(227) + ToTensor +
    Normalize((.5,.5,.5), (.5,.5,.5)) -> (3, 227, 227) float32."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    w, h = img.size
    # torchvision Scale: shorter side -> 227, aspect kept.
    if w < h:
        nw, nh = IMAGE_SIZE, max(IMAGE_SIZE, int(round(h * IMAGE_SIZE / w)))
    else:
        nw, nh = max(IMAGE_SIZE, int(round(w * IMAGE_SIZE / h))), IMAGE_SIZE
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - IMAGE_SIZE) // 2
    top = (nh - IMAGE_SIZE) // 2
    img = img.crop((left, top, left + IMAGE_SIZE, top + IMAGE_SIZE))
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return np.transpose(arr, (2, 0, 1))


def label_mapping(desc_path: str) -> dict:
    """label -> label_id from the descriptions CSV
    (utils/package_data.py:134-141)."""
    label_to_id = {}
    with open(desc_path) as f:
        for line in f:
            label_id, label, _ = line.strip().split(",", 2)
            label_to_id[label] = int(label_id)
    return label_to_id


def iter_image_paths(root: str):
    """ImageFolder order: classes sorted, files sorted within a class."""
    for cls in sorted(os.listdir(root)):
        cls_dir = os.path.join(root, cls)
        if not os.path.isdir(cls_dir):
            continue
        for name in sorted(os.listdir(cls_dir)):
            yield cls, os.path.join(cls_dir, name)


def run(args, device: Optional[Union[str, torch.device]] = None) -> None:
    import h5py
    from multimodalgame_tpu_torch.models.resnet import (load_pretrained,
                                                        random_params,
                                                        resnet34_features)
    dev = resolve_device(device)
    request = args.request.split(",")
    if args.weights:
        params = load_pretrained(args.weights, dev)
    else:
        print("WARNING: no -weights given; using deterministic random "
              "ResNet-34 weights (pipeline-testing mode)", file=sys.stderr)
        params = random_params(0, dev)
    label_to_id = label_mapping(args.load_desc)

    targets, locations = [], []
    feats = {r: [] for r in request}
    batch_imgs, batch_meta = [], []

    def flush():
        if not batch_imgs:
            return
        x = torch.from_numpy(np.stack(batch_imgs, 0)).to(dev)
        out = resnet34_features(params, x, request)
        for r in request:
            feats[r].append(out[r].cpu().numpy())
        for cls, loc in batch_meta:
            targets.append(label_to_id[cls])
            locations.append(loc)
        batch_imgs.clear()
        batch_meta.clear()

    skipped = 0
    for cls, path in iter_image_paths(args.load_imgs):
        try:
            img = preprocess_image(path)
        except Exception:
            skipped += 1    # unreadable images are skipped
            continue        # (utils/package_data.py:198-208)
        batch_imgs.append(img)
        batch_meta.append((cls, os.path.basename(path)))
        if len(batch_imgs) == args.batch_size:
            flush()
    flush()
    if skipped:
        print(f"skipped {skipped} unreadable images", file=sys.stderr)

    with h5py.File(args.save_hdf5, "w") as f:
        f.create_dataset("Target", data=np.asarray(targets, np.int64))
        f.create_dataset("Location",
                         data=np.asarray(locations, dtype="S50"))
        for r in request:
            # The reference's schema: a singleton axis after the batch
            # (utils/package_data.py:144-155).
            f.create_dataset(r, data=np.concatenate(feats[r], 0)[:, None])
    print(f"wrote {len(targets)} examples to {args.save_hdf5}")


def main(argv=None, device: Optional[Union[str, torch.device]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-load_desc", "--load_desc", default="descriptions.csv")
    p.add_argument("-load_imgs", "--load_imgs", default="./imgs/train")
    p.add_argument("-save_hdf5", "--save_hdf5", default="train.hdf5")
    p.add_argument("-batch_size", "--batch_size", type=int, default=32)
    p.add_argument("-request", "--request",
                   default="layer4_2,avgpool_512,fc")
    p.add_argument("-weights", "--weights", default=None,
                   help="path to a torchvision resnet34 state_dict .pth")
    run(p.parse_args(argv), device)


if __name__ == "__main__":
    main()
