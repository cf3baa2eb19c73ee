"""Development-set evaluation on the host, batch by batch.

The port of ``multimodalgame_tpu/eval.py``, parity target the reference's
``eval_dev`` (model.py:580-722): the eval conversation per batch
(``game/train.py:make_eval_exchange``, the eval-mode kernel on a GPU),
masked prediction selection, top-k accuracy by ``argsort``, the
confusion-matrix CSV, conversation lengths from the stop bits and the
mean inter-step Hamming distance of both agents' messages. The record is
sliced on the host to ``n_steps``, the turns the reference's break-early
loop would have run, so every statistic has the reference's step
denominators.

Reproduced quirk (SURVEY §2#7): the accuracy denominator adds the
*configured* batch size even for a truncated final batch (model.py:667).

``-eval_only -nofast_driver`` uses this path; ``game/fast_eval.py`` is the
driver's sweep over the staged dev set, with the same numbers: the same
``-flipout_dev`` draws too (Philox keyed by ``(random_seed + 1, step)``,
slot ``1 + i`` for batch ``i``). The attention context is read from the
file's ``-data_context`` column under ``attn_extra_context``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
from multimodalgame_tpu_torch.data.hdf5_loader import load_hdf5
from multimodalgame_tpu_torch.game.exchange import description_inputs
from multimodalgame_tpu_torch.game.masks import build_mask
from multimodalgame_tpu_torch.ops.philox import philox_eval_uniforms


def confusion_matrix(true_labels: np.ndarray,
                     pred_labels: np.ndarray) -> np.ndarray:
    """``sklearn.metrics.confusion_matrix(true, pred)``: rows and columns
    indexed by the sorted union of the labels present in either array
    (not by the class count), int64 counts."""
    labels = np.union1d(true_labels, pred_labels)
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    np.add.at(cm, (np.searchsorted(labels, true_labels),
                   np.searchsorted(labels, pred_labels)), 1)
    return cm


def write_confusion_matrix(path: str, true_labels: np.ndarray,
                           pred_labels: np.ndarray) -> None:
    """The conf-mat CSV (model.py:706-710)."""
    np.savetxt(path, confusion_matrix(np.asarray(true_labels).reshape(-1),
                                      np.asarray(pred_labels).reshape(-1)),
               delimiter=",", fmt="%d")


def corrupt_mask_for(flags, cfg, device) -> Optional[torch.Tensor]:
    """The ``-bit_flip`` corruption mask over the sender's bits, or
    ``None`` (model.py:637-638)."""
    if not (flags.bit_flip and flags.corrupt_region):
        return None
    return torch.as_tensor(build_mask(flags.corrupt_region, cfg.rec_w_dim),
                           dtype=torch.float32, device=device)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=1, keepdims=True)
    s = x - m
    return s - np.log(np.exp(s).sum(axis=1, keepdims=True))


def sliced_masks(stop_masks: np.ndarray, n: int) -> list:
    """Reconstruct the reference's ``s_masks`` list for an ``n``-step
    conversation: entries ``[ones, m_1, ..., m_n]`` with the final entry
    forced to zero (model.py:775, 852, 870)."""
    masks = [stop_masks[t].copy() for t in range(n + 1)]
    masks[n][:] = 0.0
    return masks


def context_of(flags, batch: Dict[str, np.ndarray], device
               ) -> Optional[torch.Tensor]:
    """A batch's attention context (its ``-data_context`` column) under
    ``attn_extra_context``, else ``None``."""
    if not flags.attn_extra_context:
        return None
    return torch.as_tensor(batch[flags.data_context], device=device)


def eval_dev(flags, modules, eval_exchange: Callable, dev_file: str,
             batch_size: int, epoch: int, shuffle: bool, top_k: int,
             desc_pack: DescriptionPack, step: int = 0
             ) -> Tuple[float, Dict[str, float]]:
    """Development accuracy and conversation statistics over the HDF5
    file ``dev_file``, on the modules' device; ``step`` keys the
    ``-flipout_dev`` draws."""
    cfg = modules.cfg
    device = next(modules.parameters()).device
    descs = description_inputs(desc_pack, cfg, device)
    corrupt = corrupt_mask_for(flags, cfg, device)

    extra: Dict[str, float] = {}
    conversation_lengths = []
    hamming_sen = []
    hamming_rec = []
    true_labels = []
    pred_labels = []
    total = 0.0
    correct = 0

    dev_loader = load_hdf5(dev_file, batch_size, epoch, shuffle,
                           truncate_final_batch=True,
                           map_labels=desc_pack.map_labels)

    for i, batch in enumerate(dev_loader):
        target = np.asarray(batch["target"])
        data = torch.as_tensor(batch[flags.img_feat], device=device)
        true_labels.append(target.reshape(-1))

        with torch.no_grad():
            ex = eval_exchange(
                data, descs["desc"], corrupt,
                data_context=context_of(flags, batch, device),
                desc_set_padded=descs["desc_set_padded"],
                desc_set_mask=descs["desc_set_mask"],
                uniforms=philox_eval_uniforms(
                    cfg, len(target), flags.random_seed + 1, step, 1 + i,
                    device))
        ex = type(ex)(*(None if v is None else v.cpu().numpy()
                        for v in ex))
        n = int(ex.n_steps)
        s_masks = sliced_masks(ex.stop_masks, n)
        s_feats = ex.stop_feats[:n]
        sen_feats = ex.sen_feats[:n]
        rec_feats = ex.rec_feats[:n]
        y = ex.y[:n]

        # Masked prediction selection (model.py:648-654).
        if flags.fixed_exchange:
            outp = y[-1]
        else:
            y_masks = np.stack(
                [np.minimum(1 - m1, m2)
                 for m1, m2 in zip(s_masks[1:], s_masks[:-1])], 0)
            outp = (y * y_masks).sum(axis=0)

        dist = _log_softmax(outp)
        top_k_ind = dist.argsort(axis=1)[:, -top_k:]
        argmax = dist.argmax(axis=1)
        pred_labels.append(argmax)

        # Accuracy-denominator quirk: configured batch size, not actual
        # (model.py:667).
        total += float(batch_size)
        correct += int((top_k_ind == target.reshape(-1, 1)).sum())

        # Conversation lengths: per-example sum of stop bits over the
        # turns run (model.py:671-672).
        conversation_lengths += list(s_feats.sum(axis=(0, 2)).reshape(-1))

        # Mean inter-step Hamming distance, against a zero message before
        # turn 0 (model.py:675-691).
        prev = np.zeros_like(sen_feats[0])
        mh_sen = 0.0
        for t in range(n):
            mh_sen += float(np.abs(sen_feats[t] - prev).sum(1).mean())
            prev = sen_feats[t]
        hamming_sen.append(mh_sen / float(n))
        prev = np.zeros_like(rec_feats[0])
        mh_rec = 0.0
        for t in range(n):
            mh_rec += float(np.abs(rec_feats[t] - prev).sum(1).mean())
            prev = rec_feats[t]
        hamming_rec.append(mh_rec / float(n))

    if total == 0:
        raise ValueError("dev set is empty — nothing to evaluate")

    write_confusion_matrix(flags.conf_mat, np.concatenate(true_labels),
                           np.concatenate(pred_labels))

    conversation_lengths = np.array(conversation_lengths)
    extra["conversation_lengths_mean"] = float(conversation_lengths.mean())
    extra["conversation_lengths_std"] = float(conversation_lengths.std())
    extra["hamming_sen_mean"] = float(np.array(hamming_sen).mean())
    extra["hamming_rec_mean"] = float(np.array(hamming_rec).mean())

    return correct / total, extra
