"""Development evaluation over the staged dev set, one copy to the host.

The port of ``multimodalgame_tpu/game/fast_eval.py``. The host evaluator
(``eval.py``) reads each batch's conversation record back to the host;
here each dev batch is one eval conversation (``make_eval_exchange``: on a
GPU one replay of the batch shape's captured CUDA graph, of the eval
kernel or of the plain conversation the kernel refuses) and its
statistics (top-k hits by rank counting, predictions, conversation
lengths, inter-step Hamming means) are computed on the device and stay
there until one copy at the end of the sweep. The numbers are those of
``eval.py``: the statistics use the same ``n_steps`` semantics through
step masks, and the ragged final batch is its own, smaller batch, so
padding never enters a statistic.
The accuracy denominator is ``num_batches * batch_size``, tail included
(model.py:667).

Exactly tied class scores (possible only with bit-equal description
rows) may rank differently from the host ``argsort``.

On a data-parallel mesh (``mesh``, ``parallel/mesh.py``) each rank
evaluates its rows of each dev batch (a ragged batch whole, on every
rank), with the eval uniforms of those global rows; the rows' records
are gathered in rank order, so every rank computes the whole batch's
statistics, turn count and predictions as one device does (JAX's sharded
dev sweep, tests/test_mesh_driver.py:191).

Under ``-flipout_dev`` each dev batch's conversation flips bits with
uniforms of its own: by default Philox keyed by ``(seed, step)`` and slot
``1 + i`` for batch ``i`` (``ops/philox.py:philox_eval_uniforms``), the
draws ``eval.py``'s host loop makes too; a caller may pass ``uniforms``,
a function ``(i, batch_size) -> {fz, fw}`` (the tests replay JAX's
``split(key, nb)`` draws through it, JAX fast_eval.py:63, 233).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.eval import (corrupt_mask_for,
                                           write_confusion_matrix)
from multimodalgame_tpu_torch.game.exchange import (ExchangeOutputs,
                                                    description_inputs)
from multimodalgame_tpu_torch.ops.philox import philox_eval_uniforms
from multimodalgame_tpu_torch.parallel.mesh import axis_rows, gather_record
from multimodalgame_tpu_torch.utils.device_pack import PackSpec
from multimodalgame_tpu_torch.utils.profiling import span

# ``(batch index, batch size) -> {fz, fw}``: a dev batch's eval uniforms.
EvalUniforms = Callable[[int, int], Dict[str, torch.Tensor]]


def batch_statistics(cfg, ex: ExchangeOutputs, target: torch.Tensor,
                     top_k: int) -> Dict[str, torch.Tensor]:
    """One dev batch's ``hits`` (), ``pred`` (B,), ``conv_len`` (B,),
    ``mh_sen`` () and ``mh_rec`` (), on the device (fast_eval.py:65-114)."""
    T = cfg.max_exchange
    n = ex.n_steps
    dev = ex.y.device
    live = (torch.arange(T, device=dev) < n).to(torch.float32)       # (T,)

    # Masked prediction selection over the n executed turns
    # (model.py:648-654).
    if cfg.fixed_exchange:
        outp = ex.y[-1]
    else:
        mprime = ex.stop_masks * (torch.arange(T + 1, device=dev)
                                  < n)[:, None, None]
        y_masks = (torch.minimum(1.0 - mprime[1:], mprime[:-1])
                   * live[:, None, None])
        outp = (ex.y * y_masks).sum(0)
    dist = torch.log_softmax(outp, dim=-1)
    # Rank counted with a strict ">", k clamped to the class count, as
    # the host argsort slice does.
    tscore = torch.gather(dist, -1, target[:, None])
    rank = (dist > tscore).sum(-1)
    hits = (rank < min(top_k, dist.shape[-1])).sum()

    # Conversation lengths: per-example stop-bit sum over the turns run
    # (model.py:671-672).
    conv_len = (ex.stop_feats * live[:, None, None]).sum((0, 2))

    # Mean inter-step Hamming distance against a zero turn -1
    # (model.py:675-691).
    def hamming(feats):
        prev = torch.cat([torch.zeros_like(feats[:1]), feats[:-1]], 0)
        d = (feats - prev).abs().sum(-1).mean(-1)                    # (T,)
        return (d * live).sum() / n

    return {"hits": hits, "pred": dist.argmax(-1), "conv_len": conv_len,
            "mh_sen": hamming(ex.sen_feats), "mh_rec": hamming(ex.rec_feats)}


def eval_dev_device(modules, eval_exchange: Callable, dev_ds: DeviceDataset,
                    epoch: int, shuffle: bool, batch_size: int, top_k: int,
                    desc: torch.Tensor,
                    corrupt_mask: Optional[torch.Tensor] = None,
                    desc_set_padded: Optional[torch.Tensor] = None,
                    desc_set_mask: Optional[torch.Tensor] = None,
                    seed: int = 0, step: int = 0,
                    uniforms: Optional[EvalUniforms] = None, mesh=None
                    ) -> Tuple[float, Dict[str, float], np.ndarray,
                               np.ndarray]:
    """Run the dev sweep; returns ``(dev_acc, extra, true_labels,
    pred_labels)``. The dev set's ``context`` goes with its features.
    On ``mesh`` every rank returns the whole sweep's numbers."""
    if dev_ds.size == 0:
        raise ValueError("dev set is empty — nothing to evaluate")
    idx = dev_ds.epoch_indices(epoch, shuffle, batch_size,
                               truncate_final_batch=True)
    rows = [r[r >= 0] for r in idx]
    dev = dev_ds.feats.device
    cfg = modules.cfg
    stats = []
    with torch.no_grad():
        for i, r in enumerate(rows):
            part = axis_rows(mesh, len(r))
            r_t = torch.as_tensor(r[part], device=dev)
            if uniforms is not None:
                u = uniforms(i, len(r))
                u = None if u is None else {k: v[:, part]
                                            for k, v in u.items()}
            else:
                u = philox_eval_uniforms(cfg, len(r_t), seed, step, 1 + i,
                                         dev, row_base=part.start)
            ex = eval_exchange(
                dev_ds.feats[r_t], desc, corrupt_mask,
                data_context=(None if dev_ds.context is None
                              else dev_ds.context[r_t]),
                desc_set_padded=desc_set_padded,
                desc_set_mask=desc_set_mask, uniforms=u)
            if len(r_t) < len(r):
                ex = gather_record(mesh, ex, cfg.fixed_exchange)
                r_t = torch.as_tensor(r, device=dev)
            stats.append(batch_statistics(cfg, ex,
                                          dev_ds.targets[r_t], top_k))
        nb, n = len(rows), sum(len(r) for r in rows)
        spec = PackSpec([("hits", (nb,)), ("pred", (n,)),
                         ("conv_len", (n,)), ("mh_sen", (nb,)),
                         ("mh_rec", (nb,))])
        flat = spec.pack({k: torch.cat([s[k].reshape(-1) for s in stats])
                          for k, _ in spec.fields}, dev)
    got = spec.unpack(flat.cpu().numpy())
    extra = {
        "conversation_lengths_mean": float(got["conv_len"].mean()),
        "conversation_lengths_std": float(got["conv_len"].std()),
        "hamming_sen_mean": float(got["mh_sen"].mean()),
        "hamming_rec_mean": float(got["mh_rec"].mean()),
    }
    acc = float(got["hits"].sum()) / float(nb * batch_size)
    return (acc, extra, dev_ds.targets_host[np.concatenate(rows)],
            got["pred"].astype(np.int64))


def run_device_dev_eval(flags, modules, eval_exchange: Callable, desc_pack,
                        dev_ds: DeviceDataset, epoch: int, step: int = 0,
                        uniforms: Optional[EvalUniforms] = None, mesh=None
                        ) -> Tuple[float, Dict[str, float]]:
    """The flag-driven dev evaluation of the training driver's cadence and
    of ``-eval_only``: builds the descriptions and the ``-bit_flip`` mask
    on the dev set's device, runs the sweep (``-flipout_dev`` draws keyed
    by ``(random_seed + 1, step)``; on ``mesh`` each rank its rows) and
    writes the confusion-matrix CSV (to this rank's ``-conf_mat`` path),
    the two in the spans ``mmg.dev.conversations`` and
    ``mmg.dev.confusion_matrix``. Returns ``(dev_acc, extra)``."""
    dev = dev_ds.feats.device
    with span("dev.conversations"):
        acc, extra, trues, preds = eval_dev_device(
            modules, eval_exchange, dev_ds, epoch, flags.shuffle_dev,
            flags.batch_size_dev, flags.top_k_dev,
            corrupt_mask=corrupt_mask_for(flags, modules.cfg, dev),
            seed=flags.random_seed + 1, step=step, uniforms=uniforms,
            mesh=mesh, **description_inputs(desc_pack, modules.cfg, dev))
    with span("dev.confusion_matrix"):
        write_confusion_matrix(flags.conf_mat, trues, preds)
    return acc, extra
