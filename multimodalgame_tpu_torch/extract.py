"""Binary-message extraction to ``bv.hdf5`` for offline communication
analysis.

The port of ``multimodalgame_tpu/extract.py``, parity target the
reference's ``extract_binary`` (binary_vectors.py:12-135): the eval
conversation over the dev set (``make_eval_exchange``: one eval-kernel
launch a batch on a GPU), every turn's sender and receiver message
appended to an HDF5 file with two compound-dtype datasets:

* ``Communication``: ExampleId (S50), AgentId ('S'/'R'), Index (2t /
  2t+1), Target, Rank of the true class, BinaryProb, BinaryVec
  (binary_vectors.py:24-33);
* ``Predictions``: the same ids plus per-class prediction scores,
  StopProb, StopVec, StopMask (binary_vectors.py:35-46).

The dtypes are the reference's, so its analysis notebook reads the file
unchanged. The rank formula, quirks intact, and the single-class-batch
assertion (binary_vectors.py:93-99) are reproduced. ``h5py`` is imported
only when a file is written.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
from multimodalgame_tpu_torch.data.hdf5_loader import load_hdf5
from multimodalgame_tpu_torch.eval import context_of, sliced_masks
from multimodalgame_tpu_torch.game.exchange import description_inputs
from multimodalgame_tpu_torch.ops.philox import philox_eval_uniforms


def reference_rank(np_preds: np.ndarray, single_target: int) -> np.ndarray:
    """The reference's per-example "Rank" column, quirks intact
    (binary_vectors.py:99): ``np.abs(np_preds.argsort(1) - nclasses)[:,
    single_target]``. ``argsort(1)[:, t]`` is the index of the t-th
    smallest score, not the rank of class ``t``; downstream readers of
    the reference's ``bv.hdf5`` see exactly these values."""
    nclasses = np_preds.shape[1]
    return np.abs(np_preds.argsort(1) - nclasses)[:, single_target]


def extract_binary(flags, modules, eval_exchange: Callable, dev_file: str,
                   batch_size: int, epoch: int, shuffle: bool,
                   desc_pack: DescriptionPack, step: int = 0) -> str:
    """Write the conversation record of the dev set to
    ``flags.binary_output``, on the modules' device; ``step`` keys the
    ``-flipout_dev`` draws as in ``eval.py``. Returns the path."""
    import h5py

    cfg = modules.cfg
    sender_out_dim = cfg.sender_out_dim
    output_path = flags.binary_output
    num_desc = desc_pack.num_classes
    device = next(modules.parameters()).device
    descs = description_inputs(desc_pack, cfg, device)

    # Fixed-width byte strings ("S50"/"S1"), what the reference's py2
    # ``np.str_`` compound dtype wrote (binary_vectors.py:24-30).
    bin_vec_format = np.dtype([
        ("ExampleId", "S50"),
        ("AgentId", "S1"),
        ("Index", "i"),
        ("Target", "i"),
        ("Rank", "i"),
        ("BinaryProb", np.float32, (sender_out_dim,)),
        ("BinaryVec", np.float32, (sender_out_dim,)),
    ])
    preds_format = np.dtype([
        ("ExampleId", "S50"),
        ("AgentId", "S1"),
        ("Index", "i"),
        ("Target", "i"),
        ("Rank", "i"),
        ("Predictions", np.float32, (num_desc,)),
        ("StopProb", np.float32, (1,)),
        ("StopVec", np.float32, (1,)),
        ("StopMask", np.float32, (1,)),
    ])

    def append(ds, rows):
        ds.resize(ds.shape[0] + len(rows), axis=0)
        ds[-len(rows):] = rows

    with h5py.File(output_path, "w") as bin_vec_file:
        communication = bin_vec_file.create_dataset(
            "Communication", (0,), maxshape=(None,), dtype=bin_vec_format)
        predictions = bin_vec_file.create_dataset(
            "Predictions", (0,), maxshape=(None,), dtype=preds_format)

        for i, batch in enumerate(load_hdf5(
                dev_file, batch_size, epoch, shuffle,
                truncate_final_batch=True, map_labels=desc_pack.map_labels)):
            target = np.asarray(batch["target"])
            data = torch.as_tensor(batch[flags.img_feat], device=device)
            example_ids = [
                e.decode() if isinstance(e, bytes) else str(e)
                for e in batch["example_ids"]]
            bsz = target.shape[0]

            # No channel corruption: the reference's extraction never
            # sets exchange_args["corrupt"] (binary_vectors.py:66-78), so
            # the record is the clean-channel conversation even under
            # -bit_flip.
            with torch.no_grad():
                ex = eval_exchange(
                    data, descs["desc"],
                    data_context=context_of(flags, batch, device),
                    desc_set_padded=descs["desc_set_padded"],
                    desc_set_mask=descs["desc_set_mask"],
                    uniforms=philox_eval_uniforms(
                        cfg, bsz, flags.random_seed + 1, step, 1 + i,
                        device))
            ex = type(ex)(*(None if v is None else v.cpu().numpy()
                            for v in ex))
            n = int(ex.n_steps)
            s_masks = sliced_masks(ex.stop_masks, n)

            # One class per batch (binary_vectors.py:96-97).
            if len(set(target.tolist())) != 1:
                raise AssertionError("Rank only works if there is one target")
            single_target = int(target[0])

            for t in range(n):
                np_preds = ex.y[t]
                np_rank = reference_rank(np_preds, single_target)
                index = np.full(bsz, t, dtype=int)

                # Sender rows: Index = 2t (binary_vectors.py:102-115).
                append(communication, list(zip(
                    example_ids, np.full(bsz, "S"), index * 2, target,
                    np_rank, ex.sen_probs[t], ex.sen_feats[t])))
                # Receiver rows: Index = 2t+1 (binary_vectors.py:118-129).
                append(communication, list(zip(
                    example_ids, np.full(bsz, "R"), index * 2 + 1, target,
                    np_rank, ex.rec_probs[t], ex.rec_feats[t])))
                # Receiver prediction rows (binary_vectors.py:131-135);
                # StopMask is the pre-step mask, as the reference's zip
                # truncation gives it.
                append(predictions, list(zip(
                    example_ids, np.full(bsz, "R"), index * 2 + 1, target,
                    np_rank, np_preds, ex.stop_probs[t], ex.stop_feats[t],
                    s_masks[t])))
    return output_path
