"""Batch inference / serving on PyTorch.

The port of ``multimodalgame_tpu/serve.py``: the deterministic eval
conversation as a checkpoint-loadable predictor. On a GPU each request
batch runs the whole conversation in one CUDA kernel launch
(ops/cuda_exchange.py) for every config the kernel supports; the others
(attention, ``mou``, ``-flipout_dev`` with flipout) run the plain
conversation. Visual attention with ``attn_extra_context`` needs each
request's ``fc`` context, description attention the pack's padded word
sets. Under ``-flipout_dev`` every request flips bits with the same draws
(Philox keyed by ``(0, 0)``, slot 0), as the JAX Predictor's fixed key
does.

CLI: ``python -m multimodalgame_tpu_torch.serve -checkpoint <path.pt>
-log_load <train json> -dev_file <hdf5>`` prints JSONL predictions, the
same lines as the JAX package's serve.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.config import Flags
from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import description_inputs
from multimodalgame_tpu_torch.game.losses import get_rec_outp
from multimodalgame_tpu_torch.game.masks import assemble_loss_masks
from multimodalgame_tpu_torch.game.train import make_eval_exchange
from multimodalgame_tpu_torch.ops.philox import philox_eval_uniforms
from multimodalgame_tpu_torch.utils.device import resolve_device
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_reference_checkpoint)

Device = Optional[Union[str, torch.device]]


class Predictor:
    """Checkpoint-backed batched game predictor.

    ``device`` defaults to ``cuda`` (and raises without a GPU); pass
    ``device="cpu"`` for the plain PyTorch path on the CPU. ``use_kernel``
    routes supported configs through the fused CUDA kernel.
    """

    def __init__(self, cfg: GameConfig, modules: AgentModules,
                 desc_pack: DescriptionPack, device: Device = None,
                 use_kernel: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.modules = modules.to(self.device).eval()
        self.desc_pack = desc_pack
        self._descs = description_inputs(desc_pack, cfg, self.device)
        self._desc = self._descs["desc"].contiguous()
        self._exchange = make_eval_exchange(self.modules,
                                            use_kernel=use_kernel)

    @classmethod
    def from_checkpoint(cls, flags: Flags, desc_pack: DescriptionPack,
                        device: Device = None,
                        use_kernel: bool = True) -> "Predictor":
        """Load ``flags.checkpoint``, a reference-layout ``.pt``."""
        cfg = GameConfig.from_flags(flags)
        _, modules = load_reference_checkpoint(flags.checkpoint, cfg)
        return cls(cfg, modules, desc_pack, device=device,
                   use_kernel=use_kernel)

    @torch.inference_mode()
    def predict(self, features: np.ndarray,
                data_context: Optional[np.ndarray] = None) -> Dict:
        """Run conversations for a feature batch ``(B, feat)`` (``(B,
        feat, H, W)`` maps under visual attention, with their context
        ``(B, attn_context_dim)`` under ``attn_extra_context``).

        Returns a dict with ``prediction`` (B,), ``log_probs`` (B, D),
        ``conversation_length`` (B,), ``sender_messages`` /
        ``receiver_messages`` (n, B, W), and ``n_steps``.
        """
        data = torch.as_tensor(np.asarray(features, np.float32),
                               device=self.device).contiguous()
        ctx = (None if data_context is None else torch.as_tensor(
            np.asarray(data_context, np.float32), device=self.device))
        ex = self._exchange(
            data, self._desc, data_context=ctx,
            desc_set_padded=self._descs["desc_set_padded"],
            desc_set_mask=self._descs["desc_set_mask"],
            uniforms=philox_eval_uniforms(self.cfg, data.shape[0], 0, 0, 0,
                                          self.device))
        # Fixed exchanges score the LAST turn, like training and eval
        # (the stop unit gets no training signal in fixed mode).
        y_masks = (None if self.cfg.fixed_exchange
                   else assemble_loss_masks(ex.stop_masks).y)
        outp, _ = get_rec_outp(ex.y, y_masks)
        dist = torch.log_softmax(outp, dim=-1).cpu().numpy()
        n = int(ex.n_steps)
        return {
            "prediction": dist.argmax(axis=1),
            "log_probs": dist,
            "conversation_length": ex.stop_feats[:n].sum(dim=(0, 2))
            .cpu().numpy(),
            "sender_messages": ex.sen_feats[:n].cpu().numpy(),
            "receiver_messages": ex.rec_feats[:n].cpu().numpy(),
            "n_steps": n,
        }


def main(argv=None, device: Device = None) -> None:
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.descriptions import load_descriptions
    from multimodalgame_tpu_torch.data.hdf5_loader import load_hdf5

    flags = flags_from_argv(argv)
    device = resolve_device(device)
    if int(flags.mesh_model or 0) > 1:
        raise ValueError(
            "-mesh_model is a training option; serving shards "
            "the request batch axis only — drop -mesh_model")
    if int(flags.mesh or 0) not in (0, 1):
        raise NotImplementedError(
            "-mesh serving is not ported to PyTorch yet")
    desc_pack = load_descriptions(flags.descr_dev, flags.wv_type,
                                  flags.wv_dim, glove_path=flags.glove_path)
    pred = Predictor.from_checkpoint(flags, desc_pack, device=device)
    for batch in load_hdf5(flags.dev_file, flags.batch_size_dev, 0,
                           shuffle=False, truncate_final_batch=True,
                           map_labels=desc_pack.map_labels):
        # Attention with context needs the fc column (JAX serve.py:181-185).
        ctx = (batch[flags.data_context] if pred.cfg.attn_extra_context
               else None)
        out = pred.predict(batch[flags.img_feat], data_context=ctx)
        for ex_id, p, true in zip(batch["example_ids"], out["prediction"],
                                  batch["target"]):
            print(json.dumps({
                "example_id": ex_id.decode() if isinstance(ex_id, bytes)
                else str(ex_id),
                "prediction": int(p),
                "label": pred.desc_pack.idx_to_label.get(int(p)),
                "target": int(true),
            }))


if __name__ == "__main__":
    main(sys.argv[1:])
