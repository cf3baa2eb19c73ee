"""Interval-log payload: everything one log window prints, in one
device-to-host copy.

The port of ``multimodalgame_tpu/game/logpack.py``. The reference's
interval logging (model.py:1341-1518) reads a dozen tensors per log
step. Here the packer slices the conversation records down to the
``exchange_samples`` rows that the sparkline dumps show and concatenates
every logged quantity (losses, entropies, argmax, the train-mode dump
and the re-run eval-mode dump, model.py:1463-1465) into one flat float32
tensor on the device; the driver copies it to the host once and formats
the log lines from :meth:`LogPacker.unpack`'s dict.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import ExchangeOutputs
from multimodalgame_tpu_torch.game.train import TrainMetrics
from multimodalgame_tpu_torch.utils.device_pack import PackSpec


def _dump_fields(prefix: str, T: int, S: int, w_dim: int, s_dim: int):
    """The fields of one conversation dump (train or eval)."""
    return [
        (prefix + "sen_probs", (T, S, w_dim)),
        (prefix + "sen_feats", (T, S, w_dim)),
        (prefix + "rec_probs", (T, S, w_dim)),
        (prefix + "rec_feats", (T, S, w_dim)),
        (prefix + "stop_probs", (T, S, s_dim)),
        (prefix + "stop_masks_post", (T, S, 1)),
        (prefix + "n_steps", ()),
    ]


def _dump_values(prefix: str, ex: ExchangeOutputs, S: int):
    return {
        prefix + "sen_probs": ex.sen_probs[:, :S],
        prefix + "sen_feats": ex.sen_feats[:, :S],
        prefix + "rec_probs": ex.rec_probs[:, :S],
        prefix + "rec_feats": ex.rec_feats[:, :S],
        prefix + "stop_probs": ex.stop_probs[:, :S],
        # Post-step masks: the reference's s_masks[1:] (model.py:852).
        prefix + "stop_masks_post": ex.stop_masks[1:, :S],
        prefix + "n_steps": ex.n_steps,
    }


class LogPacker:
    """Builds and decodes the one-copy interval-log payload."""

    def __init__(self, cfg: GameConfig, batch: int, n_samples: int):
        self.cfg = cfg
        self.n_samples = n_samples
        T = cfg.max_exchange
        fields = [
            ("loss_sen", ()), ("nll_loss", ()), ("loss_binary_rec", ()),
            ("loss_binary_s", ()), ("loss_bas_sen", ()),
            ("loss_bas_rec", ()), ("accuracy", ()), ("n_steps", ()),
            ("argmax", (batch,)),
            ("ent_binary_sen", (T,)),
            ("ent_binary_rec", (max(T - 1, 0),)),
            ("ent_y_rec", (T,)),
        ]
        if n_samples > 0:
            fields += _dump_fields("train_", T, n_samples,
                                   cfg.sender_out_dim, cfg.rec_s_dim)
            fields += _dump_fields("eval_", T, n_samples,
                                   cfg.sender_out_dim, cfg.rec_s_dim)
        self.spec = PackSpec(fields)

    def pack(self, m: TrainMetrics,
             ex_eval: Optional[ExchangeOutputs]) -> torch.Tensor:
        """The ``(total,)`` float32 payload, on the metrics' device."""
        values = {
            "loss_sen": m.loss_sen, "nll_loss": m.nll_loss,
            "loss_binary_rec": m.loss_binary_rec,
            "loss_binary_s": m.loss_binary_s,
            "loss_bas_sen": m.loss_bas_sen, "loss_bas_rec": m.loss_bas_rec,
            "accuracy": m.accuracy, "n_steps": m.exchange.n_steps,
            "argmax": m.argmax,
            "ent_binary_sen": m.ent_binary_sen,
            "ent_binary_rec": m.ent_binary_rec,
            "ent_y_rec": m.ent_y_rec,
        }
        if self.n_samples > 0:
            values.update(_dump_values("train_", m.exchange, self.n_samples))
            if ex_eval is not None:
                values.update(_dump_values("eval_", ex_eval,
                                           self.n_samples))
        return self.spec.pack(values, m.dist.device)

    def unpack(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        return self.spec.unpack(flat)
