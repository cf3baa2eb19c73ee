"""Agent construction and parameter initialization.

The Sender and Receiver of the reference's four-model build
(model.py:1013-1064). The two Baseline value networks take part only in
training and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.models.receiver import Receiver
from multimodalgame_tpu_torch.models.sender import Sender


class AgentModules(nn.Module):
    """The Sender and Receiver of one game, with their parameters."""

    def __init__(self, cfg: GameConfig):
        super().__init__()
        self.cfg = cfg
        self.sender = Sender(
            feat_dim=cfg.img_feat_dim,
            h_dim=cfg.img_h_dim,
            w_dim=cfg.rec_w_dim,
            bin_dim_out=cfg.sender_out_dim,
            use_attn=cfg.visual_attn,
            sender_mix=cfg.sender_mix,
            ignore_code=cfg.ignore_code)
        self.receiver = Receiver(
            z_dim=cfg.sender_out_dim,
            desc_dim=cfg.wv_dim,
            hid_dim=cfg.rec_hidden,
            out_dim=cfg.rec_out_dim,
            w_dim=cfg.rec_w_dim,
            s_dim=cfg.rec_s_dim,
            desc_attn=cfg.desc_attn)


def init_params(modules: AgentModules, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> AgentModules:
    """Initialize the agents in place with the reference's schemes
    (models/init.py) from a ``torch.Generator`` seeded with ``seed``, and
    move them to ``device`` when given. Returns ``modules``."""
    gen = torch.Generator().manual_seed(seed)
    modules.sender.reset_parameters(gen)
    modules.receiver.reset_parameters(gen)
    if device is not None:
        modules.to(device)
    return modules
