"""Agent construction and parameter initialization.

The four-model build of the reference (model.py:1013-1064): Sender,
Receiver and the two Baseline value networks, each a submodule of its own
so that each keeps its own optimizer (model.py:1307-1330).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.models.baseline import Baseline
from multimodalgame_tpu_torch.models.receiver import Receiver
from multimodalgame_tpu_torch.models.sender import Sender

AGENT_NAMES = ("sender", "receiver", "baseline_sen", "baseline_rec")


class AgentModules(nn.Module):
    """The four agents of one game, with their parameters."""

    def __init__(self, cfg: GameConfig):
        super().__init__()
        self.cfg = cfg
        self.sender = Sender(
            feat_dim=cfg.img_feat_dim,
            h_dim=cfg.img_h_dim,
            w_dim=cfg.rec_w_dim,
            bin_dim_out=cfg.sender_out_dim,
            use_attn=cfg.visual_attn,
            attn_dim=cfg.attn_dim,
            attn_extra_context=cfg.attn_extra_context,
            attn_context_dim=cfg.attn_context_dim,
            sender_mix=cfg.sender_mix,
            ignore_code=cfg.ignore_code)
        self.receiver = Receiver(
            z_dim=cfg.sender_out_dim,
            desc_dim=cfg.wv_dim,
            hid_dim=cfg.rec_hidden,
            out_dim=cfg.rec_out_dim,
            w_dim=cfg.rec_w_dim,
            s_dim=cfg.rec_s_dim,
            desc_attn=cfg.desc_attn,
            desc_attn_dim=cfg.desc_attn_dim)
        # Sender baseline sees (h_x, z_r); Receiver baseline (z_s, h_z)
        # (model.py:1031-1034, 1056-1059).
        self.baseline_sen = Baseline(
            hid_dim=cfg.baseline_hid_dim, x_dim=cfg.img_h_dim,
            binary_dim=cfg.rec_w_dim, inp_dim=0)
        self.baseline_rec = Baseline(
            hid_dim=cfg.baseline_hid_dim, x_dim=0,
            binary_dim=cfg.rec_w_dim, inp_dim=cfg.rec_hidden)

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``: a function of the four agents
        run as the module's call, so that ``torch.func.functional_call``
        can run it on other parameters (bfloat16 copies, or one member of
        a population under ``torch.func.vmap``)."""
        return fn(self, *args, **kwargs)


def init_params(modules: AgentModules, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> AgentModules:
    """Initialize the four agents in place with the reference's schemes
    (models/init.py) from one ``torch.Generator`` seeded with ``seed``,
    and move them to ``device`` when given. Returns ``modules``."""
    gen = torch.Generator().manual_seed(seed)
    for name in AGENT_NAMES:
        getattr(modules, name).reset_parameters(gen)
    if device is not None:
        modules.to(device)
    return modules
