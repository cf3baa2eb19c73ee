"""The eval-mode exchange used by serving (``game/train.py``'s
``make_eval_exchange`` in the JAX package). Training is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.exchange import (ExchangeOutputs,
                                                    exchange,
                                                    finalize_stop_masks)
from multimodalgame_tpu_torch.ops.cuda_exchange import (fused_eval_exchange,
                                                        kernel_params,
                                                        supports_config)


def make_eval_exchange(modules: AgentModules, use_kernel: bool = True
                       ) -> Callable[..., ExchangeOutputs]:
    """Build ``run(data, desc, corrupt_mask=None) -> ExchangeOutputs``, the
    eval conversation (rounded messages, cumulative stop product —
    model.py:640, 1463-1465).

    With ``use_kernel`` a config that :func:`supports_config` accepts goes
    through :func:`fused_eval_exchange` at every batch size: the CUDA
    kernel for CUDA tensors, its plain version for CPU ones. Other configs
    take the plain :func:`exchange`. The kernel-layout weights are rebuilt
    only when a parameter is replaced or changed in place.
    """
    cfg = modules.cfg
    kernel_ok = use_kernel and supports_config(cfg)
    packed = {"key": None, "params": None}

    def run(data: torch.Tensor, desc: torch.Tensor,
            corrupt_mask: Optional[torch.Tensor] = None) -> ExchangeOutputs:
        if not kernel_ok:
            return exchange(modules, data, desc, corrupt_mask=corrupt_mask)
        key = tuple((p.data_ptr(), p._version) for p in modules.parameters())
        if packed["key"] != key:
            packed["key"], packed["params"] = key, kernel_params(modules)
        f = fused_eval_exchange(cfg, packed["params"], data, desc,
                                corrupt_mask=corrupt_mask)
        stop_masks, n_steps = finalize_stop_masks(f.masks,
                                                  cfg.fixed_exchange)
        zeros = torch.zeros((cfg.max_exchange, data.shape[0], 1),
                            dtype=torch.float32, device=data.device)
        return ExchangeOutputs(
            stop_masks=stop_masks, stop_feats=f.stop_feats,
            stop_probs=f.stop_probs, sen_feats=f.sen_feats,
            sen_probs=f.sen_probs, rec_feats=f.rec_feats,
            rec_probs=f.rec_probs, y=f.y, bs=zeros, br=zeros,
            n_steps=n_steps, attn_scores=None)

    return run
