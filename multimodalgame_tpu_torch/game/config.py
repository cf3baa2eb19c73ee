"""Static game/model configuration.

A copy of ``multimodalgame_tpu/game/config.py``'s frozen dataclass: the
same field names and defaults, which mirror the reference flags
(model.py:1686-1741), and the same ``sender_out_dim == rec_w_dim`` check.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GameConfig:
    # Dimensions (reference model.py:1693-1700)
    img_feat: str = "avgpool_512"
    img_feat_dim: int = 4096
    img_h_dim: int = 100
    baseline_hid_dim: int = 500
    sender_out_dim: int = 50
    rec_hidden: int = 128
    rec_out_dim: int = 1
    rec_w_dim: int = 50
    rec_s_dim: int = 1
    wv_dim: int = 100

    # Conversation (model.py:1735-1737, 1709, 1713)
    max_exchange: int = 3
    fixed_exchange: bool = True
    use_binary: bool = True
    first_rec: float = 0.0
    s_prob_prod: bool = True

    # Model variants (model.py:1692, 1703-1706, 1715-1720)
    sender_mix: str = "sum"
    ignore_code: bool = False
    ignore_receiver: bool = False
    visual_attn: bool = False
    attn_dim: int = 256
    attn_extra_context: bool = False
    attn_context_dim: int = 4096
    desc_attn: bool = False
    desc_attn_dim: int = 64

    # Channel corruption (model.py:1710-1712, 1738-1741)
    flipout_sen: Optional[float] = None
    flipout_rec: Optional[float] = None
    flipout_dev: bool = False
    bit_flip: bool = False
    corrupt_region: Optional[str] = None

    # Loss shaping (model.py:1730-1732)
    entropy_s: Optional[float] = None
    entropy_sen: Optional[float] = None
    entropy_rec: Optional[float] = None

    # Optimization (model.py:1725-1728)
    optim_type: str = "RMSprop"
    learning_rate: float = 1e-4

    # Training-time compute precision of the JAX package. The eval
    # conversation runs in float32 whatever this says, as in JAX.
    compute_dtype: str = "float32"

    def __post_init__(self):
        # The reference's hard invariant (model.py:1756-1757): the
        # sender's message and the receiver's query share the channel
        # width.
        if self.sender_out_dim != self.rec_w_dim:
            raise ValueError(
                f"sender_out_dim ({self.sender_out_dim}) must equal "
                f"rec_w_dim ({self.rec_w_dim})")

    @classmethod
    def from_flags(cls, flags) -> "GameConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in flags.flag_values_dict().items()
                  if k in names}
        return cls(**kwargs)
