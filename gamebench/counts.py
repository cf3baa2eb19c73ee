"""Operation and byte counts from the configuration's shapes, and the
table of peaks they are held against.

Every count is of the work, whatever implements it: the multiply-adds of
each product (two operations each) and the few elementwise terms that the
kernel's bound has always counted (the class scores' add, ReLU and
multiply-add). Symbols: batch ``B``, turns ``T``, feature width ``F``
(channels ``C`` over ``N`` positions with visual attention), sender hidden
``H``, message width ``W``, receiver hidden ``R``, description width
``V``, classes ``D``, baseline hidden ``Hb``, attention width ``A``,
context ``G``.
"""

from typing import Dict

import numpy as np

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the full 700 W power limit): float32 outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _turn(cfg: dict, B: int, D: int, t: int, train: bool) -> int:
    """One turn of the conversation (model.py:725-876)."""
    H, W, R = cfg["img_h_dim"], cfg["sender_out_dim"], cfg["rec_hidden"]
    V, F = cfg["wv_dim"], cfg["img_feat_dim"]
    f = 2 * B * H * W                       # binary layer
    if t > 0:
        f += 2 * B * W * H                  # code layer on the query
    if cfg["visual_attn"]:
        N, A = int(np.prod(cfg["feature_shape"][1:])), cfg["attn_dim"]
        f += 2 * B * N * F + 2 * B * F * H  # pooling, image layer
        if t > 0:
            f += 2 * B * W * A + 2 * B * N * A   # query keys, U
    f += 2 * B * (W + R) * 3 * R            # GRU cell
    f += 2 * B * R * (1 + 2 * R)            # stop, y1's h block, w_h
    f += 4 * B * D * R                      # add, ReLU, y2
    f += 2 * B * D * V                      # softmax-weighted descriptions
    f += 2 * B * V * R + 2 * B * R * W      # w_d, w
    if train:
        Hb = cfg["baseline_hid_dim"]
        f += 2 * B * (H + W) * Hb + 2 * B * Hb   # sender baseline
        f += 2 * B * (W + R) * Hb + 2 * B * Hb   # receiver baseline
    return f


def _once(cfg: dict, B: int, D: int) -> int:
    """The conversation-invariant products: the image layer on pooled
    features (per turn under attention), the description block of y1,
    the first turn's code, and the attention keys."""
    H, W, R, V = (cfg["img_h_dim"], cfg["sender_out_dim"],
                  cfg["rec_hidden"], cfg["wv_dim"])
    F = cfg["img_feat_dim"]
    f = 2 * D * V * R + 2 * W * H
    if cfg["visual_attn"]:
        N, A = int(np.prod(cfg["feature_shape"][1:])), cfg["attn_dim"]
        f += 2 * B * N * F * A
        if cfg["attn_extra_context"]:
            f += 2 * B * cfg["attn_context_dim"] * A
    else:
        f += 2 * B * F * H
    return f


def forward_flops(cfg: dict, batch: int, turns: int, train: bool) -> int:
    """A conversation of ``turns`` turns over ``batch`` rows; with
    ``train`` the baselines too."""
    D = cfg["num_classes"]
    return _once(cfg, batch, D) + sum(_turn(cfg, batch, D, t, train)
                                      for t in range(turns))


def train_flops(cfg: dict) -> int:
    """One update: the training conversation over all ``max_exchange``
    turns (it never breaks early) and its backward pass, counted as twice
    the forward's operations."""
    return 3 * forward_flops(cfg, cfg["batch_size"], cfg["max_exchange"],
                             True)


def kernel_param_shapes(cfg: dict) -> Dict[str, tuple]:
    """The exchange kernel's 23 weight inputs."""
    F, H, W = cfg["img_feat_dim"], cfg["img_h_dim"], cfg["rec_w_dim"]
    R, V = cfg["rec_hidden"], cfg["wv_dim"]
    return {"wimg": (F, H), "bimg": (H,), "wcode": (W, H), "bcode": (H,),
            "cbias": (W,), "wbin": (H, W), "bbin": (W,),
            "wih": (W, 3 * R), "whh": (R, 3 * R), "bih": (3 * R,),
            "bhh": (3 * R,), "y1h": (R, R), "y1d": (V, R), "y1b": (R,),
            "y2k": (R, 1), "y2b": (1,), "sk": (R, 1), "sb": (1,),
            "whk": (R, R), "whb": (R,), "wdk": (V, R), "wk": (R, W),
            "wb": (W,)}


def kernel_work(cfg: dict, batch: int, uniform_floats: int = 0,
                turns: int = 0) -> dict:
    """Operations and bytes one launch of the exchange kernel needs at
    these shapes, in either mode: every product of the kernel's body over
    ``turns`` turns (all ``max_exchange`` where 0: training never stops
    early; a served conversation needs only the turns its batch ran), each
    input read once (``uniform_floats`` counts pre-drawn uniforms where
    they are read; the Philox launches read none), each output of those
    turns written once. Only float32 operations count. The bound is the
    larger of operations over the float32 peak and bytes over the HBM
    peak."""
    F, H, W = cfg["img_feat_dim"], cfg["img_h_dim"], cfg["rec_w_dim"]
    R, V, D, T, B = (cfg["rec_hidden"], cfg["wv_dim"], cfg["num_classes"],
                     turns or cfg["max_exchange"], batch)
    flops = 2 * B * F * H + 2 * D * V * R + 2 * W * H
    per_turn = (2 * B * H * W + 2 * B * (W + R) * 3 * R
                + 2 * B * R * (1 + 2 * R) + 4 * B * D * R + 2 * B * D * V
                + 2 * B * V * R + 2 * B * R * W)
    flops += T * per_turn + (T - 1) * 2 * B * W * H
    n_in = B * F + D * V + W + uniform_floats + sum(
        int(np.prod(s)) for s in kernel_param_shapes(cfg).values())
    n_out = T * B * (3 + 4 * W + D)
    nbytes = 4 * (n_in + n_out)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
