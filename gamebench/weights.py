"""The game's weights, made from a run's seed on the card.

The parameter table lists every leaf of the four agents under the names
that the port registers (the reference implementation's module layout:
Sender, Receiver with its GRU cell, and the two baselines), with shapes
worked out from the configuration. The weights are one Gaussian draw
from a ``torch.Generator`` on the card, cut into the leaves: a matrix
scaled by ``1/sqrt(fan_in)``, a bias by 0.1, the sender's ``code_bias``
left at unit scale, and the stop unit's bias set to ``stop_bias`` so that
conversations run several turns.
"""

from collections import OrderedDict
from typing import Dict

import torch


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    F, H, W = cfg["img_feat_dim"], cfg["img_h_dim"], cfg["sender_out_dim"]
    R, V, Hb = cfg["rec_hidden"], cfg["wv_dim"], cfg["baseline_hid_dim"]
    A = cfg["attn_dim"]
    s = OrderedDict()
    s["sender.code_bias"] = (W,)

    def lin(name, n_in, n_out, bias=True):
        s[name + ".weight"] = (n_out, n_in)
        if bias:
            s[name + ".bias"] = (n_out,)

    lin("sender.image_layer", F, H)
    lin("sender.code_layer", W, H)
    lin("sender.binary_layer", H, W)
    if cfg["visual_attn"]:
        lin("sender.attn_W_x", F, A)
        lin("sender.attn_W_w", W, A)
        lin("sender.attn_U", A, 1)
        if cfg["attn_extra_context"]:
            lin("sender.attn_W_g", cfg["attn_context_dim"], A)
    s["receiver.rnn.weight_ih"] = (3 * R, W)
    s["receiver.rnn.weight_hh"] = (3 * R, R)
    s["receiver.rnn.bias_ih"] = (3 * R,)
    s["receiver.rnn.bias_hh"] = (3 * R,)
    lin("receiver.w_h", R, R)
    lin("receiver.w_d", V, R, bias=False)
    lin("receiver.w", R, W)
    lin("receiver.y1", R + V, R)
    lin("receiver.y2", R, 1)
    lin("receiver.s", R, 1)
    lin("baseline_sen.linear1", H + W, Hb)
    lin("baseline_sen.linear2", Hb, 1)
    lin("baseline_rec.linear1", W + R, Hb)
    lin("baseline_rec.linear2", Hb, 1)
    return s


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of :func:`param_shapes`, float32 on ``device``."""
    shapes = param_shapes(cfg)
    sizes = [int(torch.Size(v).numel()) for v in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = flat[off:off + n].view(shape)
        off += n
        if name == "sender.code_bias":
            scale = 1.0
        elif len(shape) == 2:
            scale = shape[1] ** -0.5
        else:
            scale = 0.1
        out[name] = (x * scale).contiguous()
    out["receiver.s.bias"].fill_(float(cfg["stop_bias"]))
    return out
