"""The whole eval conversation in one CUDA kernel.

Port of ``multimodalgame_tpu/ops/pallas_exchange.py``'s eval mode
(``_kernel`` with ``train=False``, reached through ``fused_eval_exchange``).
The kernel source is ``csrc/fused_exchange.cu``; it is compiled for
``sm_90a`` at first use and called through ``ctypes``
(``ops/cuda_build.py``).

* :func:`fused_eval_exchange` is the wrapper. A CUDA tensor always goes to
  the kernel (a failed build or launch raises); a CPU tensor goes to the
  plain version. Each launch adds one to ``fused_eval_exchange.launches``.
* :func:`fused_eval_exchange_reference` is the plain PyTorch version: a
  loop over the same math in the kernel's order.
* :func:`kernel_params` lays the agents' weights out as the kernel reads
  them: each Linear weight as its ``(in, out)`` transpose, ``y1`` split
  into its ``h_z`` and description blocks.

Unlike the JAX kernel, every batch size is served, 1 and 100 included:
the batch is tiled over thread blocks and the last tile is masked.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.ops import cuda_build
from multimodalgame_tpu_torch.ops.sampling import hard_round

SOURCE = "fused_exchange.cu"

# Kernel weights in the order of csrc/fused_exchange.cu's pointer table
# (after data, desc and the corrupt mask).
PARAM_ORDER = ("wimg", "bimg", "wcode", "bcode", "cbias", "wbin", "bbin",
               "wih", "whh", "bih", "bhh",
               "y1h", "y1d", "y1b", "y2k", "y2b",
               "sk", "sb", "whk", "whb", "wdk", "wk", "wb")

_MIX = {"sum": 0, "prod": 1}
_MIX_IGNORE_CODE = 2


class FusedEvalOutputs(NamedTuple):
    stop_feats: torch.Tensor  # (T, B, 1)
    stop_probs: torch.Tensor  # (T, B, 1)
    sen_feats: torch.Tensor   # (T, B, W) — post-corruption
    sen_probs: torch.Tensor   # (T, B, W)
    rec_feats: torch.Tensor   # (T, B, W)
    rec_probs: torch.Tensor   # (T, B, W)
    y: torch.Tensor           # (T, B, D)
    masks: torch.Tensor       # (T, B, 1) post-turn stop-mask chain


def supports_config(cfg: GameConfig) -> bool:
    """The kernel covers the non-attention binary-channel eval path
    without stochastic eval-time corruption (the JAX kernel's predicate,
    pallas_exchange.py:65-72)."""
    return (cfg.use_binary and not cfg.visual_attn and not cfg.desc_attn
            and cfg.rec_s_dim == 1 and cfg.rec_out_dim == 1
            and cfg.sender_mix in ("sum", "prod")
            and not (cfg.flipout_dev and (cfg.flipout_sen is not None or
                                          cfg.flipout_rec is not None)))


def param_shapes(cfg: GameConfig) -> Dict[str, Tuple[int, ...]]:
    F, H, W = cfg.img_feat_dim, cfg.img_h_dim, cfg.rec_w_dim
    R, V = cfg.rec_hidden, cfg.wv_dim
    return {
        "wimg": (F, H), "bimg": (H,), "wcode": (W, H), "bcode": (H,),
        "cbias": (W,), "wbin": (H, W), "bbin": (W,),
        "wih": (W, 3 * R), "whh": (R, 3 * R), "bih": (3 * R,),
        "bhh": (3 * R,),
        "y1h": (R, R), "y1d": (V, R), "y1b": (R,), "y2k": (R, 1),
        "y2b": (1,), "sk": (R, 1), "sb": (1,), "whk": (R, R), "whb": (R,),
        "wdk": (V, R), "wk": (R, W), "wb": (W,),
    }


@torch.no_grad()
def kernel_params(modules) -> Dict[str, torch.Tensor]:
    """The agents' weights in the kernel's layout (contiguous copies)."""
    sen, rec = modules.sender, modules.receiver
    R = rec.hid_dim

    def t(w):
        return w.detach().t().contiguous()

    def c(b):
        return b.detach().contiguous()

    return {
        "wimg": t(sen.image_layer.weight), "bimg": c(sen.image_layer.bias),
        "wcode": t(sen.code_layer.weight), "bcode": c(sen.code_layer.bias),
        "cbias": c(sen.code_bias),
        "wbin": t(sen.binary_layer.weight),
        "bbin": c(sen.binary_layer.bias),
        "wih": t(rec.rnn.weight_ih), "whh": t(rec.rnn.weight_hh),
        "bih": c(rec.rnn.bias_ih), "bhh": c(rec.rnn.bias_hh),
        "y1h": t(rec.y1.weight[:, :R]), "y1d": t(rec.y1.weight[:, R:]),
        "y1b": c(rec.y1.bias),
        "y2k": t(rec.y2.weight), "y2b": c(rec.y2.bias),
        "sk": t(rec.s.weight), "sb": c(rec.s.bias),
        "whk": t(rec.w_h.weight), "whb": c(rec.w_h.bias),
        "wdk": t(rec.w_d.weight),
        "wk": t(rec.w.weight), "wb": c(rec.w.bias),
    }


def _corrupt_vector(cfg: GameConfig, corrupt_mask: Optional[torch.Tensor],
                    like: torch.Tensor) -> torch.Tensor:
    if corrupt_mask is None:
        return torch.zeros(cfg.rec_w_dim, dtype=torch.float32,
                           device=like.device)
    return torch.as_tensor(corrupt_mask, dtype=torch.float32,
                           device=like.device).reshape(
                               cfg.rec_w_dim).contiguous()


def fused_eval_exchange_reference(cfg: GameConfig,
                                  params: Dict[str, torch.Tensor],
                                  data: torch.Tensor, desc: torch.Tensor,
                                  corrupt_mask: Optional[torch.Tensor] = None
                                  ) -> FusedEvalOutputs:
    """Plain PyTorch version of the kernel: the same math, in the same
    order, one turn per loop iteration."""
    p = params
    batch = data.shape[0]
    corrupt = _corrupt_vector(cfg, corrupt_mask, data)

    # Once per conversation.
    h_x = data @ p["wimg"] + p["bimg"]                          # (B, H)
    desc_proj = desc @ p["y1d"]                                 # (D, R)
    h_w_first = torch.sigmoid(p["cbias"])[None] @ p["wcode"] + p["bcode"]

    h_z = data.new_zeros((batch, cfg.rec_hidden))
    w_prev = data.new_full((batch, cfg.rec_w_dim), cfg.first_rec)
    mask = data.new_ones((batch, 1))
    sprod = data.new_ones((batch, 1))
    outs = []
    for t in range(cfg.max_exchange):
        # Sender: mix -> tanh -> binary layer -> round -> corrupt.
        if cfg.ignore_code:
            mixed = torch.tanh(h_x)
        else:
            h_w = (h_w_first.expand_as(h_x) if t == 0
                   else w_prev @ p["wcode"] + p["bcode"])
            mixed = (torch.tanh(h_x * h_w) if cfg.sender_mix == "prod"
                     else torch.tanh(h_x + h_w))
        z_probs = torch.sigmoid(mixed @ p["wbin"] + p["bbin"])
        z = torch.abs(hard_round(z_probs) - corrupt)

        # Receiver GRU, torch gate order [r | z | n].
        gi = z @ p["wih"] + p["bih"]
        gh = h_z @ p["whh"] + p["bhh"]
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_zg, h_n = gh.chunk(3, dim=-1)
        rg = torch.sigmoid(i_r + h_r)
        zg = torch.sigmoid(i_z + h_zg)
        ng = torch.tanh(i_n + rg * h_n)
        h_z = (1.0 - zg) * ng + zg * h_z

        # Stop bit from the (cumulative) stop probability.
        s_prob = torch.sigmoid(h_z @ p["sk"] + p["sb"])
        sprod = sprod * s_prob if cfg.s_prob_prod else s_prob
        s_bit = hard_round(sprod)

        # Class scores, then the query back to the Sender.
        y_hid = torch.relu((h_z @ p["y1h"] + p["y1b"])[:, None, :]
                           + desc_proj[None])
        y = (y_hid * p["y2k"][:, 0]).sum(-1) + p["y2b"]         # (B, D)
        wd = torch.softmax(y, dim=-1) @ desc                    # (B, V)
        h_wq = torch.tanh(h_z @ p["whk"] + p["whb"] + wd @ p["wdk"])
        w_probs = torch.sigmoid(h_wq @ p["wk"] + p["wb"])
        w_bits = (torch.zeros_like(w_probs) if cfg.ignore_receiver
                  else hard_round(w_probs))

        mask = torch.minimum(mask, s_bit)
        outs.append((s_bit, s_prob, z, z_probs, w_bits, w_probs, y, mask))
        w_prev = w_bits
    return FusedEvalOutputs(*(torch.stack(v) for v in zip(*outs)))


def compare_outputs(cfg: GameConfig, got, want, tie: float = 1e-5,
                    prob_atol: float = 1e-5, y_atol: float = 1e-4
                    ) -> Dict[str, float]:
    """Hold one eval conversation against another (kernel against plain
    version, or two paths of serving), row by row.

    Bits (and masks, where both carry them) must be equal. Two f32 paths
    that sum in different orders may still round a probability that lies
    on 0.5 differently, and the flipped bit then feeds every later turn
    (pallas_exchange.py:17-23). So a row whose first differing turn has a
    rounded probability (sender, receiver, or the stop product) within
    ``tie`` of 0.5 in either path counts as a tie: its turns from there on
    are not compared. Every other turn holds probabilities to
    ``prob_atol`` and ``y`` to ``y_atol``.

    Returns ``ok`` plus the counts of tie rows and failing rows and the
    largest differences seen.
    """
    g = {k: getattr(got, k).detach().cpu().double().numpy()
         for k in ("stop_feats", "stop_probs", "sen_feats", "sen_probs",
                   "rec_feats", "rec_probs", "y")}
    w = {k: getattr(want, k).detach().cpu().double().numpy() for k in g}
    bit_keys = ["stop_feats", "sen_feats", "rec_feats"]
    if hasattr(got, "masks") and hasattr(want, "masks"):
        g["masks"] = got.masks.detach().cpu().double().numpy()
        w["masks"] = want.masks.detach().cpu().double().numpy()
        bit_keys.append("masks")
    T, batch = g["y"].shape[:2]
    differ = np.zeros((T, batch), bool)
    for k in bit_keys:
        differ |= (g[k] != w[k]).any(-1)

    def near_half(o):
        sprod = (np.cumprod(o["stop_probs"], axis=0) if cfg.s_prob_prod
                 else o["stop_probs"])[..., 0]
        return ((np.abs(o["sen_probs"] - 0.5) < tie).any(-1)
                | (np.abs(o["rec_probs"] - 0.5) < tie).any(-1)
                | (np.abs(sprod - 0.5) < tie))

    near = near_half(g) | near_half(w)
    diverged = differ.any(0)
    first = np.where(diverged, differ.argmax(0), T)        # (B,)
    rows = np.arange(batch)
    tie_rows = diverged & near[np.minimum(first, T - 1), rows]
    bad_rows = diverged & ~tie_rows
    valid = np.arange(T)[:, None] < first[None, :]          # (T, B)
    prob_err = max(float(np.abs(g[k] - w[k])[valid].max(initial=0.0))
                   for k in ("stop_probs", "sen_probs", "rec_probs"))
    y_err = float(np.abs(g["y"] - w["y"])[valid].max(initial=0.0))
    return {"ok": bool(not bad_rows.any() and prob_err <= prob_atol
                       and y_err <= y_atol),
            "tie_rows": int(tie_rows.sum()), "bad_rows": int(bad_rows.sum()),
            "max_prob_err": prob_err, "max_y_err": y_err,
            "max_abs_err": max(prob_err, y_err)}


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.mmg_fused_eval_exchange
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mmg_error_string.argtypes = [ctypes.c_int]
    lib.mmg_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, shape, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def fused_eval_exchange(cfg: GameConfig, params: Dict[str, torch.Tensor],
                        data: torch.Tensor, desc: torch.Tensor,
                        corrupt_mask: Optional[torch.Tensor] = None
                        ) -> FusedEvalOutputs:
    """Run the whole eval conversation: in one kernel launch for CUDA
    tensors, through :func:`fused_eval_exchange_reference` for CPU ones.

    ``params`` is :func:`kernel_params`'s dict; ``data`` is ``(B, feat)``,
    ``desc`` ``(D, wv)``, ``corrupt_mask`` an optional ``(w_dim,)`` 0/1
    bit-flip mask. All float32.
    """
    if not supports_config(cfg):
        raise ValueError("config not supported by the fused kernel")
    if data.device.type == "cpu":
        return fused_eval_exchange_reference(cfg, params, data, desc,
                                             corrupt_mask)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")

    dev = data.device
    batch, num_desc = data.shape[0], desc.shape[0]
    T, W = cfg.max_exchange, cfg.rec_w_dim
    if batch == 0:
        raise ValueError("empty batch")
    _check("data", data, (batch, cfg.img_feat_dim), dev)
    _check("desc", desc, (num_desc, cfg.wv_dim), dev)
    for name, shape in param_shapes(cfg).items():
        _check(name, params[name], shape, dev)
    corrupt = _corrupt_vector(cfg, corrupt_mask, data)

    outs = FusedEvalOutputs(*(
        torch.empty((T, batch, n), dtype=torch.float32, device=dev)
        for n in (1, 1, W, W, W, W, num_desc, 1)))
    tensors = ([data, desc, corrupt] + [params[k] for k in PARAM_ORDER]
               + list(outs))
    ptrs = (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])
    mix = _MIX_IGNORE_CODE if cfg.ignore_code else _MIX[cfg.sender_mix]
    dims = (ctypes.c_int * 11)(batch, cfg.img_feat_dim, cfg.img_h_dim, W,
                               cfg.rec_hidden, num_desc, cfg.wv_dim, T, mix,
                               int(cfg.ignore_receiver),
                               int(cfg.s_prob_prod))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mmg_fused_eval_exchange(ptrs, len(tensors), dims,
                                         len(dims), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("fused eval-exchange kernel launch failed: "
                           + lib.mmg_error_string(rc).decode())
    fused_eval_exchange.launches += 1
    return outs


fused_eval_exchange.launches = 0
