"""The whole conversation in one CUDA kernel, in eval and train mode.

Port of ``multimodalgame_tpu/ops/pallas_exchange.py``: ``_kernel`` with
``train=False`` (reached through ``fused_eval_exchange``, serving) and
with ``train=True`` (reached through ``fused_train_forward``, phase A of
every training step). The kernel source is ``csrc/fused_exchange.cu``,
one body for both modes; it is compiled for ``sm_90a`` at first use and
called through ``ctypes`` (``ops/cuda_build.py``).

* :func:`fused_eval_exchange` and :func:`fused_train_forward` are the
  wrappers. A CUDA tensor always goes to the kernel (a failed build or
  launch raises); a CPU tensor goes to the plain version. Each launch
  adds one to the wrapper's ``launches``.
* :func:`fused_eval_exchange_reference` and
  :func:`fused_train_forward_reference` are the plain PyTorch versions: a
  loop over the same math in the kernel's order.
* :func:`kernel_params` lays the agents' weights out as the kernel reads
  them: each Linear weight as its ``(in, out)`` transpose, ``y1`` split
  into its ``h_z`` and description blocks.
* :func:`launch_plan` decides how the kernel is launched: CTAs per
  thread-block cluster, which per-turn matrices each CTA keeps in shared
  memory, and the shared-memory carve (a tile is always :data:`ROWS` batch
  rows). It goes to the
  kernel in the int table, which recomputes the carve and refuses a plan
  that disagrees or does not fit; a plan that fits nowhere raises here.
* :func:`phase_clocks` and :func:`link_cycles` measure the kernel through
  a second build with per-phase clock stamps (``-DMMG_PHASE_CLOCKS``);
  :func:`kernel_registers` reads each instance's registers.

The train mode samples ``u < p``. Its uniforms are either given, in the
JAX exchange's layout (``{s, z, w[, fz, fw]}``, each ``(T, B, dim)``
float32), or drawn in the kernel by Philox4x32-10 keyed by
``(seed, step)``; ``ops/philox.py`` computes the same numbers on the CPU.
A launch over a data-parallel shard of a batch passes ``row_base``, the
global row of its first row, so that the shards draw the whole batch's
numbers. The Philox key goes in by value, or as ``key``, an int64 tensor
``[seed, step, row_base]`` on the card that the kernel reads when it
runs: a captured training step (a CUDA graph, ``game/train.py``) replays
the same launch every step, and advances its own key on the device.

A wrapper's ``launches`` counts the kernel launches it makes. A launch
recorded into a CUDA graph runs only when the graph is replayed, so the
graph's owner takes the capture's counts back (:func:`launch_counts`,
:func:`set_launch_counts`) and adds them at each replay
(:func:`add_launches`). The eval mode reads nothing that is numbered by row: its
corrupt mask is one vector for every row, and the configs whose eval
conversation draws (``-flipout_dev`` with flipout) never reach it
(:func:`supports_config`).

Unlike the JAX kernel, every batch size is served, 1 and 100 included:
the batch is tiled over clusters and the last tile is masked.
"""

from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.ops import cuda_build
from multimodalgame_tpu_torch.ops.philox import STREAMS, philox_uniforms
from multimodalgame_tpu_torch.ops.sampling import (bernoulli_from_uniform,
                                                   flipout_from_uniform,
                                                   hard_round,
                                                   uniform_widths)

SOURCE = "fused_exchange.cu"

# Kernel weights in the order of csrc/fused_exchange.cu's pointer table
# (after data, desc and the corrupt mask).
PARAM_ORDER = ("wimg", "bimg", "wcode", "bcode", "cbias", "wbin", "bbin",
               "wih", "whh", "bih", "bhh",
               "y1h", "y1d", "y1b", "y2k", "y2b",
               "sk", "sb", "whk", "whb", "wdk", "wk", "wb")

_MIX = {"sum": 0, "prod": 1}
_MIX_IGNORE_CODE = 2

# The int table, in the order of csrc/fused_exchange.cu's enum Dim: sizes,
# flags, the launch plan, then the train mode's entries.
DIM_ORDER = ("B", "F", "H", "W", "R", "D", "V", "T", "MIX",
             "IGNORE_RECEIVER", "S_PROB_PROD", "CLUSTER", "RESIDENT",
             "PULL", "COMPACT", "SMEM_BYTES")
TRAIN_DIM_ORDER = ("PHILOX", "SEED", "STEP", "FLIP_SEN", "FLIP_REC",
                   "ROW_BASE")
# The pointer table, in the order of enum Ptr: inputs, PARAM_ORDER, the
# outputs (FusedEvalOutputs' order), then the uniform streams.
OUTPUT_ORDER = ("o_sfeat", "o_sprob", "o_zfeat", "o_zprob", "o_wfeat",
                "o_wprob", "o_y", "o_mask")
PTR_ORDER = ("data", "desc", "corrupt") + PARAM_ORDER + OUTPUT_ORDER
# The per-turn matrices the plan may keep in shared memory, in the order
# of enum Mat (bit i of the RESIDENT entry).
MATRIX_ORDER = ("wcode", "wbin", "wih", "whh", "y1h", "whk", "wk")

THREADS = 256                  # threads of a CTA
NWARPS = THREADS // 32
EXCHANGES = 4                  # pushes between a cluster's CTAs each turn
CTA_BARRIERS = 7               # __syncthreads() of a turn (after turn 0)
DESC_CHUNK = 16                # description rows staged at a time (set-up)
HX_WARPS = 4                   # set-up: warps of h_x; the rest do desc_proj
DESC_WARPS = NWARPS - HX_WARPS
IH_WARPS = 3                   # GRU: warps of z W_ih; the rest do h W_hh
SMEM_OPTIN_BYTES = 232448      # H100: dynamic shared memory a CTA may opt in to
# Batch rows per tile, and the cluster sizes in the planner's order: 4 CTAs
# where they hold the weights, else 8. Measured on an H100 at the
# canonical width, batch 64 (PERF.md): 4 rows and 4 CTAs beat 8 or 16 rows
# and 1, 2 or 8 CTAs.
ROWS = 4
CLUSTER_CHOICES = (4, 8)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_lanes(nc: int, k: int, nw: int = NWARPS) -> int:
    """Lanes that share one output column of a split-K product on ``nw``
    warps: the largest power of two up to 32 and up to ``k`` that still
    gives every column its lanes in one pass over the warps (1 when the
    columns outnumber the lanes). ``fused_exchange.cu:split_lanes`` is the
    same rule."""
    s = 1
    while s < 32 and 2 * s <= k and nc * 2 * s <= 32 * nw:
        s *= 2
    return s


def padded_ld(n: int, m: int) -> int:
    """Row stride (floats) of an ``n``-wide shared-memory matrix read by
    a warp as ``32 / m`` rows of ``m`` neighbours: the least stride >= n
    that is ``m`` modulo 32, so that the 32 lanes hit 32 banks."""
    m %= 32
    if m == 0:
        return n
    return n + (m - n % 32) % 32


class LaunchPlan(NamedTuple):
    cluster: int                 # CTAs per cluster (C)
    tiles: int                   # clusters in the grid (grid = tiles * C)
    resident: Tuple[str, ...]    # per-turn matrices held in shared memory
    in_device_memory: Tuple[str, ...]  # the rest, read through __ldg
    pull: bool                   # class-score partials read remotely
    compact: bool                # set-up products stored unpadded
    smem_bytes: int              # dynamic shared memory of one CTA
    offsets: Mapping[str, int]   # shared-memory carve, in floats (read-only)

    @property
    def resident_mask(self) -> int:
        return sum(1 << i for i, m in enumerate(MATRIX_ORDER)
                   if m in self.resident)


def smem_layout(F: int, H: int, W: int, R: int, D: int, V: int,
                cluster: int, resident, pull: bool,
                compact: bool) -> Tuple[Dict[str, int], int]:
    """Offsets (floats) of every region of one CTA's shared memory and
    its size in bytes; ``fused_exchange.cu:make_layout`` computes the same
    from the int table. CTA ``c`` of a cluster holds columns
    ``[c*hc, (c+1)*hc)`` of the sender's hidden width (``wcode`` columns,
    ``wbin`` rows) and ``[c*rc, (c+1)*rc)`` of the receiver's (the GRU's
    three gates, ``y1h``, ``whk``, ``desc_proj`` and ``desc.w_d`` columns,
    ``wk`` rows); for the set-up, its ``[y1_d | w_d]`` column slices and
    DESC_CHUNK rows of ``desc``. ``pull`` keeps one slot of class-score
    partials instead of one per CTA; ``compact`` drops the bank padding of
    ``desc_proj``, ``desc.w_d`` and ``[y1_d | w_d]``."""
    C, rows = cluster, ROWS
    hc, rc = _ceil(H, C), _ceil(R, C)
    shapes = {"wcode": (W, hc), "wbin": (hc, W), "wih": (W, 3 * rc),
              "whh": (R, 3 * rc), "y1h": (R, rc), "whk": (R, rc),
              "wk": (rc, W)}
    warps = {"wcode": NWARPS, "wbin": NWARPS, "wih": IH_WARPS,
             "whh": NWARPS - IH_WARPS, "y1h": NWARPS // 2,
             "whk": NWARPS // 2, "wk": NWARPS}      # each product's warps
    # 8-byte mbarriers: one per exchange.
    sizes = [("bars", 2 * EXCHANGES)]
    for m in MATRIX_ORDER:
        if m in resident:
            k, n = shapes[m]
            sizes.append((m, k * padded_ld(
                n, 32 // split_lanes(n, k, warps[m]))))
    ld_dp = rc if compact else padded_ld(rc, split_lanes(rows * D, rc))
    ld_dw = rc if compact else padded_ld(rc, 32 // split_lanes(rc, D))
    ld_wd = (2 * rc if compact else padded_ld(
        2 * rc, 32 // split_lanes(2 * rc, V, DESC_WARPS)))
    sizes += [("bcode", hc), ("bbin", W), ("bih", 3 * rc), ("bhh", 3 * rc),
              ("y1b", rc), ("whb", rc), ("sk", R), ("y2k", rc), ("wb", W),
              ("corrupt", W), ("dp", D * ld_dp), ("dw", D * ld_dw),
              ("dstage", DESC_CHUNK * V), ("wd", V * ld_wd),
              ("hx", rows * hc), ("mix", rows * hc), ("wbits", rows * W),
              ("zbits", rows * W), ("zpart", C * rows * W),
              ("h", 2 * rows * R), ("gi", rows * 3 * rc),
              ("gh", rows * 3 * rc), ("y1", rows * rc), ("wh", rows * rc),
              ("stop", rows), ("spart", (1 if pull else C) * rows * D),
              ("p", rows * D), ("hq", rows * rc), ("wpart", C * rows * W),
              ("mask", rows), ("sprod", rows), ("u", rows * (4 * W + 1))]
    offsets, o = {}, 0
    for name, n in sizes:
        offsets[name] = o
        o += _ceil(n, 4) * 4      # every region 16-byte aligned
    return offsets, 4 * o


@functools.lru_cache(maxsize=64)     # every launch asks; plans are immutable
def find_plan(F: int, H: int, W: int, R: int, D: int, V: int,
              batch: int, smem_limit: int = SMEM_OPTIN_BYTES
              ) -> Optional[LaunchPlan]:
    """The kernel's launch plan for these sizes: CTAs per cluster, which
    per-turn matrices live in shared memory, and the carve. A cluster of 4
    CTAs where it holds every matrix; failing that, 8 CTAs, then 8 with
    the class-score partials read remotely, then also without bank
    padding, then with the largest matrices left in device memory one by
    one. ``None`` when nothing fits ``smem_limit`` bytes or the batch is
    empty."""
    if batch < 1:
        return None
    sizes = (F, H, W, R, D, V)

    def fit(c, keep, pull, compact):
        offsets, nbytes = smem_layout(*sizes, c, keep, pull, compact)
        if nbytes > smem_limit:
            return None
        return LaunchPlan(
            c, _ceil(batch, ROWS),
            tuple(m for m in MATRIX_ORDER if m in keep),
            tuple(m for m in MATRIX_ORDER if m not in keep),
            pull, compact, nbytes, MappingProxyType(offsets))

    for c in CLUSTER_CHOICES[:-1]:
        plan = fit(c, MATRIX_ORDER, False, False)
        if plan is not None:
            return plan
    c = CLUSTER_CHOICES[-1]
    hc, rc = _ceil(H, c), _ceil(R, c)
    big = {"wcode": W * hc, "wbin": hc * W, "wih": W * 3 * rc,
           "whh": R * 3 * rc, "y1h": R * rc, "whk": R * rc, "wk": rc * W}
    for pull, compact in ((False, False), (True, False), (True, True)):
        keep = list(MATRIX_ORDER)
        while True:
            plan = fit(c, keep, pull, compact)
            if plan is not None:
                return plan
            if not (pull and compact) or not keep:
                break
            keep.remove(max(keep, key=lambda m: big[m]))
    return None


def launch_plan(F: int, H: int, W: int, R: int, D: int, V: int,
                batch: int, smem_limit: int = SMEM_OPTIN_BYTES
                ) -> LaunchPlan:
    """:func:`find_plan`, raising ValueError where it finds none."""
    if batch < 1:
        raise ValueError("empty batch")
    plan = find_plan(F, H, W, R, D, V, batch, smem_limit)
    if plan is None:
        raise ValueError(
            f"no launch plan fits {smem_limit} bytes of shared memory for "
            f"F={F} H={H} W={W} R={R} D={D} V={V}")
    return plan


def _sizes(cfg: GameConfig, batch: int, num_desc: int) -> tuple:
    return (cfg.img_feat_dim, cfg.img_h_dim, cfg.rec_w_dim, cfg.rec_hidden,
            num_desc, cfg.wv_dim, batch)


def plan_for(cfg: GameConfig, batch: int, num_desc: int) -> LaunchPlan:
    return launch_plan(*_sizes(cfg, batch, num_desc))


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
    """The kernel covers the non-attention binary-channel game with the
    sum or prod mix, without stochastic eval-time corruption (the JAX
    kernel's predicate for both modes, pallas_exchange.py:65-72)."""
    return (cfg.use_binary and not cfg.visual_attn and not cfg.desc_attn
            and cfg.rec_s_dim == 1 and cfg.rec_out_dim == 1
            and cfg.sender_mix in ("sum", "prod")
            and not (cfg.flipout_dev and (cfg.flipout_sen is not None or
                                          cfg.flipout_rec is not None)))


def eval_kernel_supports(cfg: GameConfig, batch: int,
                         num_desc: int) -> bool:
    """The eval-mode kernel may run this conversation: a config it
    supports (:func:`supports_config`) at sizes that a launch plan fits
    (:func:`find_plan`: ``batch`` rows, ``num_desc`` classes). Decided
    from the sizes alone, before any launch, as the JAX package gates its
    kernel on the batch (game/train.py:567); a size that no plan fits
    (the big game's 1,000 classes) takes the plain conversation."""
    return (supports_config(cfg)
            and find_plan(*_sizes(cfg, batch, num_desc)) is not None)


def train_kernel_supports(cfg: GameConfig, batch: int,
                          num_desc: int) -> bool:
    """The train-mode kernel may sample this phase A: what
    :func:`eval_kernel_supports` asks, and float32 training. The kernel
    samples in float32 only, as the JAX package's Pallas sampler does
    (fast_train.py:87-89); a bfloat16 game samples on the plain exchange,
    and its eval conversations (float32 in both packages) still take the
    eval kernel."""
    return (cfg.compute_dtype == "float32"
            and eval_kernel_supports(cfg, batch, num_desc))


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


def _reference(cfg: GameConfig, params: Dict[str, torch.Tensor],
               data: torch.Tensor, desc: torch.Tensor, corrupt: torch.Tensor,
               uniforms: Optional[Dict[str, torch.Tensor]]
               ) -> FusedEvalOutputs:
    """Both modes' plain version: eval when ``uniforms`` is None."""
    p = params
    train = uniforms is not None
    batch = data.shape[0]

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
        # Sender: mix -> tanh -> binary layer -> bits -> corrupt.
        if cfg.ignore_code:
            mixed = torch.tanh(h_x)
        else:
            h_w = (h_w_first.expand_as(h_x) if t == 0
                   else w_prev @ p["wcode"] + p["bcode"])
            mixed = (torch.tanh(h_x * h_w) if cfg.sender_mix == "prod"
                     else torch.tanh(h_x + h_w))
        z_probs = torch.sigmoid(mixed @ p["wbin"] + p["bbin"])
        if train:
            z = bernoulli_from_uniform(uniforms["z"][t], z_probs)
            if cfg.flipout_sen is not None:
                z = flipout_from_uniform(uniforms["fz"][t], z,
                                         cfg.flipout_sen)
        else:
            z = hard_round(z_probs)
        z = torch.abs(z - corrupt)

        # Receiver GRU, torch gate order [r | z | n].
        gi = z @ p["wih"] + p["bih"]
        gh = h_z @ p["whh"] + p["bhh"]
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_zg, h_n = gh.chunk(3, dim=-1)
        rg = torch.sigmoid(i_r + h_r)
        zg = torch.sigmoid(i_z + h_zg)
        ng = torch.tanh(i_n + rg * h_n)
        h_z = (1.0 - zg) * ng + zg * h_z

        # Stop bit: sampled, or the (cumulative) stop probability rounded.
        s_prob = torch.sigmoid(h_z @ p["sk"] + p["sb"])
        if train:
            s_bit = bernoulli_from_uniform(uniforms["s"][t], s_prob)
        else:
            sprod = sprod * s_prob if cfg.s_prob_prod else s_prob
            s_bit = hard_round(sprod)

        # Class scores, then the query back to the Sender.
        y_hid = torch.relu((h_z @ p["y1h"] + p["y1b"])[:, None, :]
                           + desc_proj[None])
        y = (y_hid * p["y2k"][:, 0]).sum(-1) + p["y2b"]         # (B, D)
        wd = torch.softmax(y, dim=-1) @ desc                    # (B, V)
        h_wq = torch.tanh(h_z @ p["whk"] + p["whb"] + wd @ p["wdk"])
        w_probs = torch.sigmoid(h_wq @ p["wk"] + p["wb"])
        if train:
            w_bits = bernoulli_from_uniform(uniforms["w"][t], w_probs)
            if cfg.flipout_rec is not None:
                w_bits = flipout_from_uniform(uniforms["fw"][t], w_bits,
                                              cfg.flipout_rec)
        else:
            w_bits = hard_round(w_probs)
        if cfg.ignore_receiver:
            w_bits = torch.zeros_like(w_probs)

        mask = torch.minimum(mask, s_bit)
        outs.append((s_bit, s_prob, z, z_probs, w_bits, w_probs, y, mask))
        w_prev = w_bits
    return FusedEvalOutputs(*(torch.stack(v) for v in zip(*outs)))


def fused_eval_exchange_reference(cfg: GameConfig,
                                  params: Dict[str, torch.Tensor],
                                  data: torch.Tensor, desc: torch.Tensor,
                                  corrupt_mask: Optional[torch.Tensor] = None
                                  ) -> FusedEvalOutputs:
    """Plain PyTorch version of the eval mode: the same math, in the same
    order, one turn per loop iteration."""
    return _reference(cfg, params, data, desc,
                      _corrupt_vector(cfg, corrupt_mask, data), None)


def fused_train_forward_reference(cfg: GameConfig,
                                  params: Dict[str, torch.Tensor],
                                  data: torch.Tensor, desc: torch.Tensor,
                                  uniforms: Dict[str, torch.Tensor]
                                  ) -> FusedEvalOutputs:
    """Plain PyTorch version of the train mode, given the uniforms
    ``{s, z, w[, fz, fw]}`` (for Philox, ``ops/philox.py``'s draw). The
    outputs' ``masks`` is the post-turn stop-mask chain; no corruption."""
    _check_uniforms(cfg, uniforms, data.shape[0], data.device, strict=False)
    return _reference(cfg, params, data, desc,
                      _corrupt_vector(cfg, None, data), uniforms)


def compare_outputs(cfg: GameConfig, got, want, tie: float = 1e-5,
                    prob_atol: float = 1e-5, y_atol: float = 1e-4,
                    uniforms: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, float]:
    """Hold one conversation against another (kernel against plain
    version, or two paths of serving), row by row.

    Bits (and masks, where both carry them) must be equal. Two f32 paths
    that sum in different orders may still put a probability on the other
    side of its threshold, and the flipped bit then feeds every later turn
    (pallas_exchange.py:17-23). The threshold is 0.5 in eval mode (for the
    sender, the receiver and the stop product) and, in train mode (given
    the ``uniforms`` both paths drew from), the uniform ``u`` of each
    ``u < p``. A row whose first differing turn has a probability within
    ``tie`` of its threshold in either path counts as a tie: its turns
    from there on are not compared. Every other turn holds probabilities
    to ``prob_atol`` and ``y`` to ``y_atol``.

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

    if uniforms is None:
        def near_threshold(o):
            sprod = (np.cumprod(o["stop_probs"], axis=0) if cfg.s_prob_prod
                     else o["stop_probs"])[..., 0]
            return ((np.abs(o["sen_probs"] - 0.5) < tie).any(-1)
                    | (np.abs(o["rec_probs"] - 0.5) < tie).any(-1)
                    | (np.abs(sprod - 0.5) < tie))
    else:
        u = {k: v.detach().cpu().double().numpy()
             for k, v in uniforms.items()}

        def near_threshold(o):
            return ((np.abs(o["sen_probs"] - u["z"]) < tie).any(-1)
                    | (np.abs(o["rec_probs"] - u["w"]) < tie).any(-1)
                    | (np.abs(o["stop_probs"] - u["s"]) < tie).any(-1))

    near = near_threshold(g) | near_threshold(w)
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


# The kernel's phases, in the order of csrc/fused_exchange.cu's enum Phase.
PHASES = ("setup", "sender_code_mix", "binary_sample", "gru", "heads",
          "scores_softmax", "query", "reply_sample")
PHASE_CLOCK_FLAGS = ("-DMMG_PHASE_CLOCKS",)


@functools.lru_cache(maxsize=None)
def _library(extra_flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE, extra_flags)
    fn = lib.mmg_fused_eval_exchange
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mmg_fused_train_forward
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mmg_phase_clocks.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    lib.mmg_phase_clocks.restype = ctypes.c_int
    lib.mmg_link_cycles.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_ulonglong)]
    lib.mmg_link_cycles.restype = ctypes.c_int
    lib.mmg_kernel_registers.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
    lib.mmg_kernel_registers.restype = ctypes.c_int
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


def _check_uniforms(cfg: GameConfig, uniforms: Dict[str, torch.Tensor],
                    batch: int, device: torch.device, strict: bool) -> None:
    """The uniform sets of a training conversation, each
    ``(T, batch, dim)`` on ``device``; ``strict`` (the kernel) also needs
    float32 and contiguity."""
    widths = uniform_widths(cfg, train=True)
    if set(uniforms) != set(widths):
        raise ValueError(f"uniforms must hold exactly {sorted(widths)}, got "
                         f"{sorted(uniforms)}")
    for name, width in widths.items():
        u = uniforms[name]
        shape = (cfg.max_exchange, batch, width)
        if strict:
            _check(f"uniforms[{name!r}]", u, shape, device)
        elif tuple(u.shape) != shape or u.device != device:
            raise ValueError(f"uniforms[{name!r}] is {tuple(u.shape)} on "
                             f"{u.device}, expected {shape} on {device}")


def _check_inputs(cfg: GameConfig, params: Dict[str, torch.Tensor],
                  data: torch.Tensor, desc: torch.Tensor) -> List:
    """Checks the kernel's inputs and returns the weights in PARAM_ORDER.
    Every launch pays for this loop, so only a tensor that fails is looked
    at again (by :func:`_check`) for the message."""
    dev = data.device
    if data.shape[0] == 0:
        raise ValueError("empty batch")
    shapes = param_shapes(cfg)
    weights = [params[k] for k in PARAM_ORDER]
    named = [("data", data, (data.shape[0], cfg.img_feat_dim)),
             ("desc", desc, (desc.shape[0], cfg.wv_dim))] + [
                 (k, w, shapes[k]) for k, w in zip(PARAM_ORDER, weights)]
    for name, x, shape in named:
        if (x.dtype is not torch.float32 or x.shape != shape
                or not x.is_contiguous() or x.device != dev):
            _check(name, x, shape, dev)
    return weights


def _dims(cfg: GameConfig, batch: int, num_desc: int,
          plan: LaunchPlan) -> list:
    values = {
        "B": batch, "F": cfg.img_feat_dim, "H": cfg.img_h_dim,
        "W": cfg.rec_w_dim, "R": cfg.rec_hidden, "D": num_desc,
        "V": cfg.wv_dim, "T": cfg.max_exchange,
        "MIX": _MIX_IGNORE_CODE if cfg.ignore_code else _MIX[cfg.sender_mix],
        "IGNORE_RECEIVER": int(cfg.ignore_receiver),
        "S_PROB_PROD": int(cfg.s_prob_prod),
        "CLUSTER": plan.cluster, "RESIDENT": plan.resident_mask,
        "PULL": int(plan.pull), "COMPACT": int(plan.compact),
        "SMEM_BYTES": plan.smem_bytes}
    return [values[k] for k in DIM_ORDER]


def _launch(fn_name: str, tensors, dims, *extra, device: torch.device,
            extra_flags: Tuple[str, ...] = ()) -> None:
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors])
    dims = (ctypes.c_int * len(dims))(*dims)
    lib = _library(extra_flags)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(ptrs, len(tensors), dims, len(dims),
                                   *extra, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           + lib.mmg_error_string(rc).decode())


def _empty_outputs(cfg: GameConfig, batch: int, num_desc: int,
                   device: torch.device) -> FusedEvalOutputs:
    W = cfg.rec_w_dim
    return FusedEvalOutputs(*(
        torch.empty((cfg.max_exchange, batch, n), dtype=torch.float32,
                    device=device)
        for n in (1, 1, W, W, W, W, num_desc, 1)))


def _eval_launch(cfg: GameConfig, params: Dict[str, torch.Tensor],
                 data: torch.Tensor, desc: torch.Tensor,
                 corrupt_mask: Optional[torch.Tensor],
                 plan: Optional[LaunchPlan] = None,
                 extra_flags: Tuple[str, ...] = ()) -> FusedEvalOutputs:
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    dev = data.device
    weights = _check_inputs(cfg, params, data, desc)
    batch, num_desc = data.shape[0], desc.shape[0]
    plan = plan or plan_for(cfg, batch, num_desc)
    # No mask: a null pointer, which the kernel reads as no corruption.
    corrupt = (None if corrupt_mask is None
               else _corrupt_vector(cfg, corrupt_mask, data))
    outs = _empty_outputs(cfg, batch, num_desc, dev)
    _launch("mmg_fused_eval_exchange", [data, desc, corrupt] + weights
            + list(outs), _dims(cfg, batch, num_desc, plan),
            device=dev, extra_flags=extra_flags)
    return outs


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
    outs = _eval_launch(cfg, params, data, desc, corrupt_mask)
    fused_eval_exchange.launches += 1
    return outs


fused_eval_exchange.launches = 0


def fused_train_forward(cfg: GameConfig, params: Dict[str, torch.Tensor],
                        data: torch.Tensor, desc: torch.Tensor, *,
                        uniforms: Optional[Dict[str, torch.Tensor]] = None,
                        seed: Optional[int] = None,
                        step: Optional[int] = None,
                        row_base: int = 0,
                        key: Optional[torch.Tensor] = None
                        ) -> FusedEvalOutputs:
    """Run the whole sampled (train-mode) conversation, without
    gradients: in one kernel launch for CUDA tensors, through
    :func:`fused_train_forward_reference` for CPU ones.

    The randomness is ``uniforms`` (``{s, z, w[, fz, fw]}``, each
    ``(T, B, dim)`` float32 on the data's device), or ``seed`` and
    ``step`` (each in ``[0, 2**32)``) for Philox, or ``key``, the same
    Philox key as an int64 tensor ``[seed, step, row_base]`` on the data's
    device, which the kernel reads when it runs; exactly one of them.
    Under Philox, ``row_base`` is the global row of ``data``'s first row (a
    data-parallel shard's offset in its batch): row ``r`` draws global
    row ``row_base + r``'s numbers. Given uniforms are the rows' own, and
    take ``row_base`` 0, as does ``key``, which carries its own.
    """
    if not supports_config(cfg):
        raise ValueError("config not supported by the fused kernel")
    if sum(x is not None for x in (uniforms, seed, key)) != 1:
        raise ValueError("give exactly one of uniforms, seed (with step) "
                         "and key")
    if seed is not None and (step is None or not 0 <= seed < 2 ** 32
                             or not 0 <= step < 2 ** 32):
        raise ValueError("Philox needs a seed and a step in [0, 2**32)")
    if not 0 <= row_base < 2 ** 31 - data.shape[0] or (
            seed is None and row_base):
        raise ValueError("row_base numbers Philox's rows: in [0, 2**31 - "
                         "batch), and 0 with given uniforms or a key")
    if key is not None and (key.dtype != torch.int64 or key.shape != (3,)
                            or key.device != data.device
                            or not key.is_contiguous()):
        raise ValueError(f"key must be a contiguous int64 tensor (3,) "
                         f"[seed, step, row_base] on {data.device}")
    if data.device.type == "cpu":
        if uniforms is None:
            uniforms = (philox_uniforms(cfg, data.shape[0], seed, step,
                                        row_base=row_base)
                        if key is None else
                        philox_uniforms(cfg, data.shape[0], key[0], key[1],
                                        row_base=key[2]))
        return fused_train_forward_reference(cfg, params, data, desc,
                                             uniforms)
    outs = _train_launch(cfg, params, data, desc, uniforms, seed, step,
                         row_base=row_base, key=key)
    fused_train_forward.launches += 1
    return outs


def _train_launch(cfg: GameConfig, params: Dict[str, torch.Tensor],
                  data: torch.Tensor, desc: torch.Tensor,
                  uniforms: Optional[Dict[str, torch.Tensor]],
                  seed: Optional[int], step: Optional[int],
                  plan: Optional[LaunchPlan] = None,
                  extra_flags: Tuple[str, ...] = (),
                  row_base: int = 0,
                  key: Optional[torch.Tensor] = None) -> FusedEvalOutputs:
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    dev = data.device
    weights = _check_inputs(cfg, params, data, desc)
    batch = data.shape[0]
    if uniforms is not None:
        _check_uniforms(cfg, uniforms, batch, dev, strict=True)
    streams = [None] * len(STREAMS)
    for name, index in STREAMS.items():
        if uniforms is not None and name in uniforms:
            streams[index] = uniforms[name]
    plan = plan or plan_for(cfg, batch, desc.shape[0])
    outs = _empty_outputs(cfg, batch, desc.shape[0], dev)
    philox = uniforms is None
    by_value = seed is not None
    as_int = lambda v: v - 2 ** 32 if v >= 2 ** 31 else v   # noqa: E731
    dims = _dims(cfg, batch, desc.shape[0], plan) + [
        int(philox), as_int(seed) if by_value else 0,
        as_int(step) if by_value else 0,
        int(cfg.flipout_sen is not None), int(cfg.flipout_rec is not None),
        int(row_base)]
    probs = (ctypes.c_float * 2)(
        0.0 if cfg.flipout_sen is None else cfg.flipout_sen,
        0.0 if cfg.flipout_rec is None else cfg.flipout_rec)
    # The train mode never corrupts: a null corrupt mask.
    _launch("mmg_fused_train_forward",
            [data, desc, None] + weights + list(outs) + streams + [key],
            dims, probs, 2, device=dev, extra_flags=extra_flags)
    return outs


fused_train_forward.launches = 0

# The wrappers whose launches are counted.
COUNTED = (fused_eval_exchange, fused_train_forward)


def launch_counts() -> Tuple[int, ...]:
    """Each counted wrapper's ``launches``, in :data:`COUNTED`'s order."""
    return tuple(f.launches for f in COUNTED)


def set_launch_counts(counts: Tuple[int, ...]) -> None:
    for f, n in zip(COUNTED, counts):
        f.launches = n


def add_launches(counts: Tuple[int, ...]) -> None:
    """Add ``counts`` (one per :data:`COUNTED` wrapper) to the wrappers'
    ``launches``: a graph replay's launches."""
    for f, n in zip(COUNTED, counts):
        f.launches += n


def phase_clocks(cfg: GameConfig, params: Dict[str, torch.Tensor],
                 data: torch.Tensor, desc: torch.Tensor, *,
                 train: bool = False,
                 uniforms: Optional[Dict[str, torch.Tensor]] = None,
                 seed: Optional[int] = None, step: Optional[int] = None
                 ) -> Dict[str, int]:
    """One conversation through the library built with the per-phase
    clock stamps (``-DMMG_PHASE_CLOCKS``): the SM cycles the grid's first
    CTA spent in each phase of :data:`PHASES`, summed over the turns, and
    under ``slowest_cta`` the whole cycles of the slowest CTA. A
    measurement tool, not counted in the wrappers' ``launches``; CUDA
    tensors only."""
    if train:
        _train_launch(cfg, params, data, desc, uniforms, seed, step, None,
                      PHASE_CLOCK_FLAGS)
    else:
        _eval_launch(cfg, params, data, desc, None, None, PHASE_CLOCK_FLAGS)
    torch.cuda.synchronize(data.device)
    out = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    lib = _library(PHASE_CLOCK_FLAGS)
    rc = lib.mmg_phase_clocks(out, len(out))
    if rc != 0:
        raise RuntimeError("mmg_phase_clocks failed: "
                           + lib.mmg_error_string(rc).decode())
    return dict(zip(PHASES + ("slowest_cta",), (int(v) for v in out)))


def link_cycles(cluster: int, iters: int = 1000) -> int:
    """SM cycles of one link of the conversation's chain with ``cluster``
    CTAs (the stamped build's probe kernel): a dependent shared-memory
    load, a warp reduction, and a CTA barrier (1 CTA) or a push to every
    CTA plus the wait for the cluster's pushes. For the latency floor."""
    out = ctypes.c_ulonglong()
    lib = _library(PHASE_CLOCK_FLAGS)
    rc = lib.mmg_link_cycles(cluster, iters, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError("mmg_link_cycles failed: "
                           + lib.mmg_error_string(rc).decode())
    return int(out.value)


def kernel_registers(train: bool) -> Dict[str, int]:
    """Registers and local-memory (spill) bytes per thread of the eval or
    train instance of the plain build, as the loaded module reports them
    (``cudaFuncGetAttributes``); needs a GPU."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    lib = _library()
    rc = lib.mmg_kernel_registers(int(train), ctypes.byref(regs),
                                  ctypes.byref(local))
    if rc != 0:
        raise RuntimeError("mmg_kernel_registers failed: "
                           + lib.mmg_error_string(rc).decode())
    return {"registers": regs.value, "local_bytes": local.value}
