"""Qwen2.5-VL's vision tower in front of a game: photos at their own
aspect in, one vector an image out.

The encoder of Qwen2.5-VL (Bai et al., arXiv:2502.13923), as the
published ``Qwen2_5_VisionTransformerPretrainedModel`` computes it on
still images, over a state dict in its ``visual.*`` key layout
(:func:`params_from_state`), with the widths of its ``vision_config``
(:data:`QWEN2_5_VL_7B`). A request is uint8 images ``(B, 3, H, W)``,
already resized by the processor's ``smart_resize`` (each side a
multiple of ``patch_size * spatial_merge_size``, 28), all of one shape:

* the pixels normalised with CLIP's mean and std, in float32, then cast
  to the tower's dtype;
* cut into 14 x 14 patches, each 2 x 2 merge unit contiguous, as the
  processor orders them, and embedded by one product. The published
  embedding is a ``Conv3d`` over the frame taken twice
  (``temporal_patch_size``); a still image's two frames are equal, so its
  two temporal kernels are summed once, in float32, when the tower is
  built, and rounded to the tower's dtype (a departure from the
  published order of rounding, held within the tests' tolerance);
* the merge units permuted into windows of 4 x 4 merge units by
  ``get_window_index``'s rule, the windows then put in order of size
  (stable), so that the windows of one size lie side by side: the
  layout and its inverse, and the rotary tables (``rot_pos_emb``: each
  patch's row and column over ``head_dim / 2`` frequencies of theta
  10,000, float32) in that order, are built once a request shape
  (:class:`Layout`, the span ``mmg.tower.layout``);
* ``depth`` blocks ``x + proj(attn(norm1(x)))`` then ``x +
  down(silu(gate(n)) * up(n))`` with ``n = norm2(x)`` (gate and up as
  one product of their stacked weights, the intermediate width padded
  with zeros from 3,420 to 3,424 so that down's operand rows align to 16
  bytes, which the card's fast bfloat16 products need), RMSNorm's statistics in
  float32 at eps 1e-6, the rotation of q and k in float32 and rounded
  once (``ops/cuda_vision.py:rotary_qkv``: on a card one kernel, which
  also writes q, k and v where attention reads them). Attention is
  ``scaled_dot_product_attention``: over each whole image (one call) in
  the blocks of ``fullatt_block_indexes``, and inside the windows in the
  others, one call a window size (the windows of a size batched, each
  size's q, k and v one contiguous block), so the calls a layer do not
  grow with the batch;
* the merger (RMSNorm, each merge unit's four tokens side by side
  through Linear, GELU, Linear to ``out_hidden_size``), the window
  order undone, and the mean of each image's merged tokens in float32:
  the tap the game reads, ``(B, out_hidden_size)``.

Weights and activations are bfloat16 (the published ``torch_dtype``),
every product accumulating in float32 (cuBLAS's reduced-precision
bfloat16 reductions and TF32 turned off while the body runs, and so in
its graph); ``dtype=torch.float32`` runs the same forward in float32.

Each request shape has a static uint8 buffer and one captured CUDA graph
on a card (``utils/cuda_graph.py:StagedGraphs``), eager elsewhere or
with ``graph=False``; nothing in the body waits on the host. The class
counts the process's runs, images, tokens, graph replays, attention
calls (windowed and full) and rotations (one a block, either route),
advanced at each replay through ``Captured``'s ``counters`` with the
rotary kernel's ``launches``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from multimodalgame_tpu_torch.ops import cuda_vision
from multimodalgame_tpu_torch.utils.cuda_graph import StagedGraphs
from multimodalgame_tpu_torch.utils.profiling import span

ARCH = "qwen2_5_vl_vision"
# The published vision_config of Qwen2.5-VL-7B-Instruct (config.json).
QWEN2_5_VL_7B = {"depth": 32, "hidden_size": 1280, "num_heads": 16,
                 "intermediate_size": 3420, "hidden_act": "silu",
                 "in_channels": 3, "patch_size": 14,
                 "temporal_patch_size": 2, "spatial_merge_size": 2,
                 "window_size": 112, "fullatt_block_indexes": [7, 15, 23, 31],
                 "out_hidden_size": 3584}
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
RMS_EPS = 1e-6
ROPE_THETA = 10000.0


# ---------------------------------------------------------------- params

def params_from_state(sd: Dict, cfg: dict, device, dtype=torch.bfloat16
                      ) -> Dict:
    """A state dict in the published ``visual.*`` layout (the prefix
    optional; tensors or arrays) as the forward's parameters in ``dtype``
    on ``device``: the patch embedding's temporal kernels summed (in
    float32) and flattened to ``(hidden, 3 * P * P)``, each block's gate
    and up stacked, the intermediate width padded with zeros to a
    multiple of 8."""
    sd = {(k[len("visual."):] if k.startswith("visual.") else k):
          torch.as_tensor(v) for k, v in sd.items()}

    def get(name, pad_rows=0, pad_cols=0):
        w = sd[name].to(device=device, dtype=dtype)
        if pad_rows or pad_cols:
            w = F.pad(w, (0, pad_cols) if w.dim() == 1 else
                      (0, pad_cols, 0, pad_rows))
        return w.contiguous()

    # The intermediate width padded with zeros to a multiple of 8, so that
    # the down product's rows are 16-byte aligned: gate and up give 0
    # there, and down's zero columns add nothing.
    pad = -cfg["intermediate_size"] % 8

    embed = sd["patch_embed.proj.weight"].to(device=device,
                                             dtype=torch.float32)
    out = {"embed": embed.sum(2).reshape(embed.shape[0], -1).to(dtype)
           .contiguous(), "blocks": []}
    for i in range(cfg["depth"]):
        pre = f"blocks.{i}."
        out["blocks"].append({
            "norm1": get(pre + "norm1.weight"),
            "qkv_w": get(pre + "attn.qkv.weight"),
            "qkv_b": get(pre + "attn.qkv.bias"),
            "proj_w": get(pre + "attn.proj.weight"),
            "proj_b": get(pre + "attn.proj.bias"),
            "norm2": get(pre + "norm2.weight"),
            "gate_up_w": torch.cat([get(pre + "mlp.gate_proj.weight", pad),
                                    get(pre + "mlp.up_proj.weight", pad)]),
            "gate_up_b": torch.cat([get(pre + "mlp.gate_proj.bias", 0, pad),
                                    get(pre + "mlp.up_proj.bias", 0, pad)]),
            "down_w": get(pre + "mlp.down_proj.weight", 0, pad),
            "down_b": get(pre + "mlp.down_proj.bias")})
    out["merger"] = {"norm": get("merger.ln_q.weight"),
                     "w0": get("merger.mlp.0.weight"),
                     "b0": get("merger.mlp.0.bias"),
                     "w2": get("merger.mlp.2.weight"),
                     "b2": get("merger.mlp.2.bias")}
    return out


# ---------------------------------------------------------------- layout

def windows(cfg: dict, gh: int, gw: int) -> List[List[int]]:
    """``get_window_index``'s windows of one image of ``gh`` x ``gw``
    patches: each window's merge units (row-major indices over the merge
    grid), windows row-major, the last row and column short where the
    grid does not divide."""
    m = cfg["spatial_merge_size"]
    vw = cfg["window_size"] // m // cfg["patch_size"]
    lh, lw = gh // m, gw // m
    return [[r * lw + c for r in range(r0, min(r0 + vw, lh))
             for c in range(c0, min(c0 + vw, lw))]
            for r0 in range(0, lh, vw) for c0 in range(0, lw, vw)]


class Layout:
    """A request shape's window layout, built once: ``order`` (the merge
    units in windows, windows grouped by size, largest first), its
    inverse, ``groups`` (``(first token, windows, tokens a window)`` of
    each size), the rotary ``cos`` and ``sin`` ``(N, 1, 1, head_dim)``,
    float32, in that order, and where the rotation writes each token
    (``window_dest`` and ``full_dest``, int32 ``(N, 2)``: the ``(start,
    length)`` of its group, or ``(0, N)``)."""

    def __init__(self, cfg: dict, h: int, w: int, device):
        P, m = cfg["patch_size"], cfg["spatial_merge_size"]
        gh, gw = h // P, w // P
        self.tokens = gh * gw
        unit = m * m
        wins = sorted(windows(cfg, gh, gw), key=len, reverse=True)
        order = [u for win in wins for u in win]
        self.groups: List[Tuple[int, int, int]] = []
        start = 0
        for size in sorted({len(x) for x in wins}, reverse=True):
            n = sum(len(x) == size for x in wins)
            self.groups.append((start, n, size * unit))
            start += n * size * unit
        self.order = torch.tensor(order, device=device)
        self.inverse = torch.argsort(self.order)
        self.window_dest = torch.tensor(
            [(start, n * s) for start, n, s in self.groups
             for _ in range(n * s)], dtype=torch.int32, device=device)
        self.full_dest = torch.tensor([(0, self.tokens)] * self.tokens,
                                      dtype=torch.int32, device=device)
        angles = rotary_angles(cfg, gh, gw)
        angles = angles.reshape(-1, unit, angles.shape[-1])[order]
        emb = torch.cat((angles, angles), -1).reshape(self.tokens, 1, 1,
                                                      -1)
        self.cos = emb.cos().to(device)
        self.sin = emb.sin().to(device)


def rotary_angles(cfg: dict, gh: int, gw: int) -> torch.Tensor:
    """``rot_pos_emb``: each patch's angles ``(gh * gw, head_dim / 2)``,
    float32, in the processor's order: its row's frequencies, then its
    column's."""
    m = cfg["spatial_merge_size"]
    dim = cfg["hidden_size"] // cfg["num_heads"] // 2
    inv_freq = 1.0 / (ROPE_THETA ** (torch.arange(0, dim, 2,
                                                  dtype=torch.float) / dim))
    freqs = torch.outer(torch.arange(max(gh, gw), dtype=torch.float),
                        inv_freq)
    rows = torch.arange(gh)[:, None].expand(gh, gw)
    cols = torch.arange(gw)[None, :].expand(gh, gw)

    def merged(pos):
        return pos.reshape(gh // m, m, gw // m, m).permute(0, 2, 1, 3) \
            .reshape(-1)
    return torch.cat([freqs[merged(rows)], freqs[merged(cols)]], -1)


# --------------------------------------------------------------- forward

@contextlib.contextmanager
def accumulate_in_float32():
    """TF32 and cuBLAS's reduced-precision bfloat16 reductions off
    inside, the caller's settings restored after."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
             torch.backends.cudnn.allow_tf32)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Qwen2's RMSNorm at eps 1e-6, its statistics in float32 (one pass;
    the weight applied before the one rounding to ``x``'s dtype, where the
    published module rounds before it too)."""
    return F.rms_norm(x, weight.shape, weight, RMS_EPS)


class VisionTower:
    """The tower on ``device`` from ``params`` (:func:`params_from_state`'s)
    and its ``cfg``; :meth:`stage` then :meth:`__call__` serve a request,
    :meth:`forward` runs one eagerly (the tests' entry)."""

    runs = 0
    images = 0
    tokens = 0
    replays = 0
    window_attention_launches = 0
    full_attention_launches = 0
    rotary_launches = 0

    def __init__(self, params: Dict, cfg: dict,
                 device: Union[str, torch.device],
                 graph: Optional[bool] = None):
        self.device = torch.device(device)
        self.cfg = dict(cfg)
        self.params = params
        self.full = set(cfg["fullatt_block_indexes"])
        self.mean = torch.tensor(CLIP_MEAN, device=self.device)[:, None, None]
        self.std = torch.tensor(CLIP_STD, device=self.device)[:, None, None]
        if self.device.type == "cuda":
            cuda_vision.library()
        capture = (self.device.type == "cuda") if graph is None \
            else bool(graph)
        self._runs = StagedGraphs(
            self._make_body, self.device, capture,
            counters=tuple((VisionTower, k) for k in (
                "runs", "images", "tokens", "window_attention_launches",
                "full_attention_launches", "rotary_launches"))
            + ((cuda_vision.rotary_qkv, "launches"),),
            replays=(VisionTower, "replays"))

    def check(self, x: np.ndarray) -> None:
        """``ValueError`` unless ``x`` is uint8 ``(B, 3, H, W)`` with H and
        W multiples of a merge unit's side."""
        s = self.cfg["patch_size"] * self.cfg["spatial_merge_size"]
        if x.dtype != np.uint8 or x.ndim != 4 or not x.shape[0] \
                or x.shape[1] != self.cfg["in_channels"] \
                or not x.shape[2] or not x.shape[3] \
                or x.shape[2] % s or x.shape[3] % s:
            raise ValueError(
                "a Predictor with Qwen2.5-VL's vision tower serves uint8 "
                f"pixels (B, 3, H, W), H and W multiples of {s} (the "
                "processor's smart_resize); got "
                f"{x.dtype} {tuple(x.shape)}")

    def layout(self, h: int, w: int) -> Layout:
        with span("tower.layout"):
            return Layout(self.cfg, h, w, self.device)

    def _make_body(self, buf: torch.Tensor):
        layout = self.layout(*buf.shape[2:])
        return lambda: self._body(buf, layout)

    @torch.no_grad()
    def _body(self, buf: torch.Tensor, layout: Layout
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.forward(buf, layout)

    def stage(self, pixels: np.ndarray) -> tuple:
        """Copy a batch of uint8 pixels into its shape's buffer; returns
        the key :meth:`__call__` takes."""
        return self._runs.stage(pixels)

    def __call__(self, key: tuple) -> torch.Tensor:
        """The pooled features ``(B, out_hidden_size)`` of the batch last
        staged under ``key``."""
        return self.outputs(key)[1]

    def outputs(self, key: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward`'s merged tokens and pooled features of the batch
        last staged under ``key``: one run (on a card, one replay)."""
        return self._runs.run(key)

    @torch.no_grad()
    def forward(self, pixels: torch.Tensor, layout: Optional[Layout] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 ``pixels`` ``(B, 3, H, W)`` on the device: the merged
        tokens ``(B, M, out_hidden_size)`` in the processor's order, in
        the tower's dtype, and their mean ``(B, out_hidden_size)`` in
        float32."""
        cfg, p = self.cfg, self.params
        B, C, H, W = pixels.shape
        if layout is None:
            layout = self.layout(H, W)
        P, m = cfg["patch_size"], cfg["spatial_merge_size"]
        N, M = layout.tokens, layout.tokens // (m * m)
        dtype = p["embed"].dtype
        VisionTower.runs += 1
        VisionTower.images += B
        VisionTower.tokens += B * N
        with accumulate_in_float32():
            x = ((pixels.float() / 255.0 - self.mean) / self.std).to(dtype)
            x = x.reshape(B, C, H // (P * m), m, P, W // (P * m), m, P)
            x = x.permute(0, 2, 5, 3, 6, 1, 4, 7).reshape(B, M, m * m, -1)
            x = F.linear(x[:, layout.order].reshape(B, N, -1), p["embed"])
            for i, blk in enumerate(p["blocks"]):
                x = x + self._attention(rms_norm(x, blk["norm1"]), blk,
                                        layout, i in self.full)
                gate, up = F.linear(rms_norm(x, blk["norm2"]),
                                    blk["gate_up_w"], blk["gate_up_b"]
                                    ).chunk(2, -1)
                x = x + F.linear(F.silu(gate) * up, blk["down_w"],
                                 blk["down_b"])
            g = p["merger"]
            x = rms_norm(x, g["norm"]).reshape(B, M, -1)
            x = F.linear(F.gelu(F.linear(x, g["w0"], g["b0"])), g["w2"],
                         g["b2"])
            tokens = x[:, layout.inverse]
            return tokens, tokens.float().mean(1)

    def _attention(self, x: torch.Tensor, blk: Dict, layout: Layout,
                   full: bool) -> torch.Tensor:
        B, N, C = x.shape
        heads = self.cfg["num_heads"]
        d = C // heads
        VisionTower.rotary_launches += 1
        q, k, v = cuda_vision.rotary_qkv(
            F.linear(x, blk["qkv_w"], blk["qkv_b"]), layout.cos, layout.sin,
            layout.full_dest if full else layout.window_dest, heads)
        if full:
            VisionTower.full_attention_launches += 1
            o = F.scaled_dot_product_attention(
                *(t.view(B, N, heads, d).transpose(1, 2) for t in (q, k, v)))
            o = o.transpose(1, 2).reshape(B, N, C)
        else:
            parts = []
            for start, n, s in layout.groups:
                VisionTower.window_attention_launches += 1

                def cut(t):
                    return t[B * start:B * (start + n * s)].view(
                        B * n, s, heads, d).transpose(1, 2)
                o = F.scaled_dot_product_attention(cut(q), cut(k), cut(v))
                parts.append(o.transpose(1, 2).reshape(B, n * s, C))
            o = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
        return F.linear(o, blk["proj_w"], blk["proj_b"])
