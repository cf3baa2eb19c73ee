"""The plain reference of the photo tower: Qwen2.5-VL's vision encoder
(Bai et al., "Qwen2.5-VL Technical Report", arXiv:2502.13923; the
published forward of ``Qwen2_5_VisionTransformerPretrainedModel``), in
plain PyTorch and independent of the program, as the processor and the
encoder run it on one still image:

* preprocessing (``Qwen2VLImageProcessor``): the uint8 pixels, already
  resized to sides that are multiples of ``patch_size *
  spatial_merge_size``, through ``x / 255`` and CLIP's mean and std; the
  frame taken ``temporal_patch_size`` times; cut into ``patch_size``
  patches in the processor's order, each 2 x 2 merge unit contiguous and
  each patch flattened as (channel, frame, row, column);
* the patch embedding: the ``Conv3d`` of kernel and stride (frames,
  patch, patch) without a bias, over the repeated frame;
* the window order (``get_window_index``): the merge units cut into
  windows of ``window_size / patch_size / spatial_merge_size`` merge
  units a side, row-major over windows and within each, the last row and
  column of windows short where the grid does not divide;
* 2D rotary embeddings (``rot_pos_emb``): each patch's (row, column)
  over ``head_dim / 2`` with theta 10,000, the row's frequencies then the
  column's, taken twice, in the window order;
* ``depth`` blocks ``x + proj(attn(norm1(x)))`` then ``x +
  down(silu(gate(n)) * up(n))`` with ``n = norm2(x)``, RMSNorm at eps
  1e-6; attention inside each window (a loop over the windows'
  ``cu_seqlens``), or over the whole image in the blocks of
  ``fullatt_block_indexes``;
* the merger: RMSNorm, then each merge unit's four tokens side by side
  through Linear, GELU (exact), Linear to ``out_hidden_size``; the
  window order undone;
* the tap: the mean of each image's merged tokens.

Everything is float32, with TF32 off for the products (turned off for
the call and restored after). ``prec="fp8"`` is the control: both
operands of every linear layer (the patch embedding and the merger's
too) rounded to ``float8_e4m3fn``, each tensor scaled by its largest
magnitude over 448, before the product. ``fault`` plants one of the
controls' faults: ``"full_attention"`` (every block over the whole
image), ``"window_attention"`` (every block in windows), ``"rope_swap"``
(each patch's row and column exchanged in the rotary table) or
``"windows_joined"`` (the last two windows of the window order attended
as one in the windowed blocks: at 364 x 504 a window of 16 tokens and
the one of 8, 24 of the 936). Images run in blocks of at most
:data:`BLOCK`.
"""

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
RMS_EPS = 1e-6
ROPE_THETA = 10000.0
BLOCK = 25
FAULTS = ("full_attention", "window_attention", "rope_swap",
          "windows_joined")
FP8_MAX = 448.0


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``float8_e4m3fn`` under a per-tensor scale (its
    largest magnitude maps to 448), back in float32."""
    scale = x.abs().max().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def grid(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    """The patch grid ``(rows, columns)`` of an ``h`` x ``w`` image."""
    p, m = cfg["patch_size"], cfg["spatial_merge_size"]
    if h % (p * m) or w % (p * m):
        raise ValueError(f"{h} x {w} is not a multiple of {p * m} a side")
    return h // p, w // p


def patches(cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """uint8 images ``(B, 3, H, W)`` as the processor's flattened patches
    ``(B * gh * gw, 3 * T * P * P)``, float32, in its order."""
    B, C, H, W = pixels.shape
    P, m = cfg["patch_size"], cfg["spatial_merge_size"]
    T = cfg["temporal_patch_size"]
    gh, gw = grid(cfg, H, W)
    mean = torch.tensor(CLIP_MEAN, device=pixels.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=pixels.device)[:, None, None]
    x = (pixels.float() / 255.0 - mean) / std
    x = x[:, None].expand(B, T, C, H, W)   # the frame taken T times
    x = x.reshape(B, T, C, gh // m, m, P, gw // m, m, P)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(B * gh * gw, C * T * P * P)


def window_index(cfg: dict, gh: int, gw: int) -> Tuple[torch.Tensor,
                                                       List[int]]:
    """``get_window_index`` for one image: the merge units in window
    order, and the windows' cumulative token counts from 0."""
    m = cfg["spatial_merge_size"]
    vw = cfg["window_size"] // m // cfg["patch_size"]
    lh, lw = gh // m, gw // m
    index = torch.arange(lh * lw).reshape(lh, lw)
    pad_h, pad_w = vw - lh % vw, vw - lw % vw
    nh, nw = (lh + pad_h) // vw, (lw + pad_w) // vw
    padded = F.pad(index, (0, pad_w, 0, pad_h), value=-100)
    padded = padded.reshape(nh, vw, nw, vw).permute(0, 2, 1, 3)
    padded = padded.reshape(nh * nw, vw * vw)
    seqlens = (padded != -100).sum(-1)
    order = padded.reshape(-1)
    cu = [0]
    for n in seqlens.tolist():
        if n:
            cu.append(cu[-1] + n * m * m)
    return order[order != -100], cu


def rotary(cfg: dict, gh: int, gw: int, swap: bool = False
           ) -> torch.Tensor:
    """``rot_pos_emb`` for one image: each patch's angles ``(gh * gw,
    head_dim / 2)`` in the processor's order, the row's frequencies then
    the column's (``swap``: the column's then the row's)."""
    m = cfg["spatial_merge_size"]
    head_dim = cfg["hidden_size"] // cfg["num_heads"]
    dim = head_dim // 2
    inv_freq = 1.0 / (ROPE_THETA ** (torch.arange(0, dim, 2,
                                                  dtype=torch.float) / dim))
    hpos = torch.arange(gh)[:, None].expand(gh, gw)
    wpos = torch.arange(gw)[None, :].expand(gh, gw)

    def merge_order(pos):
        return pos.reshape(gh // m, m, gw // m, m).permute(0, 2, 1, 3) \
            .reshape(-1)
    pos = torch.stack([merge_order(hpos), merge_order(wpos)], -1)
    if swap:
        pos = pos.flip(-1)
    freqs = torch.outer(torch.arange(max(gh, gw), dtype=torch.float),
                        inv_freq)
    return freqs[pos].flatten(1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                     + RMS_EPS))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-b, a), -1)


class _Net:
    """One forward over a state dict in the published ``visual.*`` key
    layout (the prefix dropped)."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict, prec: str,
                 fault: Optional[str]):
        if prec not in ("f32", "fp8"):
            raise ValueError(f"no precision {prec!r}")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no fault {fault!r}")
        self.sd, self.cfg, self.prec, self.fault = sd, cfg, prec, fault

    def linear(self, x, name, bias=True):
        w = self.sd[name + ".weight"]
        if self.prec == "fp8":
            x, w = fp8(x), fp8(w)
        out = x @ w.t()
        return out + self.sd[name + ".bias"] if bias else out

    def attention(self, x, name, cu, cos, sin):
        """Attention over the sequence ``x`` ``(B, N, C)``, within each
        ``[cu[i], cu[i + 1])``."""
        B, N, C = x.shape
        heads = self.cfg["num_heads"]
        d = C // heads
        qkv = self.linear(x, name + ".qkv").reshape(B, N, 3, heads, d)
        q, k, v = qkv.unbind(2)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, h, N, d)
        outs = []
        for a, b in zip(cu[:-1], cu[1:]):
            s = torch.matmul(q[:, :, a:b], k[:, :, a:b].transpose(-1, -2))
            p = torch.softmax(s * d ** -0.5, dim=-1)
            outs.append(torch.matmul(p, v[:, :, a:b]))
        o = torch.cat(outs, 2).transpose(1, 2).reshape(B, N, C)
        return self.linear(o, name + ".proj")

    def mlp(self, x, name):
        gate = self.linear(x, name + ".gate_proj")
        up = self.linear(x, name + ".up_proj")
        return self.linear(F.silu(gate) * up, name + ".down_proj")

    def __call__(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg, sd = self.cfg, self.sd
        B, C, H, W = pixels.shape
        gh, gw = grid(cfg, H, W)
        N, unit = gh * gw, cfg["spatial_merge_size"] ** 2
        P, T = cfg["patch_size"], cfg["temporal_patch_size"]
        x = patches(cfg, pixels).reshape(-1, C, T, P, P)
        weight = sd["patch_embed.proj.weight"]
        if self.prec == "fp8":
            x, weight = fp8(x), fp8(weight)
        x = F.conv3d(x, weight, stride=(T, P, P)).reshape(B, N, -1)
        order, cu_window = window_index(cfg, gh, gw)
        if self.fault == "windows_joined":
            cu_window = cu_window[:-2] + cu_window[-1:]
        order = order.to(pixels.device)
        x = x.reshape(B, N // unit, unit, -1)[:, order].reshape(B, N, -1)
        angles = rotary(cfg, gh, gw, swap=self.fault == "rope_swap")
        angles = angles.to(pixels.device).reshape(N // unit, unit, -1)
        angles = angles[order].reshape(N, -1)
        emb = torch.cat((angles, angles), -1)[:, None, :]   # (N, 1, d)
        cos, sin = emb.cos(), emb.sin()
        cu_full = [0, N]
        for i in range(cfg["depth"]):
            full = i in cfg["fullatt_block_indexes"]
            if self.fault == "full_attention":
                full = True
            elif self.fault == "window_attention":
                full = False
            pre = f"blocks.{i}"
            x = x + self.attention(rms_norm(x, sd[pre + ".norm1.weight"]),
                                   pre + ".attn",
                                   cu_full if full else cu_window, cos, sin)
            x = x + self.mlp(rms_norm(x, sd[pre + ".norm2.weight"]),
                             pre + ".mlp")
        x = rms_norm(x, sd["merger.ln_q.weight"]).reshape(B, N // unit, -1)
        x = self.linear(F.gelu(self.linear(x, "merger.mlp.0")),
                        "merger.mlp.2")
        return x[:, torch.argsort(order)]


def state(sd: Dict[str, torch.Tensor], device=None
          ) -> Dict[str, torch.Tensor]:
    """A state dict in the ``visual.*`` layout (the prefix optional) as
    float32 on ``device``, keys without the prefix."""
    return {(k[len("visual."):] if k.startswith("visual.") else k):
            v.to(device=device, dtype=torch.float32)
            for k, v in sd.items()}


def forward(sd: Dict[str, torch.Tensor], cfg: dict, pixels: torch.Tensor,
            prec: str = "f32", fault: Optional[str] = None
            ) -> Dict[str, torch.Tensor]:
    """uint8 images ``(B, 3, H, W)``: ``{"tokens": (B, M, out_hidden),
    "features": (B, out_hidden)}``, the merged tokens in the processor's
    order and their mean, float32 on the pixels' device, in blocks of at
    most :data:`BLOCK` images. ``sd``: :func:`state`'s."""
    net = _Net(sd, cfg, prec, fault)
    parts = []
    with torch.no_grad(), _no_tf32():
        for a in range(0, pixels.shape[0], BLOCK):
            parts.append(net(pixels[a:a + BLOCK]))
    tokens = torch.cat(parts)
    return {"tokens": tokens, "features": tokens.mean(1)}


def relative_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's ``||got - want|| / ||want||``, in float64."""
    got, want = got.double(), want.double()
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp(
        min=math.ulp(0.0))
