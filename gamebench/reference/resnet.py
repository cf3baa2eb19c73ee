"""The plain reference of the image tower: torchvision's ``resnet34`` (He
et al., "Deep Residual Learning for Image Recognition", arXiv:1512.03385)
as the original system's dataset build runs it (nyu-dl/MultimodalGame,
utils/package_data.py), in plain PyTorch and independent of the program:

* preprocessing (utils/package_data.py:171-178): the crop's uint8 pixels
  through ToTensor (``x / 255``) and Normalize(.5, .5) (``(x - 0.5) /
  0.5``);
* the stem: a 7x7 convolution of stride 2 and padding 3, batch norm, ReLU
  and a 3x3 max pool of stride 2 and padding 1;
* four stages of 3, 4, 6 and 3 basic blocks of 64, 128, 256 and 512
  channels, the first block of stages 2-4 of stride 2 with a 1x1
  convolution and batch norm on its shortcut: ``relu(bn2(conv2(relu(bn1(
  conv1(x))))) + shortcut(x))``;
* the taps of ``FeatureModel`` (utils/package_data.py:16-33, 81-131):
  ``layer4_2``, the last block's sum before its ReLU (the reference
  writes that block out by hand to reach it), ``avgpool_512``, the mean
  of the last ReLU over the 8x8 positions, and ``fc``, the 1,000 logits.

Batch norm is unfolded, as torchvision's eval mode computes it: ``(x -
running_mean) / sqrt(running_var + 1e-5) * weight + bias``. Everything is
float32, with TF32 off for the convolutions and products (turned off for
the call and restored after); ``prec="tf32"`` is the control, which
rounds both operands of every convolution and product to TF32, as a card
with TF32 on computes them. Images run in blocks of at most 100.
"""

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from gamebench.reference.game import tf32

STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
TAPS = ("layer4_2", "avgpool_512", "fc")
BN_EPS = 1e-5
BLOCK = 100
# The planted fault of the controls: this block's shortcut dropped.
FAULT_BLOCK = "layer3.5"


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


def to_tensor_normalize(pixels: torch.Tensor) -> torch.Tensor:
    """ToTensor, then Normalize(mean=.5, std=.5) on each channel."""
    x = pixels.float().div(255)
    mean = torch.full((x.shape[1], 1, 1), 0.5, device=x.device)
    std = torch.full((x.shape[1], 1, 1), 0.5, device=x.device)
    return x.sub(mean).div(std)


class _Net:
    """One forward over a state dict in torchvision's key layout."""

    def __init__(self, sd: Dict[str, torch.Tensor], prec: str,
                 fault: Optional[str], calibrate: bool):
        self.sd, self.prec = sd, prec
        self.fault, self.calibrate = fault, calibrate

    def conv(self, x, name, stride, padding):
        w = self.sd[name + ".weight"]
        if self.prec == "tf32":
            x, w = tf32(x), tf32(w)
        return F.conv2d(x, w, stride=stride, padding=padding)

    def bn(self, x, name):
        if self.calibrate:
            # The running statistics set from this batch's own: the
            # output standardised, as in a trained network.
            self.sd[name + ".running_mean"] = x.mean(dim=(0, 2, 3))
            self.sd[name + ".running_var"] = x.var(dim=(0, 2, 3),
                                                   unbiased=False)

        def c(k):
            return self.sd[f"{name}.{k}"][None, :, None, None]
        return ((x - c("running_mean")) / torch.sqrt(c("running_var")
                                                     + BN_EPS)
                * c("weight") + c("bias"))

    def block(self, x, name, stride):
        """``(output, the sum before the ReLU)``."""
        out = torch.relu(self.bn(self.conv(x, name + ".conv1", stride, 1),
                                 name + ".bn1"))
        out = self.bn(self.conv(out, name + ".conv2", 1, 1), name + ".bn2")
        if name + ".downsample.0.weight" in self.sd:
            short = self.bn(self.conv(x, name + ".downsample.0", stride, 0),
                            name + ".downsample.1")
        else:
            short = x
        pre = out if self.fault == "residual" and name == FAULT_BLOCK \
            else out + short
        return torch.relu(pre), pre

    def __call__(self, x, taps):
        x = torch.relu(self.bn(self.conv(x, "conv1", 2, 3), "bn1"))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        out = {}
        for i, (blocks, _, stride) in enumerate(STAGES, start=1):
            for b in range(blocks):
                x, pre = self.block(x, f"layer{i}.{b}",
                                    stride if b == 0 else 1)
        out["layer4_2"] = pre
        pooled = x.mean(dim=(2, 3))
        out["avgpool_512"] = pooled
        if "fc" in taps:
            w = self.sd["fc.weight"]
            if self.prec == "tf32":
                pooled, w = tf32(pooled), tf32(w)
            out["fc"] = pooled @ w.t() + self.sd["fc.bias"]
        return {k: out[k] for k in taps}


def features(sd: Dict[str, torch.Tensor], pixels: torch.Tensor,
             taps: Sequence[str] = ("avgpool_512",), prec: str = "f32",
             fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The taps of uint8 crops ``(N, 3, S, S)``, on the pixels' device, in
    blocks of at most :data:`BLOCK` images. ``fault="residual"`` drops
    :data:`FAULT_BLOCK`'s shortcut (the controls' planted fault)."""
    unknown = set(taps) - set(TAPS)
    if unknown:
        raise KeyError(f"taps the reference has not: {sorted(unknown)}")
    net = _Net(sd, prec, fault, calibrate=False)
    parts = []
    with torch.no_grad(), _no_tf32():
        for a in range(0, pixels.shape[0], BLOCK):
            parts.append(net(to_tensor_normalize(pixels[a:a + BLOCK]),
                             taps))
    return {k: torch.cat([p[k] for p in parts]) for k in taps}


def calibrate(sd: Dict[str, torch.Tensor], pixels: torch.Tensor) -> None:
    """Set every batch norm's running mean and variance, in forward order,
    to the (biased) statistics of its input over ``pixels``, one batch."""
    with torch.no_grad(), _no_tf32():
        _Net(sd, "f32", None, calibrate=True)(to_tensor_normalize(pixels),
                                               ())
