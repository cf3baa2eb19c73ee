"""ResNet-34 feature extractor with the pre-ReLU ``layer4_2`` tap.

The port of ``multimodalgame_tpu/models/resnet.py``. Parity target: the
reference's ``FeatureModel`` (utils/package_data.py:81-131), which wraps
torchvision's pretrained ResNet-34 and re-implements the last layer4
block by hand so that its pre-activation can be tapped. The taps the
dataset build asks for are ``layer4_2`` (512x8x8, pre-ReLU),
``avgpool_512`` (512) and ``fc`` (1000) at 227x227 input (the layer table
of utils/package_data.py:16-33).

A functional forward over an explicit parameter dict (from a torch
state_dict: a pretrained file or :func:`random_state_dict`), NCHW as
torch computes it, with inference-mode batch norm folded into a scale
and a shift. Every name of the reference's layer table can be asked for.
The convolutions are PyTorch's (cuDNN on a card): the JAX package
computes them outside any Pallas kernel. This plain forward
(:func:`resnet34_features`) is what the dataset build
(``package_data.py``) runs, and the tests' reference for the served one
below.

**Precision.** The forward computes in float32: on a card it turns
TF32 off for its convolutions and products (PyTorch lets cuDNN
convolutions run in TF32 by default, which moves features ~1e-3
relative away from the CPU's) and restores the caller's settings after.
A captured graph keeps the precision it was captured with, so the
served tower (:class:`PixelTower`) sets it once, while its body is
captured, and its replays touch no flag.

**Serving.** :class:`PixelTower` puts the network in front of a game
(``serve.py:Predictor(tower=...)``): uint8 pixels in, ToTensor +
Normalize(.5, .5) on the device, the forward to the tap the game reads,
one captured CUDA graph a batch size on a card. For every tap from
``bn1`` on, the tower folds each batch norm into the convolution before
it once, when it is built (:func:`fold_batch_norms`: the weights scaled,
the shift a bias), and runs the folded forward: each convolution
(cuDNN, no bias) followed by one pass of ``ops/cuda_tower.py``, a
hand-written kernel on a card (the bias, the shortcut and the ReLU; for
conv1 the max pool too) and its plain version elsewhere. The ``conv1``
tap reads the value before bn1's scale, which folding moves into the
weights, and keeps this module's plain forward.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from multimodalgame_tpu_torch.ops import cuda_tower
from multimodalgame_tpu_torch.ops.cuda_tower import normalize_pixels
from multimodalgame_tpu_torch.utils.cuda_graph import StagedGraphs

# torchvision resnet34's stages: (blocks, channels, first stride).
STAGES = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
BN_EPS = 1e-5

# The names resnet34_features serves (the reference's layer table).
LAYER_NAMES = (("conv1", "bn1", "relu", "maxpool")
               + tuple(f"layer{i}" for i in range(1, 5))
               + tuple(f"layer4_{b}_relu" for b in range(STAGES[3][0]))
               + ("layer4_2", "avgpool", "avgpool_512", "fc"))
# The taps the folded forward never holds: conv1's output before its
# batch norm's scale, which folding moves into the weights.
PLAIN_TAPS = ("conv1",)


# ---------------------------------------------------------------- params

def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _bn(sd, name) -> Dict[str, torch.Tensor]:
    # Inference-mode BN folded: (x - mean) / sqrt(var + eps) * gamma + beta
    # = x * s + b.
    gamma, beta, mean, var = (np.asarray(sd[f"{name}.{k}"], np.float32)
                              for k in ("weight", "bias", "running_mean",
                                        "running_var"))
    s = gamma / np.sqrt(var + BN_EPS)
    return {"scale": _tensor(s)[None, :, None, None],
            "shift": _tensor(beta - mean * s)[None, :, None, None]}


def params_from_torch_state(sd, device: Optional[Union[str, torch.device]]
                            = None) -> Dict:
    """A torchvision ``resnet34`` state_dict (tensors or numpy arrays) as
    the forward's parameters, float32 on ``device`` (the CPU by
    default): convolution weights OIHW as torch keeps them, each batch
    norm folded."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
              else np.asarray(v)) for k, v in sd.items()}
    params: Dict = {"conv1": _tensor(sd["conv1.weight"]),
                    "bn1": _bn(sd, "bn1"),
                    "fc": {"weight": _tensor(sd["fc.weight"]),
                           "bias": _tensor(sd["fc.bias"])}}
    for i, (blocks, _, _) in enumerate(STAGES, start=1):
        layer: List[Dict] = []
        for b in range(blocks):
            pre = f"layer{i}.{b}"
            blk = {"conv1": _tensor(sd[pre + ".conv1.weight"]),
                   "bn1": _bn(sd, pre + ".bn1"),
                   "conv2": _tensor(sd[pre + ".conv2.weight"]),
                   "bn2": _bn(sd, pre + ".bn2")}
            if pre + ".downsample.0.weight" in sd:
                blk["down_conv"] = _tensor(sd[pre + ".downsample.0.weight"])
                blk["down_bn"] = _bn(sd, pre + ".downsample.1")
            layer.append(blk)
        params[f"layer{i}"] = layer
    return params_to(params, device) if device is not None else params


def params_to(params, device) -> Dict:
    """The parameters on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return [params_to(v, device) for v in params]


def load_pretrained(path: str, device=None) -> Dict:
    """A torchvision resnet34 ``.pth`` state_dict file's parameters."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return params_from_torch_state(sd, device)


def random_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A randomly initialized resnet34 state_dict in torchvision's key
    layout (numpy arrays), drawn as the JAX package draws it from the
    same seed: a stand-in where no pretrained ``.pth`` is at hand."""
    rng = np.random.RandomState(seed)

    # Variance-preserving init (He/2 convolutions, BN near identity), so
    # activations stay O(1) through all 34 layers.
    def w(*shape, scale=None):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        scale = scale or np.sqrt(0.5 / fan_in)
        return (rng.randn(*shape) * scale).astype(np.float32)

    def bn(sd, name, c):
        sd[name + ".weight"] = (
            1.0 + 0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[name + ".running_mean"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[name + ".running_var"] = (
            1.0 + 0.1 * np.abs(rng.randn(c))).astype(np.float32)

    sd: Dict[str, np.ndarray] = {"conv1.weight": w(64, 3, 7, 7)}
    bn(sd, "bn1", 64)
    c_in = 64
    for i, (blocks, c_out, stride) in enumerate(STAGES, start=1):
        for b in range(blocks):
            pre = f"layer{i}.{b}"
            sd[pre + ".conv1.weight"] = w(c_out, c_in if b == 0 else c_out,
                                          3, 3)
            bn(sd, pre + ".bn1", c_out)
            sd[pre + ".conv2.weight"] = w(c_out, c_out, 3, 3)
            bn(sd, pre + ".bn2", c_out)
            if b == 0 and (stride != 1 or c_in != c_out):
                sd[pre + ".downsample.0.weight"] = w(c_out, c_in, 1, 1)
                bn(sd, pre + ".downsample.1", c_out)
        c_in = c_out
    sd["fc.weight"] = w(1000, 512)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def random_params(seed: int = 0, device=None) -> Dict:
    return params_from_torch_state(random_state_dict(seed), device)


# --------------------------------------------------------------- forward

@contextlib.contextmanager
def float32_precision():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside, the
    caller's settings restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _conv(x, weight, stride, padding=None):
    pad = weight.shape[-1] // 2 if padding is None else padding
    return F.conv2d(x, weight, stride=stride, padding=pad)


def _bn_apply(x, bn):
    return x * bn["scale"] + bn["shift"]


def _basic_block(x, blk, stride):
    """``(post-ReLU output, pre-ReLU output)``: the reference taps the
    pre-activation of layer4's last block (utils/package_data.py:59-78)."""
    out = torch.relu(_bn_apply(_conv(x, blk["conv1"], stride), blk["bn1"]))
    out = _bn_apply(_conv(out, blk["conv2"], 1), blk["bn2"])
    residual = x
    if "down_conv" in blk:
        residual = _bn_apply(_conv(x, blk["down_conv"], stride, 0),
                             blk["down_bn"])
    pre = out + residual
    return torch.relu(pre), pre


def _layers(params: Dict, x: torch.Tensor):
    """The layer table's ``(name, value)`` pairs in the order the forward
    computes them; a consumer that stops early computes nothing past."""
    x = _conv(x.float(), params["conv1"], 2)
    yield "conv1", x
    x = _bn_apply(x, params["bn1"])
    yield "bn1", x
    x = torch.relu(x)
    yield "relu", x
    # 3x3 max pool, stride 2, padding 1 (torchvision's maxpool).
    x = F.max_pool2d(x, 3, 2, 1)
    yield "maxpool", x
    for i, (blocks, _, stride) in enumerate(STAGES, start=1):
        layer = params[f"layer{i}"]
        for b in range(blocks):
            x, pre = _basic_block(x, layer[b], stride if b == 0 else 1)
            if i == 4:
                if b == blocks - 1:
                    yield "layer4_2", pre
                yield f"layer4_{b}_relu", x
        yield f"layer{i}", x
    x = x.mean(dim=(2, 3), keepdim=True)   # adaptive average pool
    yield "avgpool", x
    x = x.reshape(x.shape[0], -1)
    yield "avgpool_512", x
    yield "fc", x @ params["fc"]["weight"].t() + params["fc"]["bias"]


def _check_request(request: Sequence[str]) -> set:
    want = set(request)
    unknown = want - set(LAYER_NAMES)
    if unknown:
        raise KeyError(f"unknown feature names requested: "
                       f"{sorted(unknown)}")
    return want


def _collect(params: Dict, x: torch.Tensor, want: set
             ) -> Dict[str, torch.Tensor]:
    """The requested taps, the forward stopped at the deepest of them."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in _layers(params, x):
        if name in want:
            out[name] = value
            if len(out) == len(want):
                break
    return out


@torch.no_grad()
def resnet34_features(params: Dict, x: torch.Tensor,
                      request: Sequence[str] = ("layer4_2", "avgpool_512",
                                                "fc")
                      ) -> Dict[str, torch.Tensor]:
    """The forward pass, collecting the requested intermediates.

    ``params``: :func:`params_from_torch_state`'s, on ``x``'s device.
    ``x``: images ``(B, 3, H, W)`` float32, NCHW (e.g. ``(B, 3, 227,
    227)`` after Scale(227) + CenterCrop(227) + Normalize(.5, .5),
    utils/package_data.py:171-178). ``request``: names of the layer table
    (:data:`LAYER_NAMES`); an unknown one raises ``KeyError``. Returns
    ``{name: tensor}``, spatial features NCHW, computed in float32; the
    forward stops at the deepest name requested."""
    want = _check_request(request)
    with float32_precision():
        return _collect(params, x, want)


# -------------------------------------------------------- folded forward

def fold_batch_norms(params: Dict, device: Union[str, torch.device]
                     ) -> Dict:
    """:func:`params_from_torch_state`'s parameters with each batch norm
    folded into the convolution before it, on ``device``, in float32:
    ``{"weight": W * scale, "bias": shift}`` (the scale per output
    channel, the bias ``(C,)``) for ``conv1`` and each block's ``conv1``,
    ``conv2`` and ``down`` (the downsample); ``fc`` as it is."""
    def fold(weight, bn):
        scale = bn["scale"].to(device).reshape(-1, 1, 1, 1)
        return {"weight": weight.to(device) * scale,
                "bias": bn["shift"].to(device).reshape(-1).contiguous()}

    folded: Dict = {"conv1": fold(params["conv1"], params["bn1"]),
                    "fc": params_to(params["fc"], device)}
    for i in range(1, len(STAGES) + 1):
        layer = []
        for blk in params[f"layer{i}"]:
            f = {"conv1": fold(blk["conv1"], blk["bn1"]),
                 "conv2": fold(blk["conv2"], blk["bn2"])}
            if "down_conv" in blk:
                f["down"] = fold(blk["down_conv"], blk["down_bn"])
            layer.append(f)
        folded[f"layer{i}"] = layer
    return folded


def folded_forward(params: Dict, x: torch.Tensor, want: Iterable[str]
                   ) -> Dict[str, torch.Tensor]:
    """The requested taps (names of :data:`LAYER_NAMES` but
    :data:`PLAIN_TAPS`) on :func:`fold_batch_norms`' parameters, the
    forward stopped at the deepest of them, as :func:`_collect` does on
    the plain ones: each convolution without a bias, then one pass of
    ``ops/cuda_tower.py`` (a kernel on a card, its plain version
    elsewhere): conv1's output to the max pool in one, each block
    convolution's bias, shortcut and ReLU in place in one. ``bn1`` and
    ``relu`` are conv1's pass without and with the ReLU; ``layer4_2`` is
    the last block's pass without its ReLU. A tap asked for beside deeper
    ones is computed out of place, so the passes a single tap needs are
    the only ones it runs."""
    want = set(want)
    unknown = (want - set(LAYER_NAMES)) | (want & set(PLAIN_TAPS))
    if unknown:
        raise KeyError(f"the folded forward has no taps {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}

    def done(name: str, value: torch.Tensor) -> bool:
        if name in want:
            out[name] = value
        return len(out) == len(want)

    y = _conv(x, params["conv1"]["weight"], 2)
    bias = params["conv1"]["bias"]
    for name, relu in (("bn1", False), ("relu", True)):
        if name in want:
            z = y if len(out) + 1 == len(want) else y.clone()
            if done(name, cuda_tower.block_epilogue(z, bias, relu=relu)):
                return out
    x = cuda_tower.stem(y, bias)
    if done("maxpool", x):
        return out
    for i, (blocks, _, stride) in enumerate(STAGES, start=1):
        for b, blk in enumerate(params[f"layer{i}"]):
            s = stride if b == 0 else 1
            h = cuda_tower.block_epilogue(
                _conv(x, blk["conv1"]["weight"], s), blk["conv1"]["bias"])
            shortcut, shortcut_bias = x, None
            if "down" in blk:
                shortcut = _conv(x, blk["down"]["weight"], s, 0)
                shortcut_bias = blk["down"]["bias"]
            pre = i == 4 and b == blocks - 1 and "layer4_2" in want
            x = cuda_tower.block_epilogue(
                _conv(h, blk["conv2"]["weight"], 1), blk["conv2"]["bias"],
                shortcut, shortcut_bias, relu=not pre)
            if pre:
                if done("layer4_2", x):
                    return out
                x = torch.relu(x)
            if i == 4 and done(f"layer4_{b}_relu", x):
                return out
        if done(f"layer{i}", x):
            return out
    x = x.mean(dim=(2, 3), keepdim=True)   # adaptive average pool
    if done("avgpool", x):
        return out
    x = x.reshape(x.shape[0], -1)
    if done("avgpool_512", x):
        return out
    done("fc", x @ params["fc"]["weight"].t() + params["fc"]["bias"])
    return out


class PixelTower:
    """ResNet-34 in front of a game: uint8 pixels ``(B, 3, S, S)`` (crops
    already scaled and centre-cropped) normalised on the device and run
    to one tap of the layer table, nothing past it. The network is fully
    convolutional up to its pooling, so the crop size is the request's.

    The route follows the tap: from ``bn1`` on, the tower keeps only
    :func:`fold_batch_norms`' parameters, folded once when it is built,
    and runs :func:`folded_forward` (on a card, each convolution followed
    by one kernel, whose library is built here); the ``conv1`` tap keeps
    the parameters as given and the plain forward.

    Each request shape ``(B, S, S)`` has a static uint8 input buffer and a
    body that normalises it and runs the forward (``utils/cuda_graph.py:
    StagedGraphs``, one :class:`Captured` a shape): on a
    card (``graph`` None; True or False to choose) it runs eagerly once,
    then as one captured CUDA graph, TF32 turned off once, while the body
    is captured; elsewhere the same body runs on every call. A replay's
    outputs are the graph's static tensors, overwritten by the next
    replay of that shape. The class counts the process's forward runs,
    the images and the runs on the folded route (``fused_runs``), each
    advanced at each replay through ``Captured``'s ``counters`` as the
    kernels' ``launches`` are, and the runs that were graph replays."""

    runs = 0
    images = 0
    fused_runs = 0
    replays = 0

    def __init__(self, params: Dict, tap: str,
                 device: Union[str, torch.device],
                 graph: Optional[bool] = None):
        self.device = torch.device(device)
        self.tap = tap
        self.want = _check_request((tap,))
        self.fused = tap not in PLAIN_TAPS
        if self.fused:
            self.params = fold_batch_norms(params, self.device)
            if self.device.type == "cuda":
                cuda_tower.library()
        else:
            self.params = params_to(params, self.device)
        capture = (self.device.type == "cuda") if graph is None \
            else bool(graph)
        self._runs = StagedGraphs(
            lambda buf: lambda: self._body(buf), self.device, capture,
            counters=((PixelTower, "runs"), (PixelTower, "images"),
                      (PixelTower, "fused_runs"))
            + tuple((f, "launches") for f in cuda_tower.COUNTED),
            replays=(PixelTower, "replays"))

    @staticmethod
    def check(x: np.ndarray) -> None:
        """``ValueError`` unless ``x`` is uint8 ``(B, 3, S, S)``."""
        if x.dtype != np.uint8 or x.ndim != 4 or not x.shape[0] \
                or x.shape[1] != 3 or not x.shape[2] \
                or x.shape[2] != x.shape[3]:
            raise ValueError(
                "a Predictor with ResNet-34's tower serves uint8 pixels "
                "(B, 3, S, S), square crops scaled and centre-cropped (227 "
                f"x 227 as the reference makes them); got {x.dtype} "
                f"{tuple(x.shape)}")

    def stage(self, pixels: np.ndarray) -> tuple:
        """Copy a batch of uint8 pixels ``(B, 3, S, S)`` into its shape's
        input buffer on the device; returns the key :meth:`__call__`
        takes."""
        return self._runs.stage(pixels)

    @torch.no_grad()
    def _body(self, buf: torch.Tensor) -> torch.Tensor:
        PixelTower.runs += 1
        PixelTower.images += buf.shape[0]
        PixelTower.fused_runs += int(self.fused)
        forward = folded_forward if self.fused else _collect
        with float32_precision():
            return forward(self.params, normalize_pixels(buf),
                           self.want)[self.tap]

    def __call__(self, key: tuple) -> torch.Tensor:
        """The tap of the batch last staged under ``key``."""
        return self._runs.run(key)
