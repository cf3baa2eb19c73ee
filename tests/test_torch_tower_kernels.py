"""The served ResNet-34 tower's kernels (``ops/cuda_tower.py``,
``csrc/tower_epilogue.cu``) against their plain PyTorch versions, and the
captured tower (``models/resnet.py:PixelTower``) on its folded route, on
the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and
skips without one. This file imports no JAX, so on a machine without it
run it past the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_tower_kernels.py

The kernels are held at every shape the tower launches at 227x227 and
batch 100 (the benchmark's requests) and at 35x35 and batch 1:
normalisation and the stem bit for bit, the block epilogue within one
unit in the last place (it adds in the plain version's order, so it
reads 0).
"""

import pytest
import torch
import torch.nn.functional as F

from gamebench.entries.serve_pixels import make_pixels, tower_state
from multimodalgame_tpu_torch.models.resnet import (STAGES, PixelTower,
                                                    fold_batch_norms,
                                                    folded_forward,
                                                    params_from_torch_state,
                                                    resnet34_features)
from multimodalgame_tpu_torch.ops import cuda_tower

pytestmark = pytest.mark.cuda

# (size, batch) of the checked launches.
SHAPES = [(227, 100), (35, 1)]
# The served forward against the network computed in float64 (on the
# CPU, from the same parameters), as the CPU tests hold it.
FOLD_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def planes(size: int):
    """``(channels, side)`` of conv1's output and of each stage's planes
    at a ``size`` crop: the shapes the tower's epilogues run at."""
    side = (size - 1) // 2 + 1              # conv1: 7x7, stride 2, pad 3
    out = [(64, side)]
    side = (side - 1) // 2 + 1              # the max pool
    for _, channels, stride in STAGES:
        side = (side - 1) // stride + 1     # 3x3, pad 1
        out.append((channels, side))
    return out


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between ``a`` and ``b`` in units in the last
    place (float32 bit patterns on one ordered integer line)."""
    def line(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((line(a) - line(b)).abs().max())


@pytest.mark.parametrize("size,batch", SHAPES)
def test_normalize_is_the_plain_version_bit_for_bit(cuda, size, batch):
    cfg = {"num_classes": 6, "image_shape": [3, size, size],
           "dev_per_class": -(-batch // 6)}
    px = make_pixels(cfg, "dev", 7, cuda)[:batch].contiguous()
    px[0, 0, 0, :8] = torch.tensor([0, 1, 3, 127, 128, 200, 254, 255],
                                   dtype=torch.uint8)
    before = cuda_tower.normalize_pixels.launches
    got = cuda_tower.normalize_pixels(px)
    assert cuda_tower.normalize_pixels.launches == before + 1
    want = cuda_tower.normalize_pixels_reference(px)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    every = torch.arange(256, dtype=torch.uint8, device=cuda)
    assert torch.equal(cuda_tower.normalize_pixels(every),
                       cuda_tower.normalize_pixels_reference(every))


@pytest.mark.parametrize("size,batch", SHAPES)
def test_stem_is_the_plain_version_bit_for_bit(cuda, size, batch):
    channels, side = planes(size)[0]
    gen = torch.Generator(device=cuda).manual_seed(size)
    y = torch.randn((batch, channels, side, side), generator=gen,
                    device=cuda)
    y[0, :2] = torch.round(y[0, :2] * 2) / 2        # ties
    bias = torch.randn(channels, generator=gen, device=cuda)
    got = cuda_tower.stem(y, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_tower.stem_reference(y, bias))
    assert torch.equal(got, F.max_pool2d(
        torch.relu(y + bias.view(1, -1, 1, 1)), 3, 2, 1))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shortcut", ["none", "input", "downsample"])
@pytest.mark.parametrize("size,batch", SHAPES)
def test_block_epilogue_is_the_plain_version(cuda, size, batch, shortcut,
                                             relu):
    gen = torch.Generator(device=cuda).manual_seed(size + batch)
    for channels, side in planes(size):
        shape = (batch, channels, side, side)
        y = torch.randn(shape, generator=gen, device=cuda)
        bias, rbias = (torch.randn(channels, generator=gen, device=cuda)
                       for _ in range(2))
        r = (None if shortcut == "none"
             else torch.randn(shape, generator=gen, device=cuda))
        rb = rbias if shortcut == "downsample" else None
        want = cuda_tower.block_epilogue_reference(y.clone(), bias, r, rb,
                                                   relu)
        got = y.clone()
        assert cuda_tower.block_epilogue(got, bias, r, rb, relu) is got
        torch.cuda.synchronize()
        assert ulps(got, want) <= 1, shape


def test_refusals(cuda):
    y = torch.zeros((1, 64, 5, 5), device=cuda)
    b = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        cuda_tower.block_epilogue(y.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_tower.block_epilogue(y.transpose(2, 3), b)
    with pytest.raises(ValueError, match="expected 64"):
        cuda_tower.stem(y, b[:32])
    with pytest.raises(ValueError, match="residual has shape"):
        cuda_tower.block_epilogue(y, b, torch.zeros((1, 64, 5, 4),
                                                    device=cuda))
    with pytest.raises(ValueError, match="4-byte"):
        cuda_tower.normalize_pixels(
            torch.zeros(9, dtype=torch.uint8, device=cuda)[1:])


def _cpu_float64(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double().cpu()
    if isinstance(tree, dict):
        return {k: _cpu_float64(v) for k, v in tree.items()}
    return [_cpu_float64(v) for v in tree]


@pytest.fixture(scope="module")
def tower():
    """The benchmark cell's seeded, calibrated tower and 100 of its
    227x227 crops, made on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = {"num_classes": 30, "image_shape": [3, 227, 227],
           "dev_per_class": 4}
    sd = tower_state(cfg, 11, "cuda")
    px = make_pixels(cfg, "dev", 11, "cuda")[:100].contiguous()
    return params_from_torch_state(sd, "cuda"), px


def test_captured_tower_matches_the_plain_forward(tower):
    params, px = tower
    # The first four images in float64 on the CPU.
    exact = fold_batch_norms(_cpu_float64(params), "cpu")
    x64 = cuda_tower.normalize_pixels(px[:4]).double().cpu()
    served = PixelTower(params, "avgpool_512", "cuda")
    runs, fused = PixelTower.runs, PixelTower.fused_runs
    launches = [f.launches for f in cuda_tower.COUNTED]
    key = served.stage(px.cpu().numpy())
    eager = served(key).clone()          # the warm-up, eager
    replayed = served(key).clone()       # captured, replayed
    again = served(key)
    torch.cuda.synchronize()
    assert torch.equal(replayed, again)
    assert (PixelTower.runs - runs, PixelTower.fused_runs - fused) == (3, 3)
    # One normalisation, one stem and 32 block epilogues a run.
    assert [f.launches - n for f, n in zip(cuda_tower.COUNTED,
                                           launches)] == [3, 3, 96]
    plain = resnet34_features(params, cuda_tower.normalize_pixels(px),
                              ("avgpool_512",))["avgpool_512"]
    want = folded_forward(exact, x64, ("avgpool_512",))["avgpool_512"]
    for got in (replayed, eager, plain):
        gap = float((got[:4].double().cpu() - want).norm() / want.norm())
        assert gap < FOLD_TOL
    gap = float((replayed - plain).norm() / plain.norm())
    assert gap < 2 * FOLD_TOL


def test_a_replay_runs_no_pytorch_elementwise_or_pool_kernel(tower):
    params, px = tower
    served = PixelTower(params, "avgpool_512", "cuda")
    key = served.stage(px.cpu().numpy())
    served(key)
    served(key)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        served(key)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names, "the profiler saw no device operation"
    assert not [n for n in names if "elementwise_kernel" in n
                or "max_pool" in n]
    count = {k: sum(k in n for n in names)
             for k in ("tower_normalize", "tower_stem", "tower_epilogue")}
    assert count == {"tower_normalize": 1, "tower_stem": 1,
                     "tower_epilogue": 32}
