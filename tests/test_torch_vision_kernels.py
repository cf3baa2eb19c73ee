"""The vision tower's rotary kernel (``ops/cuda_vision.py``,
``csrc/vision_rotary.cu``) against its plain PyTorch version, and the
captured tower (``models/qwen_vision.py:VisionTower``) that launches it,
on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and
skips without one. This file imports no JAX, so on a machine without it
run it past the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_vision_kernels.py

The kernel is held at the photo cell's shapes (batch 100 of 364 x 504
photos: 936 tokens, 16 heads of 80), in both dtypes and both layouts,
bit for bit: it rounds as PyTorch's passes round on the card (the
products and sums of ``rotate_halves``, one fused as PyTorch's
``addcmul_`` fuses it), so the captured tower's output is the plain
route's too.
"""

from unittest import mock

import pytest
import torch

from gamebench.entries.serve_photos import tower_state
from gamebench.entries.serve_pixels import make_pixels
from gamebench.reference import qwen_vision as ref
from multimodalgame_tpu_torch.models.qwen_vision import (QWEN2_5_VL_7B,
                                                         Layout, VisionTower,
                                                         params_from_state)
from multimodalgame_tpu_torch.ops import cuda_vision

pytestmark = pytest.mark.cuda

BATCH, HEIGHT, WIDTH = 100, 364, 504
VCFG = {**QWEN2_5_VL_7B, "initializer_range": 0.02}
# The photo cell's limits of `correct` (gamebench/limits/).
FEATURE_GAP, TOKEN_GAP = 0.007, 0.06


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_the_plain_version(cuda, dtype, full):
    lay = Layout(VCFG, HEIGHT, WIDTH, cuda)
    C, heads = VCFG["hidden_size"], VCFG["num_heads"]
    gen = torch.Generator(device=cuda).manual_seed(26)
    qkv = torch.randn((BATCH, lay.tokens, 3 * C), generator=gen,
                      device=cuda).to(getattr(torch, dtype))
    dest = lay.full_dest if full else lay.window_dest
    before = cuda_vision.rotary_qkv.launches
    got = cuda_vision.rotary_qkv(qkv, lay.cos, lay.sin, dest, heads)
    torch.cuda.synchronize()
    assert cuda_vision.rotary_qkv.launches == before + 1
    want = cuda_vision.rotary_qkv_reference(qkv, lay.cos, lay.sin, dest,
                                            heads)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (BATCH * lay.tokens, heads, C // heads)
        assert g.dtype == qkv.dtype and torch.equal(g, w)


def test_refusals(cuda):
    lay = Layout(VCFG, 56, 140, cuda)
    qkv = torch.zeros((1, lay.tokens, 3 * 1280), dtype=torch.bfloat16,
                      device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        cuda_vision.rotary_qkv(qkv.half(), lay.cos, lay.sin,
                               lay.window_dest, 16)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_vision.rotary_qkv(qkv, lay.cos.cpu(), lay.sin, lay.window_dest,
                               16)
    shifted = torch.zeros(qkv.numel() + 1, dtype=qkv.dtype,
                          device=cuda)[1:].view(qkv.shape)
    with pytest.raises(ValueError, match="aligned"):
        cuda_vision.rotary_qkv(shifted, lay.cos, lay.sin, lay.window_dest,
                               16)


@pytest.fixture(scope="module")
def served():
    """The photo cell's seeded tower, 100 of its photos, and three runs
    of the captured tower on them: the eager warm-up, the capture and
    first replay, and a second replay, with the counters' advance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sd = tower_state(VCFG, 11, "cuda")
    px = make_pixels({"num_classes": 30, "image_shape": [3, HEIGHT, WIDTH],
                      "dev_per_class": 4}, "dev", 11, "cuda")[:BATCH]
    tower = VisionTower(params_from_state(sd, VCFG, "cuda"), VCFG, "cuda")
    names = ("runs", "rotary_launches", "window_attention_launches",
             "full_attention_launches")
    before = [getattr(VisionTower, k) for k in names] \
        + [cuda_vision.rotary_qkv.launches]
    key = tower.stage(px.cpu().numpy())
    runs = [tuple(t.clone() for t in tower.outputs(key)) for _ in range(3)]
    torch.cuda.synchronize()
    after = [getattr(VisionTower, k) for k in names] \
        + [cuda_vision.rotary_qkv.launches]
    counts = dict(zip(names + ("kernel",),
                      (a - b for a, b in zip(after, before))))
    return sd, px, tower, key, runs, counts


def test_captured_tower_holds_the_cells_limits(served):
    """The captured tower's replays against the reference tower within the
    photo cell's limits, and the same outputs as the tower with the plain
    rotation in the kernel's place."""
    sd, px, tower, key, runs, counts = served
    # 32 rotations a run, each one kernel launch; 4 window sizes in 28
    # blocks and 4 full blocks.
    assert counts == {"runs": 3, "rotary_launches": 96,
                      "window_attention_launches": 336,
                      "full_attention_launches": 12, "kernel": 96}
    (eager_tokens, eager_feats), _, (tokens, feats) = runs
    assert torch.equal(tokens, runs[1][0])
    want = ref.forward(ref.state(sd, "cuda"), VCFG, px[:4])
    for t, f in ((tokens, feats), (eager_tokens, eager_feats)):
        token_gap = float(ref.relative_gaps(
            t[:4].flatten(0, 1), want["tokens"].flatten(0, 1)).max())
        feature_gap = float(ref.relative_gaps(f[:4],
                                              want["features"]).max())
        assert token_gap < TOKEN_GAP and feature_gap < FEATURE_GAP
    plain = VisionTower(tower.params, VCFG, "cuda", graph=False)
    with mock.patch.object(cuda_vision, "rotary_qkv",
                           cuda_vision.rotary_qkv_reference):
        plain_tokens, plain_feats = plain.forward(
            tower._runs[key][0], plain.layout(HEIGHT, WIDTH))
    torch.cuda.synchronize()
    assert torch.equal(tokens, plain_tokens)
    assert torch.equal(feats, plain_feats)


def test_a_replay_runs_one_rotary_kernel_a_block(served):
    _, _, tower, key, _, _ = served
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tower.outputs(key)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names, "the profiler saw no device operation"
    assert sum("vit_rotary_qkv" in n for n in names) == 32
    assert not [n for n in names if "addcmul" in n.lower()]
