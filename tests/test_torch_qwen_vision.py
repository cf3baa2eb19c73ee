"""Serving photos through Qwen2.5-VL's vision tower: the port's
``models/qwen_vision.py:VisionTower`` and ``Predictor(..., tower=...)``
against the benchmark's plain reference (``gamebench/reference/
qwen_vision.py`` and ``reference/game.py``), the reference against
``transformers``' own forward where that imports, on the CPU at small
widths and at the published widths with two blocks."""

import numpy as np
import pytest
import torch

from gamebench import program, run, weights
from gamebench.entries.serve_pixels import make_pixels
from gamebench.entries.serve_photos import tower_state
from gamebench.reference import qwen_vision as ref
from gamebench.reference.game import eval_answers
from gamebench.trace import Trace, Tracer, traced
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.models import qwen_vision as qv
from multimodalgame_tpu_torch.models.qwen_vision import (ARCH, QWEN2_5_VL_7B,
                                                         Layout, VisionTower,
                                                         params_from_state)
from multimodalgame_tpu_torch.ops import cuda_vision
from multimodalgame_tpu_torch.serve import Predictor

# Hidden 64, 4 heads, 8 blocks with full attention at 3 and 7.
SMALL = {**QWEN2_5_VL_7B, "depth": 8, "hidden_size": 64, "num_heads": 4,
         "intermediate_size": 96, "fullatt_block_indexes": [3, 7],
         "out_hidden_size": 48, "initializer_range": 0.02}
# 140 x 84: 10 x 6 patches, merge units 5 x 3 in two windows (12 and 3);
# 224 x 224: four windows of 16 merge units.
IMAGES = {"uneven": (84, 140), "even": (224, 224)}
# The same forward in float32 on both sides: they differ by the order of
# float32 rounding (the embedding's two temporal kernels summed first,
# gate and up as one product, PyTorch's attention), ~1e-6 here.
F32_TOL = 1e-5
# bfloat16 weights and activations over 8 blocks read ~8e-3 on the tokens
# and ~5e-3 on the pooled features; the float8 reference reads 3e-2 and
# more on both.
BF16_TOL = 1.5e-2
# The answer's log-probabilities on features that the reference game and
# the port's game read alike: float32 rounding of the game alone.
LOGP_TOL = 1e-4


def seeded(vcfg: dict, seed: int, biases: bool = True) -> dict:
    """A ``visual.*`` state dict, bfloat16: the cell's seeded draw, with
    seeded biases and RMSNorm weights away from 0 and 1 where ``biases``
    (so that every parameter's place in the layout shows)."""
    sd = tower_state(vcfg, seed, "cpu")
    if biases:
        gen = torch.Generator().manual_seed(seed + 1)
        for k, v in sd.items():
            if k.endswith(".bias"):
                sd[k] = (0.02 * torch.randn(v.shape, generator=gen)).to(
                    torch.bfloat16)
            elif v.dim() == 1:
                sd[k] = (1 + 0.1 * torch.randn(v.shape, generator=gen)).to(
                    torch.bfloat16)
    return sd


def photos(h: int, w: int, n: int, seed: int = 5) -> torch.Tensor:
    return make_pixels({"num_classes": 3, "image_shape": [3, h, w],
                        "dev_per_class": (n + 2) // 3}, "dev", seed,
                       "cpu")[:n]


def gaps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-image relative gap."""
    return float(ref.relative_gaps(got.float().flatten(1),
                                   want.flatten(1)).max())


@pytest.fixture(scope="module")
def sd():
    return seeded(SMALL, 3)


@pytest.mark.parametrize("image", sorted(IMAGES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_the_reference(sd, image, dtype):
    px = photos(*IMAGES[image], 3)
    want = ref.forward(ref.state(sd), SMALL, px)
    tower = VisionTower(params_from_state(sd, SMALL, "cpu",
                                          getattr(torch, dtype)),
                        SMALL, "cpu")
    tokens, feats = tower.forward(px)
    assert tokens.shape == want["tokens"].shape
    assert feats.dtype == torch.float32 and feats.shape == (3, 48)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert gaps(tokens, want["tokens"]) < tol
    assert gaps(feats, want["features"]) < tol
    if dtype == "bfloat16":
        fp8 = ref.forward(ref.state(sd), SMALL, px, prec="fp8")
        assert gaps(fp8["tokens"], want["tokens"]) > tol
        assert gaps(fp8["features"], want["features"]) > tol


def test_window_layout_at_364_by_504():
    """20 windows at 364 x 504: 12 of 64 tokens, 3 of 32, 4 of 16, 1 of 8,
    grouped by size; the layout's order holds each merge unit once, and
    its inverse undoes it."""
    cfg = QWEN2_5_VL_7B
    wins = qv.windows(cfg, 26, 36)
    assert sorted((len(w) * 4 for w in wins), reverse=True) == \
        [64] * 12 + [32] * 3 + [16] * 4 + [8]
    order, cu = ref.window_index(cfg, 26, 36)
    assert order.tolist() == [u for w in wins for u in w]
    assert np.diff(cu).tolist() == [len(w) * 4 for w in wins]
    lay = Layout(cfg, 364, 504, "cpu")
    assert lay.groups == [(0, 12, 64), (768, 3, 32), (864, 4, 16),
                          (928, 1, 8)]
    assert sorted(lay.order.tolist()) == list(range(234))
    assert torch.equal(lay.order[lay.inverse], torch.arange(234))
    # The rotary table is the reference's, in the layout's order.
    angles = ref.rotary(cfg, 26, 36).reshape(234, 4, -1)[lay.order]
    assert torch.equal(lay.cos[:, 0, 0, :40].reshape(234, 4, -1),
                       angles.cos())


def rotate_then_cut(qkv, layout, heads, full):
    """The tower's rotation and windows as they were before the rotary
    kernel: the float32 rotation of q and k by PyTorch's passes, then
    each window group of q, k and v cut out and copied, or the whole
    images in a full block; the attention inputs ``(B * n, heads, s,
    d)``, a list per group (one for a full block)."""
    B, N, width = qkv.shape
    d = width // 3 // heads
    qkv = qkv.reshape(B, N, 3, heads, d)
    qk, cos, sin = qkv[:, :, :2], layout.cos, layout.sin
    half = d // 2
    out = qk * cos
    out[..., :half].addcmul_(qk[..., half:], sin[..., :half], value=-1)
    out[..., half:].addcmul_(qk[..., :half], sin[..., half:])
    q, k = out.to(qk.dtype).unbind(2)
    v = qkv[:, :, 2]
    if full:
        return [tuple(t.transpose(1, 2) for t in (q, k, v))]
    return [tuple(t[:, start:start + n * s].reshape(B * n, s, heads, d)
                  .transpose(1, 2) for t in (q, k, v))
            for start, n, s in layout.groups]


def the_kernels_views(q, k, v, layout, B, full):
    """The attention inputs the tower takes from :func:`rotary_qkv`'s q, k
    and v, as :func:`rotate_then_cut` lists them."""
    N = layout.tokens
    if full:
        return [tuple(t.view(B, N, *t.shape[1:]).transpose(1, 2)
                      for t in (q, k, v))]
    return [tuple(t[B * start:B * (start + n * s)].view(
        B * n, s, *t.shape[1:]).transpose(1, 2) for t in (q, k, v))
        for start, n, s in layout.groups]


# (H, W): 4 window groups at the photo cell's shape; 2 at a small one.
ROTARY_IMAGES = {(364, 504): 4, (84, 140): 2}


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", sorted(ROTARY_IMAGES))
def test_plain_rotary_is_rotate_then_cut(hw, dtype, full):
    """The rotary kernel's plain version, and the wrapper on the CPU, at
    the published widths: q, k and v bit for bit what the rotation and the
    windows' cuts gave, seen through the tower's views."""
    cfg = QWEN2_5_VL_7B
    lay = Layout(cfg, *hw, "cpu")
    assert len(lay.groups) == ROTARY_IMAGES[hw]
    C, heads, B = cfg["hidden_size"], cfg["num_heads"], 2
    qkv = torch.randn((B, lay.tokens, 3 * C),
                      generator=torch.Generator().manual_seed(26)).to(
        getattr(torch, dtype))
    dest = lay.full_dest if full else lay.window_dest
    want = rotate_then_cut(qkv, lay, heads, full)
    plain = cuda_vision.rotary_qkv_reference(qkv, lay.cos, lay.sin, dest,
                                             heads)
    got = cuda_vision.rotary_qkv(qkv, lay.cos, lay.sin, dest, heads)
    for outs in (plain, got):
        assert all(t.shape == (B * lay.tokens, heads, C // heads)
                   and t.dtype == qkv.dtype for t in outs)
        views = the_kernels_views(*outs, lay, B, full)
        assert len(views) == len(want)
        for g, w in zip(views, want):
            for a, b in zip(g, w):
                assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("hw", sorted(ROTARY_IMAGES))
def test_destination_maps_are_permutations(hw):
    """Each map puts the ``B * N`` tokens of a batch on ``B * N`` distinct
    rows; the windowed map lays each group's windows out as ``(B, n,
    s)``, one block after the last."""
    lay = Layout(QWEN2_5_VL_7B, *hw, "cpu")
    N = lay.tokens
    for B in (1, 3):
        for dest in (lay.window_dest, lay.full_dest):
            assert dest.shape == (N, 2) and dest.dtype == torch.int32
            rows = cuda_vision.destination_rows(dest, B)
            assert torch.equal(rows.flatten().sort().values,
                               torch.arange(B * N))
        assert torch.equal(cuda_vision.destination_rows(lay.full_dest, B),
                           torch.arange(B * N).view(B, N))
        rows = cuda_vision.destination_rows(lay.window_dest, B)
        for start, n, s in lay.groups:
            block = torch.arange(B * start, B * (start + n * s))
            assert torch.equal(rows[:, start:start + n * s].flatten(),
                               block)


@pytest.mark.parametrize("case", ["dtype", "device", "qkv_shape",
                                  "table_shape", "dest_dtype",
                                  "not_contiguous"])
def test_rotary_refusals(case):
    lay = Layout(SMALL, 84, 140, "cpu")
    heads, N = SMALL["num_heads"], lay.tokens
    qkv = torch.zeros((2, N, 3 * SMALL["hidden_size"]))
    cos, sin, dest = lay.cos, lay.sin, lay.window_dest
    match = {"dtype": "dtype", "device": "on meta", "qkv_shape": "shape",
             "table_shape": "shape", "dest_dtype": "dtype",
             "not_contiguous": "not contiguous"}[case]
    if case == "dtype":
        qkv = qkv.half()
    elif case == "device":
        sin = torch.empty(sin.shape, device="meta")
    elif case == "qkv_shape":
        qkv = qkv[:, :, :-heads]
    elif case == "table_shape":
        cos = cos[:-1]
    elif case == "dest_dtype":
        dest = dest.long()
    else:
        qkv = qkv.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match=match):
        cuda_vision.rotary_qkv(qkv, cos, sin, dest, heads)


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_reference_matches_transformers(sd, image):
    """The reference against ``Qwen2_5_VisionTransformerPretrainedModel``
    with eager attention, on the same weights (float32) and the
    processor's patches: the published equations."""
    modeling = pytest.importorskip(
        "transformers.models.qwen2_5_vl.modeling_qwen2_5_vl")
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import (
        Qwen2_5_VLVisionConfig)
    config = Qwen2_5_VLVisionConfig(**{
        k: SMALL[k] for k in ("depth", "hidden_size", "num_heads",
                              "intermediate_size", "hidden_act",
                              "in_channels", "patch_size",
                              "temporal_patch_size", "spatial_merge_size",
                              "window_size", "fullatt_block_indexes",
                              "out_hidden_size")})
    config._attn_implementation = "eager"
    model = modeling.Qwen2_5_VisionTransformerPretrainedModel(config)
    state = ref.state(sd)
    model.load_state_dict(state)
    model.eval()
    h, w = IMAGES[image]
    px = photos(h, w, 2)
    gh, gw = ref.grid(SMALL, h, w)
    with torch.no_grad():
        got = model(ref.patches(SMALL, px),
                    torch.tensor([[1, gh, gw]] * 2)).reshape(2, -1, 48)
    want = ref.forward(state, SMALL, px)["tokens"]
    assert gaps(got, want) < F32_TOL


def test_published_widths_two_blocks():
    """The tower at the published widths with two blocks, a windowed one
    then a full one (standing for blocks 6 and 7 of the published depth),
    and the merger to 3,584, on one 56 x 140 photo (two windows, of 32 and
    8 tokens)."""
    vcfg = {**QWEN2_5_VL_7B, "depth": 2, "fullatt_block_indexes": [1],
            "initializer_range": 0.02}
    sd = seeded(vcfg, 7)
    px = photos(56, 140, 1)
    assert [(n, s) for _, n, s in Layout(vcfg, 56, 140, "cpu").groups] \
        == [(1, 32), (1, 8)]
    want = ref.forward(ref.state(sd), vcfg, px)
    tokens, feats = VisionTower(params_from_state(sd, vcfg, "cpu"), vcfg,
                                "cpu").forward(px)
    assert tokens.shape == (1, 10, 3584)
    assert gaps(tokens, want["tokens"]) < BF16_TOL
    assert gaps(feats, want["features"]) < BF16_TOL


@pytest.fixture(scope="module")
def game():
    """The photo cell's configuration at a small game that reads the small
    tower's 48 pooled features, its weights, and its descriptions."""
    config = run.load_config("qwen2_5_vl_vit_adaptive")
    small = dict(img_feat_dim=48, img_h_dim=12, sender_out_dim=8,
                 rec_w_dim=8, rec_hidden=12, wv_dim=16, baseline_hid_dim=12,
                 max_exchange=3, num_classes=6, feature_shape=[48])
    for key, value in small.items():
        config["flags" if key in config["flags"] else "data"][key] = value
        config["cfg"][key] = value
    cfg = config["cfg"]
    made = weights.make_weights(cfg, 11, "cpu")
    desc = torch.randn(cfg["num_classes"], cfg["wv_dim"],
                       generator=torch.Generator().manual_seed(12))
    return config, made, desc


def predictor(game, sd=None, vcfg=SMALL, **kw):
    config, made, desc = game
    flags = program.make_flags(config, {})
    tower = None if sd is None else {"arch": ARCH, "config": vcfg,
                                     "state": sd}
    return Predictor(GameConfig.from_flags(flags),
                     program.agents(flags, made, "cpu"),
                     program.description_pack(desc), device="cpu",
                     tower=tower, **kw)


def test_predictor_serves_photos(game, sd):
    """Non-square photos through ``predict``: the answers against the
    reference tower's features through the reference game (bits equal,
    log-probabilities within float32's rounding of the game), and the
    photo path bit-equal to the feature path fed the tower's own
    features."""
    config, made, desc = game
    px = photos(84, 140, 6).numpy()
    pred = predictor(game, sd)
    out = pred.predict(px)
    feats = pred.tower_outputs(px)[1]
    want = eval_answers(made, config["cfg"], feats, desc)
    assert out["n_steps"] == want["n_steps"]
    for k in ("sender_messages", "receiver_messages",
              "conversation_length"):
        np.testing.assert_array_equal(out[k], want[k].numpy(), err_msg=k)
    np.testing.assert_allclose(out["log_probs"], want["log_probs"].numpy(),
                               rtol=0, atol=LOGP_TOL)
    assert gaps(feats, ref.forward(ref.state(sd), SMALL,
                                   torch.as_tensor(px))["features"]) \
        < BF16_TOL
    plain = predictor(game).predict(feats.numpy())
    for k in out:
        np.testing.assert_array_equal(out[k], plain[k], err_msg=k)


@pytest.mark.parametrize("case", ["float", "height", "width", "width_dim",
                                  "resnet_square"])
def test_refusals(game, sd, case):
    px = photos(84, 140, 2).numpy()
    if case == "width_dim":
        with pytest.raises(ValueError, match="img_feat_dim"):
            predictor(game, sd, vcfg={**SMALL, "out_hidden_size": 40})
        return
    if case == "resnet_square":
        from gamebench.entries.serve_pixels import tower_state as resnet_sd
        from multimodalgame_tpu_torch.models.resnet import (
            params_from_torch_state)
        config, _, desc = game
        flags = program.make_flags(config, {"img_feat_dim": 512})
        made = weights.make_weights({**config["cfg"], "img_feat_dim": 512},
                                    11, "cpu")
        pred = Predictor(GameConfig.from_flags(flags),
                         program.agents(flags, made, "cpu"),
                         program.description_pack(desc), device="cpu",
                         tower=params_from_torch_state(resnet_sd(
                             {"num_classes": 2,
                              "image_shape": [3, 35, 35]}, 1, "cpu")))
        with pytest.raises(ValueError, match=r"ResNet-34.*\(B, 3, S, S\)"):
            pred.predict(px)
        return
    images = {"float": px.astype(np.float32),
              "height": px[:, :, :70].copy(),
              "width": px[:, :, :, :126].copy()}[case]
    with pytest.raises(ValueError, match="multiples of 28"):
        predictor(game, sd).predict(images)


def test_spans_and_counters(game, sd):
    """``mmg.tower.layout`` once a request shape, inside the first
    request's staging, and ``mmg.predict.tower`` inside each request;
    the tower's counters advance once a request."""
    pred = predictor(game, sd)
    px = photos(84, 140, 4).numpy()
    names = ("runs", "images", "tokens", "replays",
             "window_attention_launches", "full_attention_launches",
             "rotary_launches")
    before = {k: getattr(VisionTower, k) for k in names}
    tracer = Tracer(on_card=False)
    with traced(tracer):
        pred.predict(px)
        pred.predict(px)
    tr = Trace(tracer.events)
    spans = {}
    for s, e, n in zip(tr.cpu_s.tolist(), tr.cpu_e.tolist(), tr.cpu_n):
        spans.setdefault(n, []).append((s, e))
    assert len(spans["mmg.tower.layout"]) == 1
    assert len(spans["mmg.predict.tower"]) == 2
    (a, b), (c, d) = spans["mmg.tower.layout"][0], \
        spans["mmg.predict.input"][0]
    assert c <= a and b <= d
    for (a, b), (c, d) in zip(spans["mmg.predict.tower"],
                              spans["mmg.predict"]):
        assert c <= a and b <= d
    got = {k: getattr(VisionTower, k) - before[k] for k in names}
    # Two requests of 4 photos of 60 patches; 6 windowed blocks of two
    # window sizes and 2 full blocks a run, one rotation each; no replay
    # on the CPU.
    assert got == {"runs": 2, "images": 8, "tokens": 480, "replays": 0,
                   "window_attention_launches": 24,
                   "full_attention_launches": 4, "rotary_launches": 16}


def test_each_request_shape_has_its_graph(game, sd):
    """One ``StagedGraphs`` entry a request shape ``(B, H, W)``: a shape
    seen again reuses its buffer and its layout."""
    pred = predictor(game, sd)
    tower = pred._towers[pred.device]
    for h, w, n in ((84, 140, 2), (224, 224, 2), (84, 140, 2),
                    (84, 140, 3)):
        pred.predict(photos(h, w, n).numpy())
    assert sorted(tower._runs) == [(2, 84, 140), (2, 224, 224),
                                   (3, 84, 140)]
