"""Serving from pixels: the port's ResNet-34 tower
(``models/resnet.py:PixelTower``, ``resnet34_features``) and
``Predictor(..., tower=...)`` against the benchmark's plain reference
(``gamebench/reference/resnet.py`` and ``reference/game.py``) on seeded
torchvision-layout weights whose batch norms hold non-identity running
statistics (``gamebench/entries/serve_pixels.py:tower_state``, calibrated
on 35x35 images), on the CPU."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from gamebench import program, run, weights
from gamebench.counts_resnet import tower_work
from gamebench.entries.serve_pixels import make_pixels, tower_state
from gamebench.reference import resnet as ref
from gamebench.reference.game import eval_answers
from gamebench.trace import Trace, Tracer, traced
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.models.resnet import (LAYER_NAMES, PLAIN_TAPS,
                                                    PixelTower,
                                                    fold_batch_norms,
                                                    folded_forward,
                                                    normalize_pixels,
                                                    params_from_torch_state,
                                                    resnet34_features)
from multimodalgame_tpu_torch.ops import cuda_tower
from multimodalgame_tpu_torch.serve import Predictor

SMALL = 35
TAPS = ("layer4_2", "avgpool_512", "fc")
# A tap's largest gap to the reference, over the tap's largest magnitude:
# the two arrange batch norm differently (folded into a scale and a shift,
# unfolded), and float32 rounding of that over 36 layers reads a few
# 1e-6; the reference with TF32-rounded operands reads 1e-3 and more.
TAP_TOL = 5e-5
# The answer's log-probabilities: the game adds its own float32 rounding
# on features a few 1e-6 apart (reads ~1e-7 here); a TF32 tower moves them
# by ~4e-2.
LOGP_TOL = 1e-4


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def sd():
    return tower_state({"num_classes": 6, "image_shape": [3, SMALL, SMALL]},
                       3, "cpu")


@pytest.fixture(scope="module")
def params(sd):
    return params_from_torch_state(sd, "cpu")


def pixels(size: int, n: int, seed: int = 5) -> torch.Tensor:
    cfg = {"num_classes": 6, "image_shape": [3, size, size],
           "dev_per_class": (n + 5) // 6}
    return make_pixels(cfg, "dev", seed, "cpu")[:n]


def test_batch_norms_hold_non_identity_statistics(sd):
    for name in ("bn1", "layer2.0.downsample.1", "layer4.2.bn2"):
        assert (sd[name + ".running_mean"].abs() > 1e-4).any()
        assert ((sd[name + ".running_var"] - 1).abs() > 1e-2).any()


@pytest.mark.parametrize("size,batch", [(227, 2), (SMALL, 4)])
def test_tower_matches_the_reference(params, sd, size, batch):
    px = pixels(size, batch)
    got = resnet34_features(params, normalize_pixels(px), TAPS)
    want = ref.features(sd, px, TAPS)
    control = ref.features(sd, px, TAPS, prec="tf32")
    if size == 227:
        assert got["layer4_2"].shape == (batch, 512, 8, 8)
    for tap in TAPS:
        assert gap(got[tap], want[tap]) < TAP_TOL, tap
        # The tolerance is tight enough that a TF32 tower fails it.
        assert gap(control[tap], want[tap]) > 10 * TAP_TOL, tap
    # layer4_2 is the last block's sum before its ReLU.
    assert (got["layer4_2"] < 0).any()


def test_normalisation_is_totensor_normalize():
    px = torch.arange(256, dtype=torch.uint8).repeat(2, 3, 1, 1)
    got = normalize_pixels(px)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.to_tensor_normalize(px))
    assert float(got.min()) == -1.0 and float(got.max()) == 1.0


@pytest.mark.parametrize("tap", TAPS)
def test_forward_stops_at_the_deepest_tap(params, tap):
    """Nothing past the tap is computed: the products counted are the
    tap's, and no ``fc`` unless it is asked for."""
    px = normalize_pixels(pixels(SMALL, 2))
    with FlopCounterMode(display=False) as count:
        out = resnet34_features(params, px, (tap,))
    assert list(out) == [tap]
    assert count.get_total_flops() == tower_work(2, SMALL, tap)["flops"]


@pytest.fixture(scope="module")
def game():
    """The cell's configuration at a small game that reads the tower's
    512 pooled features, its weights, and its flags."""
    config = run.load_config("resnet34_adaptive")
    small = dict(img_h_dim=12, sender_out_dim=8, rec_w_dim=8, rec_hidden=12,
                 wv_dim=16, baseline_hid_dim=12, max_exchange=3,
                 num_classes=6, dev_per_class=2,
                 image_shape=[3, SMALL, SMALL])
    for key, value in small.items():
        config["flags" if key in config["flags"] else "data"][key] = value
        config["cfg"][key] = value
    cfg = config["cfg"]
    made = weights.make_weights(cfg, 11, "cpu")
    desc = torch.randn(cfg["num_classes"], cfg["wv_dim"],
                       generator=torch.Generator().manual_seed(12))
    return config, made, desc


def predictor(game, sd=None, device="cpu"):
    config, made, desc = game
    flags = program.make_flags(config, {})
    return Predictor(GameConfig.from_flags(flags),
                     program.agents(flags, made, "cpu"),
                     program.description_pack(desc), device=device,
                     tower=None if sd is None
                     else params_from_torch_state(sd, "cpu"))


def test_pixel_predictor_matches_the_reference(game, sd):
    config, made, desc = game
    px = pixels(SMALL, 8).numpy()
    out = predictor(game, sd).predict(px)
    feats = ref.features(sd, torch.as_tensor(px))["avgpool_512"]
    want = eval_answers(made, config["cfg"], feats, desc)
    assert out["n_steps"] == want["n_steps"]
    for k in ("sender_messages", "receiver_messages",
              "conversation_length"):
        np.testing.assert_array_equal(out[k], want[k].numpy(), err_msg=k)
    np.testing.assert_allclose(out["log_probs"], want["log_probs"].numpy(),
                               rtol=0, atol=LOGP_TOL)
    # A TF32 tower parts from the reference by more than the tolerance.
    tf = ref.features(sd, torch.as_tensor(px), prec="tf32")["avgpool_512"]
    control = eval_answers(made, config["cfg"], tf, desc)
    assert float((control["log_probs"] - want["log_probs"]).abs().max()) \
        > LOGP_TOL


def test_pixel_path_is_the_feature_path_on_the_towers_features(game, sd,
                                                                params):
    px = pixels(SMALL, 8).numpy()
    got = predictor(game, sd).predict(px)
    feats = resnet34_features(params, normalize_pixels(torch.as_tensor(px)),
                              ("avgpool_512",))["avgpool_512"]
    want = predictor(game).predict(feats.numpy())
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_crop_sizes_each_have_their_run(game, sd):
    """One Predictor serves two crop sizes, each against the reference:
    the tower keeps a run a request shape, and a size seen again reuses
    its run."""
    config, made, desc = game
    pred = predictor(game, sd)
    tower = pred._towers[pred.device]
    for size in (SMALL, SMALL + 8, SMALL):
        px = pixels(size, 3).numpy()
        out = pred.predict(px)
        feats = ref.features(sd, torch.as_tensor(px))["avgpool_512"]
        want = eval_answers(made, config["cfg"], feats, desc)
        np.testing.assert_array_equal(out["sender_messages"],
                                      want["sender_messages"].numpy())
        np.testing.assert_allclose(out["log_probs"],
                                   want["log_probs"].numpy(), rtol=0,
                                   atol=LOGP_TOL)
    assert sorted(tower._runs) == [(3, SMALL, SMALL),
                                   (3, SMALL + 8, SMALL + 8)]


@pytest.mark.parametrize("case", ["float", "shape", "channels_last",
                                  "no_tower"])
def test_refusals(game, sd, case):
    px = pixels(SMALL, 2).numpy()
    pred = predictor(game, None if case == "no_tower" else sd)
    images, match = {
        "float": (px.astype(np.float32), "uint8 pixels"),
        "shape": (px[:, :, :, 1:].copy(), r"\(B, 3, S, S\)"),
        "channels_last": (px.transpose(0, 2, 3, 1).copy(),
                          r"\(B, 3, S, S\)"),
        "no_tower": (px, "tower="),
    }[case]
    with pytest.raises(ValueError, match=match):
        pred.predict(images)


def test_attention_context_is_refused(game, sd):
    config, made, desc = game
    flags = program.make_flags(config, {"visual_attn": True,
                                        "attn_extra_context": True})
    with pytest.raises(ValueError, match="attn_extra_context"):
        Predictor(GameConfig.from_flags(flags), None,
                  program.description_pack(desc), device="cpu",
                  tower=params_from_torch_state(sd, "cpu"))


def test_serving_leaves_the_callers_precision(game, sd):
    """The tower turns TF32 off for its forward and restores the
    caller's flags after."""
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        predictor(game, sd).predict(pixels(SMALL, 2).numpy())
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_tower_span_inside_predict(game, sd):
    pred = predictor(game, sd)
    px = pixels(SMALL, 4).numpy()
    pred.predict(px)
    tracer = Tracer(on_card=False)
    with traced(tracer):
        pred.predict(px)
    tr = Trace(tracer.events)
    spans = {n: (s, e) for s, e, n in zip(tr.cpu_s.tolist(),
                                          tr.cpu_e.tolist(), tr.cpu_n)
             if n.startswith("mmg.predict")}
    outer, tower = spans["mmg.predict"], spans["mmg.predict.tower"]
    assert outer[0] <= tower[0] and tower[1] <= outer[1]
    # The tower runs after the input is staged and before the game.
    assert spans["mmg.predict.input"][1] <= tower[0]
    assert tower[1] <= spans["mmg.predict.replay"][0]


def test_counters_advance_once_a_request(game, sd):
    pred = predictor(game, sd)
    before = (PixelTower.runs, PixelTower.images, PixelTower.replays)
    for n in (4, 4, 3):
        pred.predict(pixels(SMALL, n).numpy())
    assert (PixelTower.runs - before[0], PixelTower.images - before[1],
            PixelTower.replays - before[2]) == (3, 11, 0)


def test_tower_split_over_devices(game, sd):
    """Two devices (the CPU twice): each block's tower is its device's
    replica, and the answer is the one device's."""
    px = pixels(SMALL, 8).numpy()
    one = predictor(game, sd).predict(px)
    split = predictor(game, sd, device=["cpu", "cpu"]).predict(px)
    np.testing.assert_array_equal(split["prediction"], one["prediction"])
    np.testing.assert_allclose(split["log_probs"], one["log_probs"],
                               rtol=0, atol=1e-6)


# ------------------------------------------------- the folded forward

FOLDED_TAPS = tuple(t for t in LAYER_NAMES if t not in PLAIN_TAPS)
# Each float32 forward against the same network in float64: folding
# moves the rounding, not its size (both read up to ~8e-6 here), so the
# two float32 forwards lie up to the sum of their errors apart.
FOLD_TOL = 1e-5


def norm_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).norm() / want.norm())


def float64(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double()
    if isinstance(tree, dict):
        return {k: float64(v) for k, v in tree.items()}
    return [float64(v) for v in tree]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("size", [SMALL, SMALL + 8, 227])
def test_folded_and_plain_forwards_match_float64(params, size, batch):
    """The folded forward with the plain epilogues and
    ``resnet34_features`` at every tap from ``bn1`` on, each within
    FOLD_TOL of the network computed in float64 (folded in float64 too;
    the plain forward's agreement shows the folding's algebra). Each
    forward runs once and gives every tap."""
    x = normalize_pixels(pixels(size, batch))
    taps = set(FOLDED_TAPS)
    plain = resnet34_features(params, x, FOLDED_TAPS)
    got = folded_forward(fold_batch_norms(params, "cpu"), x, taps)
    want = folded_forward(fold_batch_norms(float64(params), "cpu"),
                          x.double(), taps)
    assert set(got) == set(want) == taps
    for tap in FOLDED_TAPS:
        assert got[tap].dtype == torch.float32, tap
        assert got[tap].shape == want[tap].shape, tap
        assert norm_gap(got[tap], want[tap]) < FOLD_TOL, tap
        assert norm_gap(plain[tap], want[tap]) < FOLD_TOL, tap
    # layer4_2 is the sum before the last ReLU, layer4_2_relu after it.
    assert (got["layer4_2"] < 0).any()
    assert torch.equal(torch.relu(got["layer4_2"]), got["layer4_2_relu"])


def test_each_tap_alone_is_the_taps_together_bit_for_bit(params):
    """A tap asked for alone runs the passes in place (``layer4_2``'s
    last pass without its ReLU) and stops there; beside deeper taps it is
    computed out of place. Both give the same bits, and the deeper taps
    do not overwrite the shallower."""
    folded = fold_batch_norms(params, "cpu")
    x = normalize_pixels(pixels(SMALL, 2))
    together = folded_forward(folded, x, FOLDED_TAPS)
    for tap in FOLDED_TAPS:
        alone = folded_forward(folded, x, (tap,))
        assert set(alone) == {tap}
        assert torch.equal(alone[tap], together[tap]), tap
    assert not torch.equal(together["bn1"], together["relu"])


def test_stem_is_the_pool_of_the_relu_bit_for_bit():
    """relu(max(window) + b) against max_pool(relu(y + b)), on values
    with ties, negatives and biases that move some windows across 0."""
    gen = torch.Generator().manual_seed(3)
    y = torch.randint(-6, 7, (3, 8, 19, 20), generator=gen).float() / 4
    y[0, 0] = 0.5                                   # a plane of ties
    y[1, 1] = -torch.rand(19, 20, generator=gen)    # all negative
    bias = torch.randn(8, generator=gen)
    bias[1] = 0.25
    want = F.max_pool2d(torch.relu(y + bias.view(1, -1, 1, 1)), 3, 2, 1)
    got = cuda_tower.stem(y, bias)
    assert got.shape == (3, 8, 10, 10)
    assert torch.equal(got, want)
    assert torch.equal(cuda_tower.stem_reference(y, bias), want)


def test_block_epilogue_is_in_place_in_the_plain_order():
    gen = torch.Generator().manual_seed(4)
    y, r = (torch.randn(2, 4, 5, 5, generator=gen) for _ in range(2))
    b, rb = (torch.randn(4, generator=gen) for _ in range(2))
    for residual, residual_bias, relu in ((None, None, True),
                                          (r, None, True), (r, rb, False)):
        out = y.clone()
        want = y + b.view(1, -1, 1, 1)
        if residual is not None:
            want = want + (r if residual_bias is None
                           else r + rb.view(1, -1, 1, 1))
        if relu:
            want = torch.relu(want)
        got = cuda_tower.block_epilogue(out, b, residual, residual_bias,
                                        relu)
        assert got is out and torch.equal(got, want)


@pytest.mark.parametrize("tap", PLAIN_TAPS)
def test_pre_batch_norm_taps_keep_the_plain_forward(params, tap):
    tower = PixelTower(params, tap, "cpu")
    assert not tower.fused and "bn1" in tower.params
    px = pixels(SMALL, 2)
    before = PixelTower.fused_runs
    got = tower(tower.stage(px.numpy()))
    want = resnet34_features(params, normalize_pixels(px), (tap,))[tap]
    assert torch.equal(got, want)
    assert PixelTower.fused_runs == before
    with pytest.raises(KeyError, match=tap):
        folded_forward(fold_batch_norms(params, "cpu"),
                       normalize_pixels(px), (tap, "fc"))


def test_bn1_is_served_on_the_folded_route(params):
    """bn1 is conv1 on the folded weights plus the folded bias: the
    tower serves it on the folded route, within FOLD_TOL of the network
    in float64, as the plain forward's scale-and-shift is."""
    tower = PixelTower(params, "bn1", "cpu")
    assert tower.fused and "bn1" not in tower.params
    px = pixels(SMALL, 2)
    before = PixelTower.fused_runs
    got = tower(tower.stage(px.numpy()))
    assert PixelTower.fused_runs == before + 1
    x = normalize_pixels(px)
    assert torch.equal(got, folded_forward(tower.params, x, ("bn1",))["bn1"])
    want = folded_forward(fold_batch_norms(float64(params), "cpu"),
                          x.double(), ("bn1",))["bn1"]
    plain = resnet34_features(params, x, ("bn1",))["bn1"]
    assert (got < 0).any()
    assert norm_gap(got, want) < FOLD_TOL
    assert norm_gap(plain, want) < FOLD_TOL


def test_fused_runs_count_the_folded_route(params):
    fused = PixelTower(params, "avgpool_512", "cpu")
    plain = PixelTower(params, "conv1", "cpu")
    px = pixels(SMALL, 2).numpy()
    launches = [f.launches for f in cuda_tower.COUNTED]
    runs, fused_runs = PixelTower.runs, PixelTower.fused_runs
    for _ in range(3):
        fused(fused.stage(px))
    assert (PixelTower.runs - runs, PixelTower.fused_runs - fused_runs) \
        == (3, 3)
    plain(plain.stage(px))
    assert (PixelTower.runs - runs, PixelTower.fused_runs - fused_runs) \
        == (4, 3)
    # The CPU runs the plain epilogues: no kernel is launched.
    assert [f.launches for f in cuda_tower.COUNTED] == launches


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def test_folded_parameters_replace_the_unfolded_ones(params):
    """The tower keeps one set of parameters: each convolution's folded
    weight and its bias, and ``fc``; no batch norm and no unfolded
    weight."""
    tower = PixelTower(params, "avgpool_512", "cpu")
    held = dict(_leaves(tower.params))
    assert all(path[-1] in ("weight", "bias") for path in held)
    convs = [w for path, w in _leaves(params)
             if path[-1] in ("conv1", "conv2", "down_conv")]
    assert len(convs) == 36
    assert sum(x.numel() for x in held.values()) == (
        sum(w.numel() + w.shape[0] for w in convs)
        + params["fc"]["weight"].numel() + params["fc"]["bias"].numel())
    given = {x.data_ptr() for _, x in _leaves(params) if x.dim() == 4}
    assert not given & {x.data_ptr() for x in held.values()
                        if x.dim() == 4}
    block = tower.params["layer2"][0]
    assert set(block) == {"conv1", "conv2", "down"}
    assert torch.equal(block["down"]["weight"],
                       params["layer2"][0]["down_conv"]
                       * params["layer2"][0]["down_bn"]["scale"].reshape(
                           -1, 1, 1, 1))
    assert torch.equal(block["down"]["bias"],
                       params["layer2"][0]["down_bn"]["shift"].reshape(-1))
