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
from torch.utils.flop_counter import FlopCounterMode

from gamebench import program, run, weights
from gamebench.counts_resnet import tower_work
from gamebench.entries.serve_pixels import make_pixels, tower_state
from gamebench.reference import resnet as ref
from gamebench.reference.game import eval_answers
from gamebench.trace import Trace, Tracer, traced
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.models.resnet import (PixelTower,
                                                    normalize_pixels,
                                                    params_from_torch_state,
                                                    resnet34_features)
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
