"""The port's conversation, in eval and train mode, and the plain
versions of its CUDA kernel against the JAX package, on the CPU.

Inputs come from a seeded ``np.random.RandomState``; weights from the JAX
``init_params``, carried across with the port's ``params_to_torch_state``.
Bits, masks and ``n_steps`` must be equal; probabilities are held at atol
1e-5 and the class scores ``y`` at 1e-4 (f32, sums in another order).
The JAX kernel runs in Pallas interpret mode, as its own tests run it.
In train mode the port is handed the uniforms JAX's exchange draws
(tests/jax_uniforms.py), so its sampled bits equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.exchange import exchange as jax_exchange
from multimodalgame_tpu.game.exchange import (
    finalize_stop_masks as jax_finalize_stop_masks)
from multimodalgame_tpu.ops.pallas_exchange import (
    fused_eval_exchange as jax_fused_eval_exchange)
from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import (exchange,
                                                    finalize_stop_masks)
from multimodalgame_tpu_torch.game.masks import build_mask
from multimodalgame_tpu_torch.game.train import make_eval_exchange
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    FusedEvalOutputs, compare_outputs, fused_eval_exchange,
    fused_eval_exchange_reference, fused_train_forward_reference,
    kernel_params, param_shapes, supports_config)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms

B, D, FEAT, W, HID, WV, T = 8, 5, 64, 16, 32, 24, 4
PROB_ATOL, Y_ATOL = 1e-5, 1e-4
CORRUPT = "0:3,7"

VARIANTS = {
    "adaptive": {},
    "fixed": dict(fixed_exchange=True),
    "prod": dict(sender_mix="prod"),
    "ignore_code": dict(ignore_code=True),
    "ignore_receiver": dict(ignore_receiver=True),
    "no_s_prob_prod": dict(s_prob_prod=False),
    "first_rec_1": dict(first_rec=1.0),
    "corrupt": {},
    "continuous": dict(use_binary=False),
    # Random weights stop every row after turn 0; a stop bias of 1.5 makes
    # rows stop at different turns (n_steps 4, some rows alive to the end).
    "long": dict(stop_bias=1.5),
    "long_no_s_prob_prod": dict(stop_bias=1.0, s_prob_prod=False),
}


def _setup(batch=B, seed=0, stop_bias=0.0, **kw):
    base = dict(img_feat_dim=FEAT, img_h_dim=32, sender_out_dim=W,
                rec_w_dim=W, rec_hidden=HID, wv_dim=WV, max_exchange=T,
                baseline_hid_dim=16, fixed_exchange=False)
    base.update(kw)
    jm = JaxModules(JaxConfig(**base))
    jp = jax_init_params(jm, jax.random.PRNGKey(seed), num_classes=D)
    jp["receiver"]["s"]["bias"] = jp["receiver"]["s"]["bias"] + stop_bias
    mods = load_torch_state(AgentModules(GameConfig(**base)),
                            params_to_torch_state(jp))
    rng = np.random.RandomState(seed)
    data = rng.randn(batch, FEAT).astype(np.float32)
    desc = rng.randn(D, WV).astype(np.float32)
    return jm, jp, mods, data, desc


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _assert_same(got, want, masks_got, masks_want, binary=True):
    """Bits exact; a continuous channel's messages are activations and are
    held like probabilities."""
    for k in ("stop_feats", "sen_feats", "rec_feats"):
        if binary or k == "stop_feats":
            np.testing.assert_array_equal(_np(getattr(got, k)),
                                          _np(getattr(want, k)), err_msg=k)
        else:
            np.testing.assert_allclose(_np(getattr(got, k)),
                                       _np(getattr(want, k)),
                                       atol=PROB_ATOL, err_msg=k)
    np.testing.assert_array_equal(_np(masks_got), _np(masks_want),
                                  err_msg="masks")
    for k in ("stop_probs", "sen_probs", "rec_probs"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   _np(getattr(want, k)), atol=PROB_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(_np(got.y), _np(want.y), atol=Y_ATOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_eval_exchange_matches_jax(name):
    jm, jp, mods, data, desc = _setup(**VARIANTS[name])
    corrupt = build_mask(CORRUPT, W) if name == "corrupt" else None
    want = jax_exchange(jm, jp, jnp.asarray(data), jnp.asarray(desc),
                        jax.random.PRNGKey(1), train=False,
                        corrupt_mask=None if corrupt is None
                        else jnp.asarray(corrupt))
    with torch.no_grad():
        got = exchange(mods, torch.from_numpy(data), torch.from_numpy(desc),
                       None if corrupt is None else torch.from_numpy(corrupt))
    _assert_same(got, want, got.stop_masks, want.stop_masks,
                 binary=mods.cfg.use_binary)
    assert int(got.n_steps) == int(want.n_steps)
    if name.startswith("long"):
        assert int(got.n_steps) > 2
    if name == "long":                # rows stop at different turns
        alive = got.stop_masks.sum(dim=(1, 2))
        assert ((alive > 0) & (alive < B)).any()
    assert not got.bs.any() and not got.br.any()
    assert got.attn_scores is None


@pytest.mark.parametrize("batch", [1, 3, 13])
def test_eval_exchange_any_batch_size(batch):
    jm, jp, mods, data, desc = _setup(batch=batch, seed=batch)
    want = jax_exchange(jm, jp, jnp.asarray(data), jnp.asarray(desc),
                        jax.random.PRNGKey(1), train=False)
    with torch.no_grad():
        got = exchange(mods, torch.from_numpy(data), torch.from_numpy(desc))
    _assert_same(got, want, got.stop_masks, want.stop_masks)
    assert int(got.n_steps) == int(want.n_steps)


@pytest.mark.parametrize("name", ["adaptive", "corrupt", "long"])
def test_kernel_plain_version_matches_jax_kernel(name):
    jm, jp, mods, data, desc = _setup(**VARIANTS[name])
    cfg = mods.cfg
    corrupt = build_mask(CORRUPT, W) if name == "corrupt" else None
    want = jax_fused_eval_exchange(
        jm.cfg, jp, jnp.asarray(data), jnp.asarray(desc),
        corrupt_mask=None if corrupt is None else jnp.asarray(corrupt),
        interpret=True)
    with torch.no_grad():
        got = fused_eval_exchange_reference(
            cfg, kernel_params(mods), torch.from_numpy(data),
            torch.from_numpy(desc),
            None if corrupt is None else torch.from_numpy(corrupt))
    assert isinstance(got, FusedEvalOutputs)
    assert got._fields == want._fields
    _assert_same(got, want, got.masks, want.masks)


@pytest.mark.parametrize("name", ["adaptive", "fixed", "prod", "ignore_code",
                                  "ignore_receiver", "no_s_prob_prod",
                                  "first_rec_1", "corrupt", "long",
                                  "long_no_s_prob_prod"])
def test_kernel_plain_version_matches_port_exchange(name):
    _, _, mods, data, desc = _setup(seed=2, **VARIANTS[name])
    corrupt = (torch.from_numpy(build_mask(CORRUPT, W))
               if name == "corrupt" else None)
    x, d = torch.from_numpy(data), torch.from_numpy(desc)
    with torch.no_grad():
        want = exchange(mods, x, d, corrupt)
        got = fused_eval_exchange_reference(mods.cfg, kernel_params(mods),
                                            x, d, corrupt)
    _assert_same(got, want, got.masks[:-1], want.stop_masks[1:-1])


def test_kernel_params_layout():
    _, _, mods, _, _ = _setup()
    params = kernel_params(mods)
    shapes = param_shapes(mods.cfg)
    assert set(params) == set(shapes)
    for k, v in params.items():
        assert tuple(v.shape) == shapes[k], k
        assert v.is_contiguous() and v.dtype == torch.float32
    R = HID
    np.testing.assert_array_equal(
        _np(params["y1d"]), _np(mods.receiver.y1.weight[:, R:].t()))
    np.testing.assert_array_equal(
        _np(params["wimg"]), _np(mods.sender.image_layer.weight.t()))


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    _, _, mods, data, desc = _setup()
    before = fused_eval_exchange.launches
    x, d = torch.from_numpy(data), torch.from_numpy(desc)
    with torch.no_grad():
        got = fused_eval_exchange(mods.cfg, kernel_params(mods), x, d)
        want = fused_eval_exchange_reference(mods.cfg, kernel_params(mods),
                                             x, d)
    assert fused_eval_exchange.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    unsupported = GameConfig(**{**mods.cfg.__dict__, "use_binary": False})
    with pytest.raises(ValueError):
        fused_eval_exchange(unsupported, kernel_params(mods), x, d)


@pytest.mark.parametrize("name", ["adaptive", "fixed", "continuous", "long"])
def test_make_eval_exchange_matches_jax(name):
    jm, jp, mods, data, desc = _setup(**VARIANTS[name])
    assert supports_config(mods.cfg) == (name != "continuous")
    run = make_eval_exchange(mods, use_kernel=True)
    want = jax_exchange(jm, jp, jnp.asarray(data), jnp.asarray(desc),
                        jax.random.PRNGKey(1), train=False)
    with torch.no_grad():
        got = run(torch.from_numpy(data), torch.from_numpy(desc))
        again = run(torch.from_numpy(data), torch.from_numpy(desc))
    _assert_same(got, want, got.stop_masks, want.stop_masks,
                 binary=mods.cfg.use_binary)
    assert int(got.n_steps) == int(want.n_steps)
    assert torch.equal(got.y, again.y)


def test_make_eval_exchange_sees_new_weights():
    """The kernel-layout weights are rebuilt after an in-place update."""
    _, _, mods, data, desc = _setup()
    run = make_eval_exchange(mods, use_kernel=True)
    x, d = torch.from_numpy(data), torch.from_numpy(desc)
    with torch.no_grad():
        before = run(x, d).y.clone()
        mods.receiver.y2.bias.add_(1.0)
        after = run(x, d).y
    np.testing.assert_allclose(_np(after), _np(before) + 1.0, atol=1e-5)


@pytest.mark.parametrize("fixed", [True, False])
def test_finalize_stop_masks_matches_jax(fixed):
    rng = np.random.RandomState(6)
    for _ in range(5):
        masks = np.minimum.accumulate(
            (rng.rand(T, B, 1) < 0.6).astype(np.float32), axis=0)
        sm, n = finalize_stop_masks(torch.from_numpy(masks), fixed)
        jsm, jn = jax_finalize_stop_masks(jnp.asarray(masks), fixed)
        np.testing.assert_array_equal(_np(sm), _np(jsm))
        assert int(n) == int(jn)


def _outputs(T_, batch, seed, s_prob_prod=True):
    rng = np.random.RandomState(seed)
    probs = rng.rand(T_, batch, W).astype(np.float32) * 0.4 + 0.55
    sp = np.full((T_, batch, 1), 0.9, np.float32)
    y = rng.randn(T_, batch, D).astype(np.float32)
    bits = np.floor(probs + 0.5)
    s_bits = np.ones_like(sp)
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    return FusedEvalOutputs(t(s_bits), t(sp), t(bits), t(probs), t(bits),
                            t(probs), t(y), t(s_bits))


def test_compare_outputs_tie_rule():
    cfg = GameConfig(sender_out_dim=W, rec_w_dim=W, max_exchange=T)
    a = _outputs(T, B, 0)
    assert compare_outputs(cfg, a, a)["ok"]
    # A flipped bit whose probability sits on 0.5 is a tie: the row is
    # not compared from that turn on.
    b = FusedEvalOutputs(*(x.clone() for x in a))
    b.sen_probs[2, 3, 5] = a.sen_probs[2, 3, 5] = 0.5
    b.sen_feats[2, 3, 5] = 1.0 - a.sen_feats[2, 3, 5]
    b.y[3, 3] += 1.0
    rep = compare_outputs(cfg, a, b)
    assert rep["ok"] and rep["tie_rows"] == 1 and rep["bad_rows"] == 0
    # The same flip far from 0.5 fails.
    c = FusedEvalOutputs(*(x.clone() for x in a))
    c.sen_feats[1, 4, 0] = 1.0 - a.sen_feats[1, 4, 0]
    rep = compare_outputs(cfg, a, c)
    assert not rep["ok"] and rep["bad_rows"] == 1
    # So do probabilities and scores beyond their tolerances.
    d = FusedEvalOutputs(*(x.clone() for x in a))
    d.rec_probs[0, 0, 0] += 2e-5
    assert not compare_outputs(cfg, a, d)["ok"]
    e = FusedEvalOutputs(*(x.clone() for x in a))
    e.y[0, 0, 0] += 2e-4
    rep = compare_outputs(cfg, a, e)
    assert not rep["ok"] and rep["max_y_err"] == pytest.approx(2e-4, rel=1e-2)


# ---- Train mode: sampled bits from JAX's own uniforms --------------------

TRAIN_VARIANTS = {
    "adaptive": {},
    "fixed": dict(fixed_exchange=True),
    "prod": dict(sender_mix="prod"),
    "ignore_code": dict(ignore_code=True),
    "ignore_receiver": dict(ignore_receiver=True),
    "flipout": dict(flipout_sen=0.1, flipout_rec=0.2),
    "continuous": dict(use_binary=False),
}


def _train_case(name, batch=B, seed=0):
    jm, jp, mods, data, desc = _setup(batch=batch, seed=seed,
                                      **TRAIN_VARIANTS[name])
    key = jax.random.PRNGKey(10 + seed)
    want = jax_exchange(jm, jp, jnp.asarray(data), jnp.asarray(desc), key,
                        train=True)
    uniforms = jax_uniforms(jm.cfg, key, batch)
    return mods, torch.from_numpy(data), torch.from_numpy(desc), want, \
        uniforms


@pytest.mark.parametrize("name", list(TRAIN_VARIANTS))
def test_train_exchange_matches_jax(name):
    """Bits, masks and n_steps equal; probabilities at 1e-5, y at 1e-4,
    the baselines' scores at 1e-5."""
    mods, x, d, want, u = _train_case(name)
    with torch.no_grad():
        got = exchange(mods, x, d, train=True, uniforms=u)
    _assert_same(got, want, got.stop_masks, want.stop_masks,
                 binary=mods.cfg.use_binary)
    assert int(got.n_steps) == int(want.n_steps)
    for k in ("bs", "br"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   _np(getattr(want, k)), atol=PROB_ATOL,
                                   err_msg=k)
    assert got.bs.abs().sum() > 0
    with torch.no_grad():
        unscored = exchange(mods, x, d, train=True, uniforms=u,
                            score_baselines=False)
    assert not unscored.bs.any() and not unscored.br.any()
    assert torch.equal(unscored.sen_feats, got.sen_feats)


@pytest.mark.parametrize("batch", [1, 13])
def test_train_exchange_any_batch_size(batch):
    mods, x, d, want, u = _train_case("adaptive", batch=batch, seed=batch)
    with torch.no_grad():
        got = exchange(mods, x, d, train=True, uniforms=u)
    _assert_same(got, want, got.stop_masks, want.stop_masks)
    assert int(got.n_steps) == int(want.n_steps)


@pytest.mark.parametrize("name", [n for n in TRAIN_VARIANTS
                                  if n != "continuous"])
def test_train_kernel_plain_version_matches_jax(name):
    """The plain version of the train-mode kernel, fed JAX's uniforms,
    samples JAX's bits."""
    mods, x, d, want, u = _train_case(name, seed=1)
    with torch.no_grad():
        got = fused_train_forward_reference(mods.cfg, kernel_params(mods),
                                            x, d, u)
    stop_masks, n_steps = finalize_stop_masks(got.masks,
                                              mods.cfg.fixed_exchange)
    _assert_same(got, want, stop_masks, want.stop_masks)
    assert int(n_steps) == int(want.n_steps)


def test_train_exchange_needs_its_uniforms():
    mods, x, d, _, u = _train_case("flipout")
    with pytest.raises(ValueError, match="fw"):
        exchange(mods, x, d, train=True,
                 uniforms={k: v for k, v in u.items() if k != "fw"})
    with pytest.raises(ValueError):
        exchange(mods, x, d, train=True)


def test_eval_time_flipout_matches_jax():
    """``flipout_dev``: eval-mode rounding, then flipout from the fz/fw
    uniforms, as the JAX exchange does it."""
    jm, jp, mods, data, desc = _setup(flipout_sen=0.2, flipout_rec=0.3,
                                      flipout_dev=True)
    key = jax.random.PRNGKey(4)
    want = jax_exchange(jm, jp, jnp.asarray(data), jnp.asarray(desc), key,
                        train=False)
    u = jax_uniforms(jm.cfg, key, B, train=False)
    assert set(u) == {"fz", "fw"}
    with torch.no_grad():
        got = exchange(mods, torch.from_numpy(data), torch.from_numpy(desc),
                       uniforms=u)
        plain = exchange(mods, torch.from_numpy(data),
                         torch.from_numpy(desc),
                         uniforms={k: torch.ones_like(v)
                                   for k, v in u.items()})
    _assert_same(got, want, got.stop_masks, want.stop_masks)
    assert not torch.equal(got.sen_feats, plain.sen_feats)


def test_compare_outputs_tie_rule_in_train_mode():
    """In train mode the threshold of a bit is its uniform: a flip where
    ``p`` lies within 1e-5 of ``u`` is a tie, one far from it fails."""
    cfg = GameConfig(sender_out_dim=W, rec_w_dim=W, max_exchange=T)
    a = _outputs(T, B, 1)
    rng = np.random.RandomState(2)
    u = {k: torch.from_numpy(rng.rand(T, B, n).astype(np.float32) * 0.5)
         for k, n in (("z", W), ("w", W), ("s", 1))}
    assert compare_outputs(cfg, a, a, uniforms=u)["ok"]
    b = FusedEvalOutputs(*(x.clone() for x in a))
    u["z"][1, 2, 4] = b.sen_probs[1, 2, 4] = a.sen_probs[1, 2, 4]
    b.sen_feats[1, 2, 4] = 1.0 - a.sen_feats[1, 2, 4]
    b.y[2, 2] += 1.0
    rep = compare_outputs(cfg, a, b, uniforms=u)
    assert rep["ok"] and rep["tie_rows"] == 1
    c = FusedEvalOutputs(*(x.clone() for x in a))
    c.stop_feats[0, 5] = 1.0 - a.stop_feats[0, 5]
    rep = compare_outputs(cfg, a, c, uniforms=u)
    assert not rep["ok"] and rep["bad_rows"] == 1
