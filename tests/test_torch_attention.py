"""The port's attention presets, description attention and the ``mou`` mix
against the JAX package, on the CPU.

Sizes are tests/test_train_oracle_parity.py's (42-55): feature channels
24 on a 3x3 map, attention width 8, context 20, word attention 6. Weights
come from the JAX ``init_params`` through ``params_to_torch_state``;
inputs from a seeded numpy generator; the padded word sets hold 1-4 words
a class.

* Modules: the Sender per turn (t == 0, where the attention is uniform,
  and t > 0) for visual attention with and without the ``fc`` context,
  ``mou`` and ``mou`` + ``ignore_code``: logits, ``h_x`` and the scores
  at 1e-5; the Receiver with description attention at 1e-5, class scores
  at 1e-4; ``step_all`` against ``step``.
* The conversation in eval and in train mode (JAX's uniforms,
  tests/jax_uniforms.py): bits, masks and ``n_steps`` exact, the
  probabilities at 1e-5, the class scores at 1e-4, the attention scores
  at 1e-5, the baselines at 1e-5 (the Sender's on that turn's ``h_x``).

One training step in float64 is in tests/test_torch_attention_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.exchange import exchange as jax_exchange
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import exchange
from multimodalgame_tpu_torch.game.train import (make_eval_exchange,
                                                 make_train_step)
from multimodalgame_tpu_torch.ops.cuda_exchange import supports_config
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms

BASE = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=10, rec_w_dim=10,
            rec_hidden=14, wv_dim=16, max_exchange=4, baseline_hid_dim=12,
            attn_dim=8, attn_context_dim=20, desc_attn_dim=6,
            entropy_s=0.08, entropy_sen=0.01, entropy_rec=0.01,
            learning_rate=1e-3, fixed_exchange=False)
W_DIM = BASE["rec_w_dim"]
VARIANTS = {
    "visual_attn": dict(visual_attn=True),
    "visual_attn_context": dict(visual_attn=True, attn_extra_context=True),
    "mou": dict(sender_mix="mou"),
    "mou_ignore_code": dict(sender_mix="mou", ignore_code=True),
    "desc_attn": dict(desc_attn=True),
}
B, D, MAP = 6, 5, 3
WORDS = (1, 3, 2, 4, 2)          # words in each class's padded set
ATOL, Y_ATOL = 1e-5, 1e-4


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _inputs(cfg, seed, dtype=np.float32):
    """Features (a map under visual attention), context, CBOW rows and
    the padded word sets with their mask, from ``seed``."""
    rng = np.random.RandomState(seed)
    shape = ((B, cfg.img_feat_dim, MAP, MAP) if cfg.visual_attn
             else (B, cfg.img_feat_dim))
    mask = (np.arange(max(WORDS))[None] < np.asarray(WORDS)[:, None])
    out = dict(data=rng.randn(*shape),
               data_context=(rng.randn(B, cfg.attn_context_dim)
                             if cfg.attn_extra_context else None),
               desc=rng.randn(D, cfg.wv_dim),
               desc_set_padded=(rng.randn(D, max(WORDS), cfg.wv_dim)
                                * mask[..., None] if cfg.desc_attn else None),
               desc_set_mask=mask if cfg.desc_attn else None)
    return {k: None if v is None else v.astype(dtype)
            for k, v in out.items()}


def _init(jm, seed):
    return jax_init_params(jm, jax.random.PRNGKey(seed), num_classes=D,
                           max_words=max(WORDS))


@functools.lru_cache(maxsize=None)
def _setup(name, seed=0, stop_bias=1.5):
    """JAX's modules and weights (the stop bias keeps conversations going
    past turn 0), the port's agents at the same weights, and inputs."""
    base = {**BASE, **VARIANTS[name]}
    jm = JaxModules(JaxConfig(**base))
    jp = _init(jm, seed)
    jp["receiver"]["s"]["bias"] = jp["receiver"]["s"]["bias"] + stop_bias
    mods = load_torch_state(AgentModules(GameConfig(**base)),
                            params_to_torch_state(jp))
    return jm, jp, mods, _inputs(mods.cfg, seed)


def _t(inputs):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in inputs.items()}


def _j(inputs):
    return {k: None if v is None else jnp.asarray(v)
            for k, v in inputs.items()}


def _japply(module, params, method):
    """``module``'s ``method`` at ``params``, jitted."""
    return jax.jit(lambda *a: module.apply({"params": params}, *a,
                                           method=method))


# ------------------------------------------------------------- modules

@pytest.mark.parametrize("name", ["visual_attn", "visual_attn_context",
                                  "mou", "mou_ignore_code"])
@pytest.mark.parametrize("t", [0, 2])
def test_sender_step_matches_jax(name, t):
    jm, jp, mods, x = _setup(name)
    w = (np.random.RandomState(1).rand(B, W_DIM) < 0.5).astype(np.float32)
    jx = _j(x)

    cache = _japply(jm.sender, jp["sender"], "precompute")(
        jx["data"], jx["data_context"])
    want = _japply(jm.sender, jp["sender"], "step")(
        jx["data"], jnp.asarray(w), jnp.int32(t), cache)
    tx = _t(x)
    pc = mods.sender.precompute(tx["data"], tx["data_context"])
    got = mods.sender.step(torch.from_numpy(w), t, pc)
    for g, wt, what in zip(got, want, ("logits", "h_x", "attn_scores")):
        if wt is None:
            assert g is None, what
        else:
            np.testing.assert_allclose(_np(g), _np(wt), atol=ATOL,
                                       err_msg=what)
    if mods.cfg.visual_attn:
        n = MAP * MAP
        if t == 0:
            np.testing.assert_array_equal(_np(got[2]),
                                          np.full((B, n), 1.0 / n,
                                                  np.float32))
        else:
            assert not np.allclose(_np(got[2]), 1.0 / n)
        np.testing.assert_allclose(_np(got[2]).sum(-1), 1.0, atol=1e-6)


def test_receiver_with_description_attention_matches_jax():
    jm, jp, mods, x = _setup("desc_attn")
    rng = np.random.RandomState(2)
    z = (rng.rand(B, W_DIM) < 0.5).astype(np.float32)
    h = rng.randn(B, BASE["rec_hidden"]).astype(np.float32)
    jx, tx = _j(x), _t(x)

    cache = _japply(jm.receiver, jp["receiver"], "precompute")(
        jx["desc"], jx["desc_set_padded"], jx["desc_set_mask"])
    want = _japply(jm.receiver, jp["receiver"], "step")(
        jnp.asarray(z), jnp.asarray(h), cache)
    pc = mods.receiver.precompute(tx["desc"], tx["desc_set_padded"],
                                  tx["desc_set_mask"])
    got = mods.receiver.step(torch.from_numpy(z), torch.from_numpy(h), pc)
    for g, wt, what, tol in zip(got, want, ("h_z", "s_logits", "y",
                                            "w_logits"),
                                (ATOL, ATOL, Y_ATOL, ATOL)):
        np.testing.assert_allclose(_np(g), _np(wt), atol=tol, err_msg=what)
    np.testing.assert_allclose(_np(pc["dd"]), _np(cache["dd"]), atol=ATOL)
    np.testing.assert_allclose(_np(pc["hz_w"]).T, _np(cache["hz_k"]),
                               atol=0)
    # Words beyond a class's set get no weight: changing them changes
    # nothing.
    noisy = tx["desc_set_padded"] + 5.0 * (1 - tx["desc_set_mask"])[..., None]
    again = mods.receiver.step(torch.from_numpy(z), torch.from_numpy(h),
                               mods.receiver.precompute(
                                   tx["desc"], noisy, tx["desc_set_mask"]))
    for a, b in zip(again, got):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["visual_attn", "visual_attn_context",
                                  "mou", "mou_ignore_code"])
def test_step_all_matches_step(name):
    _, _, mods, x = _setup(name)
    tx = _t(x)
    T = BASE["max_exchange"]
    w_prev = torch.from_numpy(
        (np.random.RandomState(3).rand(T, B, W_DIM) < 0.5)
        .astype(np.float32))
    pc = mods.sender.precompute(tx["data"], tx["data_context"])
    with torch.no_grad():
        logits, h_x, attn = mods.sender.step_all(w_prev, pc)
        for t in range(T):
            l_t, h_t, a_t = mods.sender.step(w_prev[t], t, pc)
            torch.testing.assert_close(logits[t], l_t, rtol=0, atol=1e-6)
            torch.testing.assert_close(h_x[t], h_t, rtol=0, atol=1e-6)
            if a_t is None:
                assert attn is None
            else:
                torch.testing.assert_close(attn[t], a_t, rtol=0, atol=1e-7)


def test_parameters_in_reference_order_and_mou_width():
    mods = AgentModules(GameConfig(**BASE, visual_attn=True,
                                   attn_extra_context=True, desc_attn=True,
                                   sender_mix="mou", ignore_code=True))
    assert [n for n, _ in mods.sender.named_parameters()] == [
        "code_bias", "code_bias_mou", "image_layer.weight",
        "image_layer.bias", "code_layer.weight", "code_layer.bias",
        "binary_layer.weight", "binary_layer.bias", "attn_W_x.weight",
        "attn_W_x.bias", "attn_W_w.weight", "attn_W_w.bias",
        "attn_U.weight", "attn_U.bias", "attn_W_g.weight", "attn_W_g.bias"]
    assert [n for n, _ in mods.receiver.named_parameters()][-6:] == [
        "d_d.weight", "d_d.bias", "d_h.weight", "d_h.bias",
        "d_attn.weight", "d_attn.bias"]
    assert mods.sender.binary_layer.in_features == 4 * BASE["img_h_dim"]
    assert not hasattr(AgentModules(GameConfig(**BASE, sender_mix="mou"))
                       .sender, "code_bias_mou")
    with pytest.raises(ValueError, match="sender_mix"):
        AgentModules(GameConfig(**BASE, sender_mix="max"))


def test_init_matches_jax_in_distribution():
    """The new layers take the reference's schemes: Xavier-normal weights
    (std ``sqrt(2 / (fan_in + fan_out))``) and zero biases, a
    standard-normal ``code_bias_mou``. Both packages' draws are held to
    that std within sampling noise, and zero where JAX's are."""
    kw = dict(img_feat_dim=512, img_h_dim=256, sender_out_dim=32,
              rec_w_dim=32, rec_hidden=64, wv_dim=100, baseline_hid_dim=16,
              visual_attn=True, attn_extra_context=True,
              attn_context_dim=1000, desc_attn=True, sender_mix="mou",
              ignore_code=True)
    want = params_to_torch_state(jax_init_params(
        JaxModules(JaxConfig(**kw)), jax.random.PRNGKey(3), num_classes=30))
    mods = init_params(AgentModules(GameConfig(**kw)), seed=3)
    for agent in ("sender", "receiver"):
        got = getattr(mods, agent).state_dict()
        assert set(got) == set(want[agent])
        for name, v in got.items():
            ref = want[agent][name]
            assert tuple(v.shape) == ref.shape, name
            if not ref.any():
                assert not v.any(), name
                continue
            std = 1.0 if v.dim() == 1 else (2.0 / sum(v.shape)) ** 0.5
            tol = 0.35 if v.numel() < 100 else 0.1
            for drawn in (float(v.std()), float(ref.std())):
                assert abs(drawn / std - 1.0) < tol, (name, drawn, std)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_kernel_refuses_what_the_jax_kernel_refuses(name):
    cfg = GameConfig(**{**BASE, **VARIANTS[name]})
    assert not supports_config(cfg)
    assert supports_config(GameConfig(**BASE))
    with pytest.raises(ValueError, match="fast='kernel'"):
        make_train_step(AgentModules(cfg), 2, B, fast="kernel",
                        device="cpu")


# ---------------------------------------------------------- conversation

def _assert_same(got, want, y_atol=Y_ATOL):
    for k in ("stop_feats", "sen_feats", "rec_feats", "stop_masks"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      _np(getattr(want, k)), err_msg=k)
    assert int(got.n_steps) == int(want.n_steps)
    for k in ("stop_probs", "sen_probs", "rec_probs", "bs", "br"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   _np(getattr(want, k)), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(_np(got.y), _np(want.y), atol=y_atol)
    if want.attn_scores is None:
        assert got.attn_scores is None
    else:
        np.testing.assert_allclose(_np(got.attn_scores),
                                   _np(want.attn_scores), atol=ATOL)


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_exchange_matches_jax(name, train):
    jm, jp, mods, x = _setup(name, seed=4)
    key = jax.random.PRNGKey(9)
    jx = _j(x)
    want = jax_exchange(jm, jp, jx["data"], jx["desc"], key, train=train,
                        desc_set_padded=jx["desc_set_padded"],
                        desc_set_mask=jx["desc_set_mask"],
                        data_context=jx["data_context"])
    tx = _t(x)
    u = jax_uniforms(jm.cfg, key, B, train=train) if train else None
    with torch.no_grad():
        if train:
            got = exchange(mods, tx.pop("data"), tx.pop("desc"), train=True,
                           uniforms=u, **tx)
        else:
            run = make_eval_exchange(mods)
            got = run(tx.pop("data"), tx.pop("desc"), **tx)
    _assert_same(got, want)
    assert int(got.n_steps) > 1
    if train:
        assert got.bs.abs().sum() > 0
    if mods.cfg.visual_attn:
        assert got.attn_scores.shape == (BASE["max_exchange"], B, MAP * MAP)
