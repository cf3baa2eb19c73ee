"""One training step of the attention presets, ``-desc_attn`` and the
``mou`` mix in float64 against the JAX package, on the CPU.

FixedAttention, AdaptiveAttention, ``desc_attn`` and ``mou``, by the
port's fast path and by its plain one: losses, gradients and the updated
weights to ~1e-9 against JAX's step (its fast path, whose numbers its
scan path gives to ~1e-12 in float64, tests/test_fast_train.py), as
tests/test_torch_train.py holds the presets without attention. Sizes,
weights and inputs as tests/test_torch_attention.py makes them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.fast_train import (
    compute_losses_fast as jax_compute_losses_fast)
from multimodalgame_tpu.game.train import AGENT_NAMES as JAX_AGENT_NAMES
from multimodalgame_tpu.game.train import (
    apply_agent_updates as jax_apply_agent_updates)
from multimodalgame_tpu.game.train import (
    build_optimizer as jax_build_optimizer)
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (init_opt_states,
                                                 make_train_step)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms
from tests.test_torch_attention import B, BASE, D, _init, _inputs, _j

RTOL64, ATOL64 = 1e-9, 1e-12
DELTA_RTOL, DELTA_ATOL = 1e-8, 3e-11   # as tests/test_torch_train.py
LOSSES = ("loss_rec", "loss_sen", "nll_loss", "loss_binary_rec",
          "loss_binary_s", "loss_bas_rec", "loss_bas_sen")

PRESETS = {
    "FixedAttention": dict(fixed_exchange=True, visual_attn=True,
                           attn_extra_context=True),
    "AdaptiveAttention": dict(visual_attn=True, attn_extra_context=True),
    "desc_attn": dict(desc_attn=True),
    "mou": dict(sender_mix="mou"),
}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_step(preset):
    """JAX's losses, gradients and updated weights for one RMSprop step in
    float64 (one jitted program, as its train step is), and the uniforms
    its exchange drew."""
    kw = {**BASE, **PRESETS[preset]}
    mods = JaxModules(JaxConfig(**kw))
    params = _init(mods, 0)      # drawn in float32, then widened
    with jax.enable_x64(True):
        params = _f64(params)
        params_np = _np_tree(params)
        x = _inputs(mods.cfg, 11, np.float64)
        target = np.random.RandomState(12).randint(0, D, size=B)
        jx = _j(x)
        key = jax.random.PRNGKey(42)
        att = dict(desc_set_padded=jx["desc_set_padded"],
                   desc_set_mask=jx["desc_set_mask"],
                   data_context=jx["data_context"])

        tx = jax_build_optimizer(mods.cfg)

        @jax.jit
        def step(p, opts):
            grads, m = jax.grad(
                lambda q: jax_compute_losses_fast(
                    mods, q, jx["data"], jnp.asarray(target), jx["desc"],
                    key, 2, B, **att), has_aux=True)(p)
            new, _ = jax_apply_agent_updates(tx, JAX_AGENT_NAMES, grads, p,
                                             opts)
            return grads, m, new

        grads, m, new_params = step(params,
                                    jax_init_opt_states(mods.cfg, params))
        return dict(kw=kw, params=params_np, grads=_np_tree(grads),
                    new_params=_np_tree(new_params), inputs=x,
                    target=target,
                    uniforms=jax_uniforms(mods.cfg, key, B,
                                          dtype=jnp.float64),
                    losses={k: float(getattr(m, k)) for k in LOSSES},
                    ex={k: np.asarray(getattr(m.exchange, k))
                        for k in ("sen_feats", "rec_feats", "stop_feats",
                                  "stop_masks", "n_steps")})


@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fast"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_train_step_matches_jax(preset, fast):
    want = _jax_step(preset)
    mods = AgentModules(GameConfig(**want["kw"])).double()
    load_torch_state(mods, {
        a: {k: torch.from_numpy(np.array(v, np.float64))
            for k, v in sd.items()}
        for a, sd in params_to_torch_state(want["params"]).items()})
    step = make_train_step(mods, 2, B, fast=fast,
                           uniforms=lambda s: want["uniforms"], device="cpu")
    opts = init_opt_states(mods.cfg, mods)
    x = dict(want["inputs"])
    m = step(opts, x.pop("data"), want["target"], x.pop("desc"), 0, **x)

    for k in ("sen_feats", "rec_feats", "stop_feats", "stop_masks"):
        np.testing.assert_array_equal(getattr(m.exchange, k).numpy(),
                                      want["ex"][k], err_msg=k)
    assert int(m.exchange.n_steps) == int(want["ex"]["n_steps"])
    for k in LOSSES:
        np.testing.assert_allclose(float(getattr(m, k)), want["losses"][k],
                                   rtol=RTOL64, atol=ATOL64, err_msg=k)
    grads = params_to_torch_state(want["grads"])
    new = params_to_torch_state(want["new_params"])
    base = params_to_torch_state(want["params"])
    for agent in AGENT_NAMES:
        for name, p in getattr(mods, agent).named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[agent][name],
                                       rtol=RTOL64, atol=ATOL64,
                                       err_msg=f"grad {agent}.{name}")
            np.testing.assert_allclose(
                p.detach().numpy() - base[agent][name],
                new[agent][name] - base[agent][name], rtol=DELTA_RTOL,
                atol=DELTA_ATOL, err_msg=f"update {agent}.{name}")
