"""The JAX exchange's uniforms, replayed for the PyTorch port's tests.

``multimodalgame_tpu/game/exchange.py:155-180`` draws every turn's
uniforms from ``split(key, T * 5)``: per turn, key 0 for the message
``z``, 1 for its flipout ``fz``, 2 for the stop bit ``s``, 3 for the
query ``w`` and 4 for its flipout ``fw``. Handing the same numbers to the
port makes its sampled bits equal JAX's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def jax_uniforms(cfg, key, batch, train=True, dtype=jnp.float32):
    """``{s, z, w[, fz, fw]}`` as torch tensors ``(T, batch, dim)``, as
    the JAX exchange draws them for ``key`` (``dtype`` is its
    ``promote_types(float32, data dtype)``)."""
    T = cfg.max_exchange
    step_keys = jax.random.split(key, T * 5).reshape((T, 5) + key.shape)

    def draw(column, dim):
        u = jax.vmap(lambda k: jax.random.uniform(k, (batch, dim),
                                                  dtype=dtype))(
            step_keys[:, column])
        return torch.from_numpy(np.array(u))

    out = {}
    if train:
        out["s"] = draw(2, cfg.rec_s_dim)
        if cfg.use_binary:
            out["z"] = draw(0, cfg.sender_out_dim)
            out["w"] = draw(3, cfg.rec_w_dim)
    if cfg.use_binary and (train or cfg.flipout_dev):
        if cfg.flipout_sen is not None:
            out["fz"] = draw(1, cfg.sender_out_dim)
        if cfg.flipout_rec is not None:
            out["fw"] = draw(4, cfg.rec_w_dim)
    return out


def jax_step_provider(cfg, base_key, batch, dtype=jnp.float32):
    """``step -> uniforms`` replaying ``fold_in(base_key, step)``, the
    per-step key of the JAX indexed trainers (train.py:450-451, 504-506).
    Draws eagerly; call it where the JAX dtype (x64) is set."""
    cache = {}

    def provider(step):
        if step not in cache:
            cache[step] = jax_uniforms(
                cfg, jax.random.fold_in(base_key, step), batch, dtype=dtype)
        return cache[step]

    return provider


def jax_split_chain_provider(cfg, base_key, batch, spends_extra_key,
                             dtype=jnp.float32):
    """``step -> uniforms`` replaying the JAX per-batch loop's key chain
    (train.py:446, 484, 529): each step draws from ``sub`` of ``key, sub =
    split(key)``, and a step for which ``spends_extra_key(step)`` holds
    (a log window with an eval dump) splits once more. Steps are drawn in
    order from 0."""
    state = {"key": base_key, "next": 0}
    cache = {}

    def provider(step):
        while state["next"] <= step:
            s = state["next"]
            key, sub = jax.random.split(state["key"])
            cache[s] = jax_uniforms(cfg, sub, batch, dtype=dtype)
            if spends_extra_key(s):
                key, _ = jax.random.split(key)
            state["key"], state["next"] = key, s + 1
        return cache[step]

    return provider
