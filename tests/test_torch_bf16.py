"""``-compute_dtype bfloat16`` in the port against the JAX package, on the
CPU.

JAX runs the conversation on bfloat16 casts of its float32 parameters and
inputs and the loss algebra in float32 (game/train.py:94-120,
fast_train.py:87-93, 170-171); the port does the same through
``game/train.py:in_compute_dtype``. From the same float32 weights
(``params_to_torch_state``) and JAX's float32 uniforms
(tests/jax_uniforms.py) the sampled bits are equal, except in rows where
a probability lies within bfloat16's step of its uniform: XLA and PyTorch
round bfloat16 chains differently, so such a bit may fall on the other
side, and the row's later turns follow it. Those rows are counted
(``compare_outputs``' tie rule with ``BF16_TIE``), not compared. Every
probability and class score of the port's record is a bfloat16 value, so
the conversation did run in bfloat16. The total
and NLL losses are held at rel 0.05, as JAX tests/test_bf16.py:50-76
holds bfloat16 against float32. Gradients, updated parameters and
optimizer slots stay float32, and the train kernel, float32-only as
JAX's Pallas sampler is, refuses bfloat16: the driver samples a bfloat16
game on the plain exchange.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.fast_train import (
    compute_losses_fast as jax_compute_losses_fast)
from multimodalgame_tpu.game.train import compute_losses as jax_compute_losses
from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.fast_train import compute_losses_fast
from multimodalgame_tpu_torch.game.train import (compute_losses,
                                                 init_opt_states,
                                                 make_train_step)
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    compare_outputs, supports_config, train_kernel_supports)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms

# The small config of JAX tests/test_population.py:27-41.
BASE = dict(img_feat_dim=64, img_h_dim=16, sender_out_dim=8, rec_w_dim=8,
            rec_hidden=16, wv_dim=12, max_exchange=3, baseline_hid_dim=16,
            fixed_exchange=False, entropy_s=0.08, entropy_sen=0.01,
            entropy_rec=0.01, learning_rate=1e-3, optim_type="RMSprop",
            compute_dtype="bfloat16")
B, C, TOP_K = 16, 5, 2
# bfloat16 keeps 8 significant bits: a probability in [0.5, 1) moves in
# steps of 2**-8. A bit whose |u - p| is within two steps may differ.
BF16_TIE = 2.0 ** -7
# Probabilities and class scores of the turns before a row's first
# differing bit: two bfloat16 steps of the values (|p| < 1, |y| < 2; one
# step is seen).
BF16_PROB_ATOL, BF16_Y_ATOL = 2.0 ** -7, 2.0 ** -6
LOSS_REL = 0.05


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, BASE["img_feat_dim"]).astype(np.float32),
            rng.randint(0, C, size=B),
            rng.randn(C, BASE["wv_dim"]).astype(np.float32))


def _port_agents(params_np, **kw):
    mods = AgentModules(GameConfig(**{**BASE, **kw}))
    state = {a: {k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in sd.items()}
             for a, sd in params_to_torch_state(params_np).items()}
    return load_torch_state(mods, state)


def _as_record(ex):
    """A JAX conversation record as torch tensors, for compare_outputs."""
    return types.SimpleNamespace(**{
        k: torch.from_numpy(np.array(getattr(ex, k), np.float32))
        for k in ("stop_feats", "stop_probs", "sen_feats", "sen_probs",
                  "rec_feats", "rec_probs", "y")})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fast"])
def test_bf16_losses_match_jax(fast, seed):
    cfg = JaxConfig(**BASE)
    jmods = JaxModules(cfg)
    params = jax_init_params(jmods, jax.random.PRNGKey(seed),
                             num_classes=C)
    data, target, desc = _inputs(7 + seed)
    key = jax.random.PRNGKey(3 + seed)
    args = (jnp.asarray(data), jnp.asarray(target), jnp.asarray(desc), key)
    if fast:
        total, m = jax_compute_losses_fast(jmods, params, *args, TOP_K, B)
    else:
        total, m = jax_compute_losses(jmods, params, *args, None, None, None,
                                      TOP_K, B)
    uniforms = jax_uniforms(cfg, key, B, dtype=jnp.float32)

    mods = _port_agents(jax.tree_util.tree_map(np.asarray, params))
    t_args = (torch.from_numpy(data), torch.from_numpy(target),
              torch.from_numpy(desc))
    if fast:
        got_total, got = compute_losses_fast(mods, *t_args, TOP_K, B,
                                             uniforms=uniforms)
    else:
        got_total, got = compute_losses(mods, *t_args, TOP_K, B, uniforms)
    assert got_total.dtype == torch.float32
    assert got.exchange.sen_probs.dtype == torch.float32
    # The conversation ran in bfloat16: every probability and class score
    # is a bfloat16 value cast back (a float32 conversation would have
    # bits below bfloat16's 8).
    for name in ("stop_probs", "sen_probs", "rec_probs", "y"):
        x = getattr(got.exchange, name).detach()
        assert torch.equal(x.to(torch.bfloat16).float(), x), name

    rep = compare_outputs(mods.cfg, got.exchange, _as_record(m.exchange),
                          tie=BF16_TIE, prob_atol=BF16_PROB_ATOL,
                          y_atol=BF16_Y_ATOL, uniforms=uniforms)
    assert rep["ok"], rep
    assert rep["tie_rows"] <= B // 4, rep
    assert float(got_total.detach()) == pytest.approx(float(total),
                                                      rel=LOSS_REL)
    assert float(got.nll_loss.detach()) == pytest.approx(
        float(m.nll_loss), rel=LOSS_REL)


def test_bf16_step_keeps_float32_parameters_gradients_and_slots():
    cfg = JaxConfig(**BASE)
    params = jax_init_params(JaxModules(cfg), jax.random.PRNGKey(0),
                             num_classes=C)
    mods = _port_agents(jax.tree_util.tree_map(np.asarray, params))
    before = {k: v.clone() for k, v in mods.state_dict().items()}
    step = make_train_step(mods, TOP_K, B, device="cpu")
    opts = init_opt_states(mods.cfg, mods)
    data, target, desc = _inputs(4)
    m = step(opts, data, target, desc, 0)
    assert np.isfinite(float(m.loss_rec)) and np.isfinite(float(m.loss_sen))
    for name, p in mods.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    assert any(not torch.equal(v, before[k])
               for k, v in mods.state_dict().items())
    for agent, st in opts.items():
        for nu in st["nu"]:
            assert nu.dtype == torch.float32, agent


def test_bf16_refuses_the_kernel_sampler():
    cfg = GameConfig(**BASE)
    assert supports_config(cfg) and not train_kernel_supports(cfg, B, C)
    assert train_kernel_supports(GameConfig(**{**BASE,
                                               "compute_dtype": "float32"}),
                                 B, C)
    mods = AgentModules(cfg)
    with pytest.raises(ValueError, match="float32"):
        make_train_step(mods, TOP_K, B, fast="kernel", device="cpu")
    data, target, desc = (torch.from_numpy(x) for x in _inputs(5))
    with pytest.raises(ValueError, match="float32-only"):
        compute_losses_fast(mods, data, target, desc, TOP_K, B,
                            sampler="kernel", seed=0, step=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_driver_samples_bf16_on_the_plain_exchange(dtype, synthetic_dataset,
                                                   tmp_path, monkeypatch):
    """``train.run`` picks the kernel sampler for a float32 game and the
    plain one for a bfloat16 game; the eval conversations of both (the
    log window's dump, the dev sweep) stay float32 on the eval kernel's
    path."""
    import multimodalgame_tpu_torch.game.fast_train as fast_train
    import multimodalgame_tpu_torch.game.train as game_train
    from multimodalgame_tpu_torch.train import run
    from tests.port_runs import port_flags, small_argv

    calls = {"train": 0, "eval": 0}
    real_train = fast_train.fused_train_forward
    real_eval = game_train.fused_eval_exchange

    def train_spy(*a, **k):
        calls["train"] += 1
        return real_train(*a, **k)

    def eval_spy(cfg, params, data, *a, **k):
        assert data.dtype == torch.float32
        calls["eval"] += 1
        return real_eval(cfg, params, data, *a, **k)

    monkeypatch.setattr(fast_train, "fused_train_forward", train_spy)
    monkeypatch.setattr(game_train, "fused_eval_exchange", eval_spy)
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, dtype,
                                  ["-compute_dtype", dtype]))
    out = run(flags, max_steps=5, device="cpu")
    assert out["step"] == 5
    assert all(np.isfinite(out["batch_accuracy"]))
    assert calls["train"] == (5 if dtype == "float32" else 0)
    # -log_interval 4, -log_dev 6, 5 steps: the dumps of the windows at 0
    # and 4, and the dev sweep at 0 (24 examples in batches of 8).
    assert calls["eval"] == 2 + 3
    for p in out["modules"].parameters():
        assert p.dtype == torch.float32
