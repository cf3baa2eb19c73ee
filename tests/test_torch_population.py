"""The port's population (``parallel/population.py``) against the JAX
package's, on the CPU.

The small config of JAX tests/test_population.py:27-41, N = 3 members and
K = 4 chunked steps. JAX's ``init_population`` weights are carried to the
port member by member (``params_to_torch_state``), and the port is handed
the uniforms JAX draws from ``split_population_keys`` (tests/
jax_uniforms.py), so every member's sampled bits are JAX's. Both run in
float64 (JAX under ``enable_x64``): per-member accuracies agree to 1e-6,
losses and parameters to ~1e-9 as the single-game trajectory tests hold
them (tests/test_torch_train.py). A learning-rate scale of 0 freezes its
member; the population eval counts agree with JAX's; and member ``i`` of
the port's population is the port's single-game trainer on the same
weights and uniforms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.parallel.population import (
    init_population as jax_init_population)
from multimodalgame_tpu.parallel.population import (
    init_population_opt_states as jax_init_population_opt_states)
from multimodalgame_tpu.parallel.population import (
    make_population_eval as jax_make_population_eval)
from multimodalgame_tpu.parallel.population import (
    make_population_train_step as jax_make_population_train_step)
from multimodalgame_tpu.parallel.population import (
    member_params as jax_member_params)
from multimodalgame_tpu.parallel.population import split_population_keys
from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_multistep_train_step_indexed)
from multimodalgame_tpu_torch.ops.philox import member_uniforms
from multimodalgame_tpu_torch.parallel.population import (
    init_population, init_population_opt_states, make_population_eval,
    make_population_train_step, member_modules, member_opt_states,
    member_params, stack_members)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms

KW = dict(img_feat_dim=64, img_h_dim=16, sender_out_dim=8, rec_w_dim=8,
          rec_hidden=16, wv_dim=12, max_exchange=3, baseline_hid_dim=16,
          fixed_exchange=False, entropy_s=0.08, entropy_sen=0.01,
          entropy_rec=0.01, learning_rate=1e-3, optim_type="RMSprop")
K, B, C, N = 4, 8, 5, 3
TOP_K = 2
SCALES = [0.5, 1.0, 2.0]
RTOL, ATOL = 1e-9, 1e-12
# As tests/test_torch_train.py: a parameter whose gradient is zero but for
# rounding (y2.bias under log_softmax) moves by up to lr / eps times it.
DELTA_RTOL, DELTA_ATOL = 1e-8, 3e-11


def _inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(K, B, KW["img_feat_dim"]), rng.randint(0, C, (K, B)),
            rng.randn(C, KW["wv_dim"]))


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                  tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _member_agents(jax_params, i, dtype=torch.float64, **kw):
    mods = AgentModules(GameConfig(**{**KW, **kw})).to(dtype)
    state = {a: {k: torch.from_numpy(np.array(v)).to(dtype)
                 for k, v in sd.items()}
             for a, sd in params_to_torch_state(
                 _np(jax_member_params(jax_params, i))).items()}
    return load_torch_state(mods, state)


@functools.lru_cache(maxsize=None)
def _jax_population():
    """JAX's population chunk over K steps, float64, with its initial
    weights, per-step keys' uniforms, metrics and final weights."""
    data, target, desc = _inputs()
    with jax.enable_x64(True):
        jmods = JaxModules(JaxConfig(**KW))
        pop = _f64(jax_init_population(jmods, jax.random.PRNGKey(0), N,
                                       num_classes=C))
        pop0 = _np(pop)
        opts = jax_init_population_opt_states(jmods.cfg, pop)
        keys = split_population_keys(jax.random.PRNGKey(9), K, N)
        chunk = jax_make_population_train_step(jmods, top_k=TOP_K,
                                               batch_denom=B)
        new_pop, _, m = chunk(pop, opts, jnp.asarray(data),
                              jnp.asarray(target), jnp.asarray(desc), keys,
                              jnp.asarray(SCALES, jnp.float64))
        uniforms = [{name: torch.stack([
            jax_uniforms(jmods.cfg, keys[k, i], B, dtype=jnp.float64)[name]
            for i in range(N)]) for name in ("s", "z", "w")}
            for k in range(K)]
        return dict(pop=pop0, new_pop=_np(new_pop), uniforms=uniforms,
                    metrics={f: np.asarray(getattr(m, f))
                             for f in m._fields})


def _port_chunk(pop, scales, **kw):
    want = _jax_population()
    data, target, desc = _inputs()
    modules = AgentModules(GameConfig(**{**KW, **kw})).double()
    chunk = make_population_train_step(
        modules, TOP_K, B, uniforms=lambda s: want["uniforms"][s])
    feats = torch.from_numpy(data.reshape(K * B, -1))
    idx = np.arange(K * B).reshape(K, B)
    return chunk(pop, init_population_opt_states(modules.cfg, pop), feats,
                 torch.from_numpy(target.reshape(-1)), idx,
                 torch.from_numpy(desc), 0, lr_scale=scales)


def _carried_population():
    want = _jax_population()
    return stack_members([_member_agents(want["pop"], i) for i in range(N)])


def test_carried_population_holds_jax_members():
    want = _jax_population()
    pop = _carried_population()
    assert all(v.shape[0] == N for v in pop.values())
    for i in range(N):
        ref = params_to_torch_state(_np(jax_member_params(want["pop"], i)))
        got = member_params(pop, i)
        for agent in AGENT_NAMES:
            for name, v in ref[agent].items():
                np.testing.assert_array_equal(
                    got[f"{agent}.{name}"].numpy(), v)


def test_init_population_members_are_seeded_games():
    cfg = GameConfig(**KW)
    pop = init_population(cfg, 7, N, device="cpu")
    for i in range(N):
        one = init_params(AgentModules(cfg), seed=7 + i)
        got = member_params(pop, i)
        for k, p in one.named_parameters():
            assert torch.equal(got[k], p.detach()), k
    opts = init_population_opt_states(cfg, pop)
    assert [t.shape for t in opts["sender"]["nu"]] == [
        v.shape for k, v in pop.items() if k.startswith("sender.")]


def test_population_matches_jax():
    """K = 4 steps of N = 3 members at learning-rate scales 0.5, 1, 2:
    every member's accuracies, losses and final weights are JAX's."""
    want = _jax_population()
    pop = _carried_population()
    new_pop, new_opts, m = _port_chunk(pop, SCALES)
    assert m.accuracy.shape == (K, N)
    np.testing.assert_allclose(m.accuracy.numpy(),
                               want["metrics"]["accuracy"], atol=1e-6)
    for f in ("loss_rec", "loss_sen", "nll_loss", "loss_bas_rec",
              "loss_bas_sen"):
        np.testing.assert_allclose(getattr(m, f).numpy(), want["metrics"][f],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    for i in range(N):
        ref = params_to_torch_state(_np(jax_member_params(want["new_pop"],
                                                          i)))
        base = params_to_torch_state(_np(jax_member_params(want["pop"], i)))
        got = member_params(new_pop, i)
        for agent in AGENT_NAMES:
            for name, v in ref[agent].items():
                np.testing.assert_allclose(
                    got[f"{agent}.{name}"].numpy() - base[agent][name],
                    v - base[agent][name], rtol=DELTA_RTOL, atol=DELTA_ATOL,
                    err_msg=f"member {i} {agent}.{name}")
    assert all(len(st["nu"]) == sum(1 for k in new_pop
                                    if k.startswith(agent + "."))
               for agent, st in new_opts.items())


def test_lr_scale_zero_freezes_member():
    pop = _carried_population()
    new_pop, new_opts, _ = _port_chunk(pop, [0.0, 1.0, 2.0])
    for k, v in pop.items():
        assert torch.equal(new_pop[k][0], v[0]), k
    assert any(not torch.equal(new_pop[k][1], v[1]) for k, v in pop.items())
    # The frozen member's optimizer slots still follow its gradients, as
    # JAX's do: only the update is scaled.
    assert any(float(nu[0].abs().max()) > 0
               for nu in new_opts["sender"]["nu"])


def test_population_member_is_the_single_game_trainer():
    """Member i of the port's population against the port's own
    single-game indexed trainer, on the same weights and uniforms."""
    want = _jax_population()
    pop = _carried_population()
    new_pop, new_opts, m = _port_chunk(pop, None)
    data, target, desc = _inputs()
    for i in range(N):
        mods = _member_agents(want["pop"], i)
        chunk = make_multistep_train_step_indexed(
            mods, TOP_K, B, fast=True, device="cpu",
            uniforms=lambda s, i=i: {k: v[i] for k, v in
                                     want["uniforms"][s].items()})
        opts = init_opt_states(mods.cfg, mods)
        sm = chunk(opts, torch.from_numpy(data.reshape(K * B, -1)),
                   torch.from_numpy(target.reshape(-1)),
                   np.arange(K * B).reshape(K, B), torch.from_numpy(desc), 0)
        np.testing.assert_array_equal(sm.accuracy.numpy(),
                                      m.accuracy[:, i].numpy())
        np.testing.assert_allclose(sm.loss_rec.numpy(),
                                   m.loss_rec[:, i].numpy(), rtol=RTOL,
                                   atol=ATOL)
        got = member_params(new_pop, i)
        base = member_params(pop, i)
        for k, p in mods.named_parameters():
            np.testing.assert_allclose(
                (got[k] - base[k]).numpy(), (p.detach() - base[k]).numpy(),
                rtol=DELTA_RTOL, atol=DELTA_ATOL, err_msg=f"member {i} {k}")
        slots = member_opt_states(new_opts, i)
        for agent in AGENT_NAMES:
            for a, b in zip(slots[agent]["nu"], opts[agent]["nu"]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                           atol=1e-14)
        back = member_modules(mods.cfg, new_pop, i)
        for k, p in back.named_parameters():
            assert torch.equal(p.detach(), got[k])


@pytest.mark.parametrize("top_k", [TOP_K, C, C + 3])
def test_population_eval_counts_match_jax(top_k):
    want = _jax_population()
    data, target, desc = _inputs()
    with jax.enable_x64(True):
        jmods = JaxModules(JaxConfig(**KW))
        ev = jax_make_population_eval(jmods, top_k=top_k)
        jc = np.asarray(ev(_f64(want["pop"]), jnp.asarray(data[0]),
                           jnp.asarray(target[0]), jnp.asarray(desc),
                           jax.random.split(jax.random.PRNGKey(4), N)))
    port_ev = make_population_eval(AgentModules(GameConfig(**KW)).double(),
                                   top_k)
    got = port_ev(_carried_population(), torch.from_numpy(data[0]),
                  torch.from_numpy(target[0]), torch.from_numpy(desc))
    np.testing.assert_array_equal(got.numpy(), jc)
    if top_k >= C:
        np.testing.assert_array_equal(got.numpy(), [B] * N)


def test_member_uniforms_default_stream():
    """Without a ``uniforms`` seam each member draws its own Philox
    stream (``member_uniforms``): one chunk of the default stream equals
    the same chunk fed those draws through the seam."""
    pop = init_population(GameConfig(**KW), 0, N, device="cpu")
    data, target, desc = _inputs()
    modules = AgentModules(GameConfig(**KW))
    feats = torch.from_numpy(data.reshape(K * B, -1)).float()
    args = (feats, torch.from_numpy(target.reshape(-1)),
            np.arange(K * B).reshape(K, B)[:2],
            torch.from_numpy(desc).float(), 5)
    cfg = modules.cfg
    a = make_population_train_step(modules, TOP_K, B, seed=11)(
        pop, init_population_opt_states(cfg, pop), *args)
    b = make_population_train_step(
        modules, TOP_K, B,
        uniforms=lambda s: member_uniforms(cfg, B, 11, s, N))(
        pop, init_population_opt_states(cfg, pop), *args)
    for k in pop:
        assert torch.equal(a[0][k], b[0][k]), k
    u = member_uniforms(cfg, B, 11, 5, N)
    assert not torch.equal(u["z"][0], u["z"][1])
