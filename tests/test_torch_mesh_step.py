"""One data-parallel training step of the port, two gloo ranks on the
CPU, against JAX's ``parallel/mesh.py:make_sharded_train_step`` on a
2-device mesh (tests/conftest.py forces 8 virtual CPU devices), in
float64, as tests/test_torch_train.py holds the single-device step.

Both start from the same weights (``params_to_torch_state``); each rank
gets JAX's uniforms for the whole batch and steps on its half of the
rows. The losses, the accuracy, the whole batch's sampled bits (gathered
in rank order) and every updated weight must agree at ~1e-9. The cases:
the masked exchange (Adaptive) through the plain, fast and kernel-sampler
paths, the unmasked one (Fixed, whose advantage std is over the whole
batch), ``-flipout``, and a batch whose halves stop at very different
turns, where a rank's local std or local mask count would be far from
the batch's. Also the Philox numbering of a shard's rows and a member
block.
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
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.parallel.mesh import (
    make_mesh, make_sharded_train_step as jax_sharded_step, replicate,
    shard_batch)
from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import init_opt_states
from multimodalgame_tpu_torch.ops.philox import (STREAMS, member_uniforms,
                                                 philox4x32_10,
                                                 philox_eval_uniforms,
                                                 philox_uniforms)
from multimodalgame_tpu_torch.parallel.distributed import launch
from multimodalgame_tpu_torch.parallel.mesh import make_sharded_train_step
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms

BASE = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=10, rec_w_dim=10,
            rec_hidden=14, wv_dim=16, max_exchange=4, baseline_hid_dim=12,
            entropy_s=0.08, entropy_sen=0.01, entropy_rec=0.01,
            learning_rate=1e-3, optim_type="RMSprop")
NUM_CLASSES, BATCH, TOP_K, RANKS = 5, 8, 2, 2
LOSSES = ("loss_rec", "loss_sen", "nll_loss", "loss_binary_rec",
          "loss_binary_s", "loss_bas_rec", "loss_bas_sen")
BITS = ("sen_feats", "rec_feats", "stop_feats", "stop_masks")
# tests/test_torch_train.py's tolerances: ~1e-9 relative on the losses,
# and the weights' changes at 1e-8 / 3e-11 (y2.bias has an analytically
# zero gradient whose ~1e-16 rounding RMSprop scales by up to lr / eps).
RTOL, ATOL = 1e-9, 1e-12
DELTA_RTOL, DELTA_ATOL = 1e-8, 3e-11
# (JAX's fast argument, the port's, config overrides, key, data seed).
# The "split_stops" key makes the two halves' stop patterns differ (the
# test checks that it does).
CASES = {
    "adaptive_plain": (False, False, {}, 42, 11),
    "adaptive_fast": ("auto", True, {}, 42, 11),
    "adaptive_kernel": ("auto", "kernel", {}, 42, 11),
    "fixed": ("auto", True, {"fixed_exchange": True}, 42, 11),
    "flipout": ("auto", True, {"flipout_sen": 0.1, "flipout_rec": 0.1},
                42, 11),
    "split_stops": ("auto", True, {}, 3, 12),
}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, BASE["img_feat_dim"]),
            rng.randint(0, NUM_CLASSES, size=BATCH),
            rng.randn(NUM_CLASSES, BASE["wv_dim"]))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's sharded step on a 2-device mesh in float64: the weights
    before and after, the losses, the bits, and the uniforms it drew."""
    jax_fast, _, over, key_seed, data_seed = CASES[name]
    kw = {**BASE, "fixed_exchange": False, **over}
    with jax.enable_x64(True):
        mods = JaxModules(JaxConfig(**kw))
        params = _f64(jax_init_params(mods, jax.random.PRNGKey(0),
                                      num_classes=NUM_CLASSES))
        params_np = _np_tree(params)
        data, target, desc = _inputs(data_seed)
        key = jax.random.PRNGKey(key_seed)
        mesh = make_mesh(RANKS)
        step = jax_sharded_step(mods, top_k=TOP_K, batch_denom=BATCH,
                                mesh=mesh, fast=jax_fast)
        new_params, _, m = step(
            replicate(_f64(params_np), mesh),
            replicate(jax_init_opt_states(mods.cfg, params), mesh),
            shard_batch(jnp.asarray(data), mesh),
            shard_batch(jnp.asarray(target), mesh),
            replicate(jnp.asarray(desc), mesh), replicate(key, mesh))
        uniforms = jax_uniforms(mods.cfg, key, BATCH, dtype=jnp.float64)
        return dict(kw=kw, params=params_np,
                    new_params=_np_tree(jax.device_get(new_params)),
                    data=data, target=target, desc=desc,
                    uniforms={k: v.numpy() for k, v in uniforms.items()},
                    losses={k: float(getattr(m, k)) for k in LOSSES},
                    accuracy=float(m.accuracy),
                    ex={k: np.asarray(getattr(m.exchange, k))
                        for k in BITS + ("n_steps",)})


def port_case(mesh, case, make_step=None):
    """One rank's sharded step of a case (run in each rank's process):
    the whole batch's metrics and the updated weights, as numpy.
    ``make_step(mods, fast, uniforms)`` builds the step (default:
    ``make_sharded_train_step``)."""
    kw, params_np, fast, data, target, desc, uniforms = case
    mods = AgentModules(GameConfig(**kw)).double()
    load_torch_state(mods, {a: {k: torch.from_numpy(np.array(v, np.float64))
                                for k, v in sd.items()}
                            for a, sd in params_to_torch_state(
                                params_np).items()})
    u = {k: torch.from_numpy(v) for k, v in uniforms.items()}
    step = (make_step(mods, fast, lambda s: u) if make_step is not None
            else make_sharded_train_step(mods, TOP_K, BATCH, mesh, fast,
                                         uniforms=lambda s: u))
    opts = init_opt_states(mods.cfg, mods)
    before = mesh.calls
    m = step(opts, data, target, desc, 0)
    return dict(calls=mesh.calls - before,
                losses={k: float(getattr(m, k)) for k in LOSSES},
                accuracy=float(m.accuracy),
                ex={k: getattr(m.exchange, k).numpy()
                    for k in BITS + ("n_steps",)},
                params={a: {k: p.detach().numpy() for k, p in
                            getattr(mods, a).named_parameters()}
                        for a in AGENT_NAMES})


def port_cases(mesh, cases):
    return [port_case(mesh, c) for c in cases]


def jax_inputs(name):
    """A case's inputs for a rank (``port_case``'s ``case``), from JAX's
    run of it."""
    want = _jax_case(name)
    return (want["kw"], want["params"], CASES[name][1], want["data"],
            want["target"], want["desc"], want["uniforms"])


@pytest.fixture(scope="module")
def port_results():
    """Every case through two gloo ranks, in one launch."""
    cases = [jax_inputs(name) for name in CASES]
    ranks = launch(port_cases, ["cpu"] * RANKS, (cases,), timeout=300)
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


def check_matches_jax(name, results):
    """Each rank's step of a case (``port_case``'s dict) against JAX's:
    the bits, the losses, the accuracy and every weight's change; and the
    ranks' weights equal."""
    want = _jax_case(name)
    base = params_to_torch_state(want["params"])
    new = params_to_torch_state(want["new_params"])
    for got in results:
        for k in BITS:
            np.testing.assert_array_equal(got["ex"][k], want["ex"][k],
                                          err_msg=k)
        assert int(got["ex"]["n_steps"]) == int(want["ex"]["n_steps"])
        for k in LOSSES:
            np.testing.assert_allclose(got["losses"][k], want["losses"][k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert got["accuracy"] == want["accuracy"]
        for agent in AGENT_NAMES:
            for k, p in got["params"][agent].items():
                np.testing.assert_allclose(
                    p - base[agent][k], new[agent][k] - base[agent][k],
                    rtol=DELTA_RTOL, atol=DELTA_ATOL,
                    err_msg=f"{name} {agent}.{k}")
    # Every rank applies the same update.
    a, b = results
    for agent in AGENT_NAMES:
        for k in a["params"][agent]:
            np.testing.assert_array_equal(a["params"][agent][k],
                                          b["params"][agent][k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax(name, port_results):
    check_matches_jax(name, port_results[name])


# The collectives of one step that returns the full metrics: two for the
# statistics of each multi-turn REINFORCE loss (stop, receiver and sender
# bits; a fixed exchange has no stop loss), one for the mask counts of each
# masked baseline loss, the gradient sum, and the gathers of the whole
# batch's predictions and conversation record.
STEP_CALLS = {name: 2 * 3 + 2 + 1 + 2 for name in CASES}
STEP_CALLS["fixed"] = 2 * 2 + 1 + 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_collectives(name, port_results):
    for got in port_results[name]:
        assert got["calls"] == STEP_CALLS[name], got["calls"]


def test_split_stops_case_has_halves_that_differ():
    """The halves of "split_stops" mask different rows at every turn but
    the first, so their local counts and stds are not the batch's."""
    masks = _jax_case("split_stops")["ex"]["stop_masks"][1:-1, :, 0]
    halves = masks[:, :BATCH // 2].sum(1), masks[:, BATCH // 2:].sum(1)
    assert (halves[0] != halves[1]).all(), halves


def test_philox_rows_of_a_shard_are_the_whole_draws():
    cfg = GameConfig(**{**BASE, "flipout_sen": 0.1, "flipout_rec": 0.1,
                        "flipout_dev": True})
    whole = philox_uniforms(cfg, 64, 9, 4)
    part = philox_uniforms(cfg, 32, 9, 4, row_base=32)
    for k in whole:
        assert torch.equal(part[k], whole[k][:, 32:]), k
    ev_whole = philox_eval_uniforms(cfg, 64, 9, 4, 3)
    ev_part = philox_eval_uniforms(cfg, 32, 9, 4, 3, row_base=32)
    for k in ev_whole:
        assert torch.equal(ev_part[k], ev_whole[k][:, 32:]), k
    # Against the generator itself: counter (c // 4, 32 + r, t, stream).
    t, r, c = 2, 5, 7
    words = philox4x32_10((c // 4, 32 + r, t, STREAMS["z"]), (9, 4))
    assert float(part["z"][t, r, c]) == (int(words[c % 4]) >> 8) * 2.0 ** -24


def test_philox_row_and_member_bases_of_zero_are_the_plain_draws():
    cfg = GameConfig(**BASE)
    for k, v in philox_uniforms(cfg, 6, 1, 2).items():
        assert torch.equal(v, philox_uniforms(cfg, 6, 1, 2, row_base=0)[k])
    plain = member_uniforms(cfg, 6, 1, 2, 3)
    for k, v in member_uniforms(cfg, 6, 1, 2, 3, member_base=0).items():
        assert torch.equal(v, plain[k])


def test_member_block_draws_are_the_populations():
    cfg = GameConfig(**{**BASE, "flipout_sen": 0.1, "flipout_rec": 0.1,
                        "flipout_dev": True})
    for slot in (None, 2):
        whole = member_uniforms(cfg, 6, 1, 2, 4, slot=slot)
        block = member_uniforms(cfg, 6, 1, 2, 2, slot=slot, member_base=2)
        for k in whole:
            assert torch.equal(block[k], whole[k][2:]), (slot, k)
