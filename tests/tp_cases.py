"""The tensor-parallel cases shared by tests/test_torch_tensor_parallel.py
and tests/test_torch_tensor_parallel_grid.py: JAX's two steps of each
case in float64 on ``make_mesh_2d``, and the port's on its gloo ranks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.parallel.mesh import (
    make_sharded_train_step as jax_sharded_step, replicate, shard_batch)
from multimodalgame_tpu.parallel.tensor import (
    class_axis_placer as jax_class_axis_placer,
    init_tp_opt_states as jax_init_tp_opt_states,
    make_mesh_2d as jax_mesh_2d, shard_params_tp as jax_shard_params_tp)
from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    make_multistep_train_step_indexed, make_train_step)
from multimodalgame_tpu_torch.parallel.distributed import launch
from multimodalgame_tpu_torch.parallel.tensor import (TensorParallel,
                                                      init_tp_opt_states,
                                                      make_mesh_2d)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms

# JAX tests/test_tensor_parallel.py's small game.
BASE = dict(img_feat_dim=32, img_h_dim=16, sender_out_dim=8, rec_w_dim=8,
            rec_hidden=16, wv_dim=12, max_exchange=3, baseline_hid_dim=16,
            fixed_exchange=False, entropy_s=0.08, entropy_sen=0.01,
            entropy_rec=0.01)
BATCH, TOP_K, STEPS = 16, 2, 2
# tests/test_torch_train.py's tolerances: ~1e-9 relative on the losses,
# the weights' changes at 1e-8 / 3e-11.
RTOL, ATOL = 1e-9, 1e-12
DELTA_RTOL, DELTA_ATOL = 1e-8, 3e-11
# name: (mesh (data, model), optimizer, class-sharded desc, config
# overrides, classes).
CASES = {
    "rmsprop_1x2": ((1, 2), "RMSprop", False, {}, 8),
    "adam_2x2": ((2, 2), "Adam", False, {}, 8),
    "class_rmsprop_1x2": ((1, 2), "RMSprop", True, {}, 8),
    "class_adam_2x2": ((2, 2), "Adam", True, {}, 8),
    "mou_2x2": ((2, 2), "RMSprop", True, {"sender_mix": "mou"}, 8),
    "ragged_hidden_1x2": ((1, 2), "RMSprop", True, {"img_h_dim": 15}, 8),
    "ragged_classes_2x2": ((2, 2), "Adam", True, {}, 5),
}
# Collectives a fast-path step makes on each axis (make_multistep_...:
# no full-metrics gathers). Model axis, forward: the row-parallel sum of
# the sender and of both baselines and the gather of h_x for the sender
# baseline (4); backward: the f of the code input (1); then the clip norm
# and the sync (2) — 7. A class-sharded head adds the class scores'
# gather, the f of its h_z and the partial head gradients' sum (3): 10.
# Data axis: the losses' 8 batch statistics and the gradient sum (9), none
# with one data shard.
MODEL_CALLS = {False: 7, True: 10}
DATA_CALLS = {1: 0, 2: 9}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(num_classes):
    rng = np.random.RandomState(0)
    return (rng.randn(BATCH, BASE["img_feat_dim"]),
            rng.randint(0, num_classes, size=BATCH),
            rng.randn(num_classes, BASE["wv_dim"]))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's tensor-parallel steps in float64: the weights before and
    after, the last step's losses and accuracy, the uniforms it drew."""
    shape, optim, class_sharded, over, num_classes = CASES[name]
    kw = {**BASE, "optim_type": optim, **over}
    with jax.enable_x64(True):
        mods = JaxModules(JaxConfig(**kw))
        params = _f64(jax_init_params(mods, jax.random.PRNGKey(0),
                                      num_classes=num_classes))
        params_np = _np_tree(params)
        data, target, desc = _inputs(num_classes)
        mesh = jax_mesh_2d(*shape)
        p = jax_shard_params_tp(params, mesh)
        o = jax_init_tp_opt_states(mods.cfg, p, mesh)
        step = jax_sharded_step(mods, top_k=TOP_K, batch_denom=BATCH,
                                mesh=mesh)
        desc_j = (jax_class_axis_placer(mesh)(jnp.asarray(desc))
                  if class_sharded else replicate(jnp.asarray(desc), mesh))
        keys = [jax.random.PRNGKey(7 + i) for i in range(STEPS)]
        for key in keys:
            p, o, m = step(p, o, shard_batch(jnp.asarray(data), mesh),
                           shard_batch(jnp.asarray(target), mesh), desc_j,
                           replicate(key, mesh))
        uniforms = [{k: v.numpy() for k, v in jax_uniforms(
            mods.cfg, key, BATCH, dtype=jnp.float64).items()}
            for key in keys]
        return dict(kw=kw, shape=shape, class_sharded=class_sharded,
                    params=params_np, new_params=_np_tree(jax.device_get(p)),
                    data=data, target=target, desc=desc, uniforms=uniforms,
                    loss_rec=float(m.loss_rec), loss_sen=float(m.loss_sen),
                    accuracy=float(m.accuracy))


def _port_modules(kw, params_np):
    mods = AgentModules(GameConfig(**kw)).double()
    load_torch_state(mods, {a: {k: torch.from_numpy(np.array(v, np.float64))
                                for k, v in sd.items()}
                            for a, sd in params_to_torch_state(
                                params_np).items()})
    return mods


def port_case(mesh, case):
    """One rank's two tensor-parallel steps of a case: the last step's
    metrics, the whole weights and the collectives of the second step."""
    (kw, shape, class_sharded, params_np, data, target, desc,
     uniforms) = case
    mods = _port_modules(kw, params_np)
    tp = TensorParallel(mesh, mods, class_sharded=class_sharded,
                        num_classes=len(desc))
    u = [{k: torch.from_numpy(v) for k, v in d.items()} for d in uniforms]
    step = make_train_step(mods, TOP_K, BATCH, "auto", uniforms=u.__getitem__,
                           mesh=mesh, tp=tp)
    opts = init_tp_opt_states(mods.cfg, tp)
    for s in range(STEPS):
        m = step(opts, data, target, desc, s)
    params = params_np_of(mods)
    # One step of the multistep trainer (no full-metrics gathers), its
    # collectives counted on each axis.
    chunk = make_multistep_train_step_indexed(
        mods, TOP_K, BATCH, "auto", uniforms=u.__getitem__, mesh=mesh,
        tp=tp)
    before = (mesh.calls, mesh.model.calls)
    idx = np.arange(BATCH)[None]
    chunk(opts, torch.from_numpy(data), torch.from_numpy(target), idx,
          torch.from_numpy(desc), 0)
    return dict(loss_rec=float(m.loss_rec), loss_sen=float(m.loss_sen),
                accuracy=float(m.accuracy),
                data_calls=mesh.calls - before[0],
                model_calls=mesh.model.calls - before[1],
                slot_shapes={n: tuple(x.shape) for n, x in zip(
                    [n for n, _ in tp.shard.sender.named_parameters()],
                    opts["sender"]["nu"])},
                params=params)


def params_np_of(mods):
    return {a: {k: p.detach().numpy().copy()
                for k, p in getattr(mods, a).named_parameters()}
            for a in AGENT_NAMES}


def port_cases(mesh, n_model, cases):
    grid = make_mesh_2d(mesh, n_model)
    return [port_case(grid, c) for c in cases]



def port_results_for(shape):
    """Every case of mesh ``shape`` through its gloo ranks, one launch."""
    names = [n for n, c in CASES.items() if c[0] == shape]
    cases = []
    for name in names:
        w = _jax_case(name)
        cases.append((w["kw"], shape, w["class_sharded"], w["params"],
                      w["data"], w["target"], w["desc"], w["uniforms"]))
    ranks = launch(port_cases, ["cpu"] * (shape[0] * shape[1]),
                   (shape[1], cases), timeout=300)
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


def check_steps_match_jax(name, results):
    want = _jax_case(name)
    base = params_to_torch_state(want["params"])
    new = params_to_torch_state(want["new_params"])
    for got in results:
        for k in ("loss_rec", "loss_sen"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        assert got["accuracy"] == want["accuracy"]
        for agent, sd in got["params"].items():
            for k, p in sd.items():
                np.testing.assert_allclose(
                    p - base[agent][k], new[agent][k] - base[agent][k],
                    rtol=DELTA_RTOL, atol=DELTA_ATOL,
                    err_msg=f"{name} {agent}.{k}")
    # Every rank holds the same whole weights.
    first = results[0]["params"]
    for got in results[1:]:
        for agent, sd in got["params"].items():
            for k, p in sd.items():
                np.testing.assert_array_equal(p, first[agent][k])


def check_collectives(name, results):
    shape, _, class_sharded, over, num_classes = CASES[name]
    heads = class_sharded and num_classes % shape[1] == 0
    want_model = MODEL_CALLS[heads]
    if over.get("sender_mix") == "mou":
        # The whole h_x and h_w for the mix before the row-parallel block,
        # and its f: 3 more.
        want_model += 3
    if over.get("img_h_dim", 16) % shape[1]:
        # The sender replicated: no row sum, no h_x gather, no f.
        want_model -= 3
    for got in results:
        assert got["model_calls"] == want_model, got["model_calls"]
        assert got["data_calls"] == DATA_CALLS[shape[0]], got["data_calls"]
