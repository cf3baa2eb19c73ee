"""The port's staged K-step trainer and flat per-agent carry against the
JAX package's, on the CPU.

``make_multistep_train_step`` at K = 3 against JAX's (train.py:352-409)
for the Adaptive and Fixed presets, RMSprop and Adam, with JAX's carry
per leaf and flat: both in float64 from the same weights, the port (whose
every step carries each agent flat) handed the uniforms of JAX's
per-step keys (tests/jax_uniforms.py), losses at ~1e-9 and every
weight's change at tests/test_torch_train.py's tolerances. Then the port
against itself: the staged chunk equals the indexed one given ``idx =
arange`` bit for bit; the flat update equals the per-leaf rule
(``optimizer_update``) but for the clip's order of summation; a chunk, a
single step and a chunk on the same agents equal one chunk bit for bit
and leave the weights and slots views of the buffers the first laid out,
and the eval conversation sees the flat updates; a ``.pt`` saved and
reloaded mid-run reproduces the run; and the flat carry on a two-rank
gloo mesh and a 1 x 2 grid against one device.
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
from multimodalgame_tpu.game.train import (
    make_multistep_train_step as jax_staged)
from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    _flat_view, apply_flat_updates, flat_buffers, flat_order,
    init_opt_states, make_eval_exchange, make_multistep_train_step,
    make_multistep_train_step_indexed, make_train_step_indexed,
    optimizer_update)
from multimodalgame_tpu_torch.ops import cuda_exchange
from multimodalgame_tpu_torch.parallel.distributed import launch
from multimodalgame_tpu_torch.parallel.tensor import (TensorParallel,
                                                      init_tp_opt_states,
                                                      make_mesh_2d)
from multimodalgame_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_uniforms
from tests.test_torch_train import (ATOL, BASE, BATCH, DELTA_ATOL,
                                    DELTA_RTOL, NUM_CLASSES, OPTIMS, PRESETS,
                                    RTOL, TOP_K, _f64, _np_tree,
                                    _port_agents)
from tests.tp_cases import params_np_of

K = 3
METRICS = ("loss_rec", "loss_sen", "nll_loss", "loss_bas_rec",
           "loss_bas_sen")


def _stacks(seed=11, k=K):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, BATCH, BASE["img_feat_dim"]),
            rng.randint(0, NUM_CLASSES, size=(k, BATCH)),
            rng.randn(NUM_CLASSES, BASE["wv_dim"]))


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_chunk(preset, optim, flat):
    """JAX's staged chunk of K steps in float64: the weights before and
    after, the per-step metrics and the uniforms of its per-step keys."""
    kw = {**BASE, **PRESETS[preset], "optim_type": optim}
    data, target, desc = _stacks()
    with jax.enable_x64(True):
        mods = JaxModules(JaxConfig(**kw))
        params = _f64(jax_init_params(mods, jax.random.PRNGKey(0),
                                      num_classes=NUM_CLASSES))
        params_np = _np_tree(params)
        keys = jax.random.split(jax.random.PRNGKey(42), K)
        chunk = jax_staged(mods, top_k=TOP_K, batch_denom=BATCH,
                           fast="auto", flat=flat)
        new_params, _, m = chunk(_f64(params_np),
                                 jax_init_opt_states(mods.cfg, params),
                                 jnp.asarray(data), jnp.asarray(target),
                                 jnp.asarray(desc), keys)
        uniforms = [jax_uniforms(mods.cfg, keys[i], BATCH,
                                 dtype=jnp.float64) for i in range(K)]
        return dict(kw=kw, params=params_np, new_params=_np_tree(new_params),
                    uniforms=uniforms,
                    metrics={f: np.asarray(getattr(m, f))
                             for f in METRICS + ("accuracy",)})


def _assert_deltas(got: dict, want_np, base_np, what):
    """``got`` (``{agent: {name: array}}``) moved from ``base_np`` as
    ``want_np`` did, at the trajectory tolerances."""
    want = params_to_torch_state(want_np)
    base = params_to_torch_state(base_np)
    for agent in AGENT_NAMES:
        for name, p in got[agent].items():
            np.testing.assert_allclose(
                p - base[agent][name], want[agent][name] - base[agent][name],
                rtol=DELTA_RTOL, atol=DELTA_ATOL,
                err_msg=f"{what} {agent}.{name}")


def _assert_same_run(a: dict, b: dict, what):
    """Two of the port's runs (``params_np_of`` and metrics) within the
    trajectory tolerances of each other."""
    for f in METRICS:
        np.testing.assert_allclose(a["metrics"][f], b["metrics"][f],
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} {f}")
    np.testing.assert_array_equal(a["metrics"]["accuracy"],
                                  b["metrics"]["accuracy"])
    for agent, sd in a["params"].items():
        for k, p in sd.items():
            base = a["start"][agent][k]
            np.testing.assert_allclose(
                p - base, b["params"][agent][k] - base, rtol=DELTA_RTOL,
                atol=DELTA_ATOL, err_msg=f"{what} {agent}.{k}")


def _is_flat(mods, opts) -> bool:
    """Every trained agent's parameters and slots lie back to back in one
    buffer each."""
    for agent in AGENT_NAMES:
        params = list(getattr(mods, agent).parameters())
        order = flat_order(params)
        if _flat_view(params, order) is None:
            return False
        for slot in ("mu", "nu"):
            if slot in opts[agent] and _flat_view(opts[agent][slot],
                                                  order) is None:
                return False
    return True


def _metrics_np(sm):
    return {f: getattr(sm, f).numpy() for f in METRICS + ("accuracy",)}


@pytest.mark.parametrize("jax_flat", [False, True], ids=["leaf", "flat"])
@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_staged_chunk_matches_jax(preset, optim, jax_flat):
    want = _jax_chunk(preset, optim, jax_flat)
    data, target, desc = _stacks()
    mods = _port_agents(want["kw"], want["params"])
    chunk = make_multistep_train_step(
        mods, TOP_K, BATCH, fast="kernel",
        uniforms=lambda s: want["uniforms"][s], device="cpu")
    opts = init_opt_states(mods.cfg, mods)
    sm = chunk(opts, *_torch(data, target, desc))
    assert sm.loss_rec.shape == (K,)
    for f in METRICS:
        np.testing.assert_allclose(getattr(sm, f).numpy(),
                                   want["metrics"][f], rtol=RTOL, atol=ATOL,
                                   err_msg=f)
    np.testing.assert_allclose(sm.accuracy.numpy(),
                               want["metrics"]["accuracy"], atol=1e-12)
    _assert_deltas(params_np_of(mods), want["new_params"], want["params"],
                   "staged")
    assert _is_flat(mods, opts)


@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
def test_staged_chunk_equals_indexed_chunk(optim):
    """The staged stacks ``data[i]`` against the indexed chunk over the
    same rows staged as a set and ``idx = arange``: bit for bit, on the
    Philox draws of the kernel sampler."""
    data, target, desc = (torch.from_numpy(a) for a in _stacks(3, k=4))
    runs = []
    for staged in (True, False):
        cfg = GameConfig(**{**BASE, "optim_type": optim})
        mods = init_params(AgentModules(cfg), seed=1).double()
        opts = init_opt_states(cfg, mods)
        kw = dict(fast="kernel", seed=9, device="cpu")
        if staged:
            sm = make_multistep_train_step(mods, TOP_K, BATCH, **kw)(
                opts, data, target, desc, 5)
        else:
            idx = np.arange(4 * BATCH).reshape(4, BATCH)
            sm = make_multistep_train_step_indexed(mods, TOP_K, BATCH, **kw)(
                opts, data.reshape(4 * BATCH, -1), target.reshape(-1), idx,
                desc, 5)
        runs.append((sm, mods, opts))
    (a, ma, oa), (b, mb, ob) = runs
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for (k, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), k
    for agent in AGENT_NAMES:
        for x, y in zip(oa[agent]["nu"], ob[agent]["nu"]):
            assert torch.equal(x, y), agent


@pytest.mark.parametrize("optim", OPTIMS)
def test_flat_update_matches_per_leaf_rule(optim):
    """Three updates of one agent on its flat carry against the per-leaf
    rule (``optimizer_update`` leaf by leaf) from the same gradients,
    large enough that the clip scales them: equal but for the clip's
    order of summation; the parameters and slots stay views, and each
    update bumps the parameters' versions."""
    cfg = GameConfig(**{**BASE, "optim_type": optim})
    mods = init_params(AgentModules(cfg), seed=7).double()
    params = list(mods.sender.parameters())
    leaf_params = [p.detach().clone() for p in params]
    opts = init_opt_states(cfg, mods)
    leaf_state = {k: [t.clone() for t in v] if isinstance(v, list)
                  else v.clone() for k, v in opts["sender"].items()}
    rng = np.random.RandomState(3)
    order = flat_order(params)
    for _ in range(3):
        grads = [torch.from_numpy(3 * rng.randn(*p.shape)) for p in params]
        flats = flat_buffers(params, opts["sender"], order)
        versions = [p._version for p in params]
        apply_flat_updates(cfg, ["sender"], {"sender": flats},
                           {"sender": torch.cat([g.reshape(-1)
                                                 for g in grads])},
                           opts, {"sender": params})
        assert all(p._version > v for p, v in zip(params, versions))
        ups, leaf_state = optimizer_update(cfg, grads, leaf_state)
        leaf_params = [p - cfg.learning_rate * u
                       for p, u in zip(leaf_params, ups)]
    assert _flat_view(params, order) is not None
    for (k, p), q in zip(mods.sender.named_parameters(), leaf_params):
        np.testing.assert_allclose(p.detach().numpy(), q.numpy(),
                                   rtol=1e-12, atol=1e-15, err_msg=k)
    assert opts["sender"].get("count") == leaf_state.get("count")
    for slot in ("mu", "nu"):
        if slot in leaf_state:
            assert _flat_view(opts["sender"][slot], order) is not None
        for x, y in zip(opts["sender"].get(slot, []),
                        leaf_state.get(slot, [])):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                       atol=1e-15, err_msg=slot)


def _set(seed=6, n=24):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(n, BASE["img_feat_dim"])),
            torch.from_numpy(rng.randint(0, NUM_CLASSES, n)),
            torch.from_numpy(rng.randn(NUM_CLASSES, BASE["wv_dim"])),
            np.stack([rng.permutation(n)[:BATCH] for _ in range(5)]))


def test_chunk_step_chunk_keeps_the_views():
    """A chunk, a single step and a chunk on the same agents equal one
    chunk of the same five steps bit for bit, and leave the weights and
    slots views of the buffers the first chunk laid out (nothing is
    packed anew)."""
    feats, targets, desc, idx = _set()
    cfg = GameConfig(**{**BASE, "optim_type": "Adam"})
    kw = dict(fast="kernel", seed=2, device="cpu")
    runs = []
    for split in (True, False):
        mods = init_params(AgentModules(cfg), seed=4).double()
        chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH, **kw)
        opts = init_opt_states(cfg, mods)
        if not split:
            runs.append((mods, opts, chunk(opts, feats, targets, idx, desc,
                                           0).loss_rec))
            continue
        one = make_train_step_indexed(mods, TOP_K, BATCH, **kw)
        a = chunk(opts, feats, targets, idx[:2], desc, 0)
        ptrs = [p.data_ptr() for p in mods.parameters()] + [
            t.data_ptr() for st in opts.values() for s in ("mu", "nu")
            for t in st[s]]
        m = one(opts, feats, targets, idx[2], desc, 2)
        b = chunk(opts, feats, targets, idx[3:], desc, 3)
        assert _is_flat(mods, opts)
        assert ptrs == [p.data_ptr() for p in mods.parameters()] + [
            t.data_ptr() for st in opts.values() for s in ("mu", "nu")
            for t in st[s]]
        runs.append((mods, opts, torch.cat([a.loss_rec, m.loss_rec[None],
                                            b.loss_rec])))
    (ms, os_, ls), (mc, oc, lc) = runs
    assert torch.equal(ls, lc)
    for (k, p), q in zip(ms.named_parameters(), mc.parameters()):
        assert torch.equal(p, q), k
    for agent in AGENT_NAMES:
        assert os_[agent]["count"] == oc[agent]["count"] == 5
        for slot in ("mu", "nu"):
            for x, y in zip(os_[agent][slot], oc[agent][slot]):
                assert torch.equal(x, y), (agent, slot)


def test_eval_exchange_sees_flat_updates():
    """The eval conversation caches the kernel's packed weights by the
    parameters' versions; a flat update, made through the buffer, must
    still be seen."""
    feats, targets, desc, idx = _set()
    mods = init_params(AgentModules(GameConfig(**BASE)), seed=5)
    chunk = make_multistep_train_step_indexed(
        mods, TOP_K, BATCH, fast="kernel", device="cpu")
    opts = init_opt_states(mods.cfg, mods)
    run = make_eval_exchange(mods)
    data = feats[:BATCH].float()
    desc = desc.float()
    chunk(opts, feats.float(), targets, idx[:1], desc, 0)
    before = run(data, desc).y.clone()
    chunk(opts, feats.float(), targets, idx[1:], desc, 1)
    after = run(data, desc).y
    fresh = make_eval_exchange(mods)(data, desc).y
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh)


def test_flat_resume_reproduces_the_run(tmp_path):
    """Two flat chunks of 2 and 3 steps against the same with a ``.pt``
    saved after the first and loaded back, into the same (flat) agents
    and into new ones: bit for bit, the views kept where loaded in
    place."""
    feats, targets, desc, idx = (t.float() if torch.is_tensor(t)
                                 and t.is_floating_point() else t
                                 for t in _set(8))
    cfg = GameConfig(**{**BASE, "optim_type": "Adam"})

    def run(reload):
        mods = init_params(AgentModules(cfg), seed=6)
        kw = dict(fast="kernel", seed=4, device="cpu")
        chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH, **kw)
        opts = init_opt_states(cfg, mods)
        chunk(opts, feats, targets, idx[:2], desc, 0)
        if reload:
            path = str(tmp_path / f"{reload}.pt")
            save_checkpoint(path, {"step": 2}, mods, opts)
            if reload == "new":
                mods = AgentModules(cfg)
                chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH,
                                                          **kw)
                opts = init_opt_states(cfg, mods)
            ptrs = [p.data_ptr() for p in mods.parameters()]
            assert load_checkpoint(path, mods, opts)["step"] == 2
            assert ptrs == [p.data_ptr() for p in mods.parameters()]
            if reload == "same":
                assert _is_flat(mods, opts)
        sm = chunk(opts, feats, targets, idx[2:], desc, 2)
        return mods, opts, sm

    base = run(None)
    for how in ("same", "new"):
        mods, opts, sm = run(how)
        for f in sm._fields:
            assert torch.equal(getattr(sm, f), getattr(base[2], f)), (how, f)
        for (k, p), q in zip(mods.named_parameters(), base[0].parameters()):
            assert torch.equal(p, q), (how, k)
        for agent in AGENT_NAMES:
            assert opts[agent]["count"] == base[1][agent]["count"] == 5
            for x, y in zip(opts[agent]["nu"], base[1][agent]["nu"]):
                assert torch.equal(x, y), (how, agent)


def test_staged_kernel_chunk_raises_where_no_plan_fits(monkeypatch):
    mods = init_params(AgentModules(GameConfig(**BASE)), seed=0)
    chunk = make_multistep_train_step(mods, TOP_K, BATCH, fast="kernel",
                                      device="cpu")
    data, target, desc = _stacks()
    monkeypatch.setattr(cuda_exchange, "find_plan", lambda *a, **k: None)
    with pytest.raises(ValueError, match="no launch plan"):
        chunk(init_opt_states(mods.cfg, mods),
              *_torch(data.astype(np.float32), target,
                      desc.astype(np.float32)))


# ---------------------------------------------- data and tensor parallelism

def _grid_run(mesh, n_model, kw, params_np, data, target, desc):
    """The staged chunk from ``params_np`` on ``mesh`` (a ``(data,
    model)`` grid of its ranks when ``n_model`` is above 1; one device
    when ``mesh`` is None): the whole weights, the metrics, whether every
    trained agent's slots came out flat, and the sender's slot and shard
    shapes."""
    grid = make_mesh_2d(mesh, n_model) if n_model > 1 else mesh
    mods = load_torch_state(AgentModules(GameConfig(**kw)).double(), {
        a: {k: torch.from_numpy(v) for k, v in sd.items()}
        for a, sd in params_np.items()})
    tp = (TensorParallel(grid, mods, num_classes=len(desc))
          if n_model > 1 else None)
    chunk = make_multistep_train_step(mods, TOP_K, len(data[0]), "auto",
                                      seed=7, device="cpu", mesh=grid, tp=tp)
    opts = (init_opt_states(mods.cfg, mods) if tp is None
            else init_tp_opt_states(mods.cfg, tp))
    sm = chunk(opts, *_torch(data, target, desc))
    trained = mods if tp is None else tp.shard
    return dict(
        start=params_np, params=params_np_of(mods), metrics=_metrics_np(sm),
        slots_flat=all(_flat_view(opts[agent]["nu"], flat_order(
            opts[agent]["nu"], None if tp is None else tp.sharded(agent)))
            is not None for agent in AGENT_NAMES),
        slot_shapes=[tuple(t.shape) for t in opts["sender"]["nu"]],
        shard_shapes=[tuple(p.shape) for p in trained.sender.parameters()])


@pytest.mark.parametrize("n_model", [1, 2], ids=["mesh_2", "grid_1x2"])
def test_flat_carry_on_mesh_and_grid(n_model):
    """Two gloo ranks: a data-parallel mesh (the flat gradient is the
    all-reduce's buffer) and a 1 x 2 grid (the buffers are the rank's
    shards, the clip norm over the whole agent): each rank's run against
    one device's within the trajectory tolerances, the ranks' weights
    equal and their slots flat."""
    from tests.tp_cases import BASE as TP_BASE
    kw = {**TP_BASE, "optim_type": "RMSprop"}
    mods = init_params(AgentModules(GameConfig(**kw)), seed=3).double()
    params_np = params_np_of(mods)
    rng = np.random.RandomState(2)
    data = rng.randn(2, 16, TP_BASE["img_feat_dim"])
    target = rng.randint(0, 8, (2, 16))
    desc = rng.randn(8, TP_BASE["wv_dim"])
    one = _grid_run(None, 1, kw, params_np, data, target, desc)
    ranks = launch(_grid_run, ["cpu", "cpu"],
                   (n_model, kw, params_np, data, target, desc), timeout=300)
    for got in ranks:
        _assert_same_run(got, one, f"n_model {n_model}")
        assert got["slots_flat"]
        assert got["slot_shapes"] == got["shard_shapes"]
    for agent, sd in ranks[0]["params"].items():
        for k, p in sd.items():
            np.testing.assert_array_equal(p, ranks[1]["params"][agent][k])
    if n_model == 2:
        # The sender's image layer is column-parallel: each rank holds
        # half of its rows.
        assert ranks[0]["shard_shapes"][0][0] * 2 == \
            mods.sender.image_layer.weight.shape[0]
