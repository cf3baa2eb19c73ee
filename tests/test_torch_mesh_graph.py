"""The graph route on a data-parallel mesh and a tensor-parallel grid, on
two gloo CPU ranks (``parallel/distributed.py:launch``), in float64.

On a card a rank of an NCCL mesh captures its step, collectives and all,
as one CUDA graph (``game/train.py:step_route``); ``graph=True`` on the
CPU runs the body that graph captures, uncaptured, on the same static
buffers and device counter. So here, every case in one launch:

* data parallelism: the body against the eager mesh step bit for bit
  after every step (weights, optimizer slots, Adam's count, the step's
  scalars), three steps one a chunk, then a chunk of K, then a
  full-metrics step (its gathered predictions and record), for the
  indexed and the staged chunks, RMSprop and Adam, ``fast`` = kernel
  (its plain version), auto and False; the collective calls of each
  call equal;
* the body's full step against JAX's ``make_sharded_train_step`` on a
  2-device mesh in float64, handed JAX's uniforms (a uniform source's
  numbers cut to the rank's rows), at tests/test_torch_mesh_step.py's
  tolerances;
* a 1 x 2 grid (tests/tp_cases.py): the body's steps against the eager
  grid's bit for bit after every step and against JAX's
  ``make_sharded_train_step`` on ``make_mesh_2d(1, 2)``, the collectives
  of a chunk on each axis equal to the eager chunk's and to the count
  tests/tp_cases.py holds;
* ``step_route`` by configuration: an NCCL mesh or grid on a card gives
  "graph", gloo or the CPU "eager".
"""

import types

import numpy as np
import pytest
import torch

from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_multistep_train_step,
    make_multistep_train_step_indexed, make_train_step,
    make_train_step_indexed, step_route)
from multimodalgame_tpu_torch.parallel.distributed import launch
from multimodalgame_tpu_torch.parallel.tensor import (TensorParallel,
                                                      init_tp_opt_states,
                                                      make_mesh_2d)
from tests import test_torch_mesh_step as mesh_step
from tests import tp_cases
from tests.test_torch_train import BASE, BATCH, NUM_CLASSES, TOP_K

RANKS = 2
ROWS = 40
SINGLE, K = 3, 3          # steps one a chunk, then one chunk of K
# (optimizer, fast, staged): every data-parallel case of the body.
DP_CASES = [(optim, fast, staged) for optim in ("RMSprop", "Adam")
            for fast in ("kernel", "auto", False) for staged in (False, True)]
DP_IDS = [f"{o}-{f}-{'staged' if s else 'indexed'}" for o, f, s in DP_CASES]
# tests/test_torch_mesh_step.py's cases held against JAX on the body: the
# driver's sampler, and halves that stop at different turns. (JAX's
# steps take most of this file's time: ~10 s a case.)
JAX_CASES = ("adaptive_kernel", "split_stops")
# tests/tp_cases.py's 1 x 2 grid case with every model-axis collective
# (the class-sharded head).
GRID_CASES = ("class_rmsprop_1x2",)


def _data():
    rng = np.random.RandomState(5)
    return (rng.randn(ROWS, BASE["img_feat_dim"]),
            rng.randint(0, NUM_CLASSES, ROWS),
            rng.randn(NUM_CLASSES, BASE["wv_dim"]),
            np.stack([rng.permutation(ROWS)[:BATCH]
                      for _ in range(SINGLE + K + 1)]))


def _state(mods, opts) -> torch.Tensor:
    """Every weight, optimizer slot and Adam count as one vector."""
    parts = [p.detach().reshape(-1) for p in mods.parameters()]
    for agent in AGENT_NAMES:
        st = opts[agent]
        for slot in ("mu", "nu"):
            parts += [x.reshape(-1) for x in st.get(slot, [])]
        if "count" in st:
            parts.append(st["count"].reshape(1))
    return torch.cat([p.to(torch.float64) for p in parts]).clone()


def _dp_run(mesh, case, data, graph):
    """Eager or body steps of one data-parallel case on this rank: the
    state and scalars after every call, the full step's metrics and each
    call's collectives."""
    optim, fast, staged = case
    feats, targets, desc = (torch.from_numpy(a) for a in data[:3])
    idx = data[3]
    cfg = GameConfig(**{**BASE, "optim_type": optim})
    mods = init_params(AgentModules(cfg), seed=1).double()
    kw = dict(fast=fast, seed=9, mesh=mesh, graph=graph)
    if staged:
        plan = torch.from_numpy(idx)
        chunk_fn = make_multistep_train_step(mods, TOP_K, BATCH, **kw)
        full_fn = make_train_step(mods, TOP_K, BATCH, **kw)

        def chunk(opts, lo, hi):
            return chunk_fn(opts, feats[plan[lo:hi]], targets[plan[lo:hi]],
                            desc, lo)

        def full(opts, i):
            return full_fn(opts, feats[plan[i]], targets[plan[i]], desc, i)
    else:
        chunk_fn = make_multistep_train_step_indexed(mods, TOP_K, BATCH, **kw)
        full_fn = make_train_step_indexed(mods, TOP_K, BATCH, **kw)

        def chunk(opts, lo, hi):
            return chunk_fn(opts, feats, targets, idx[lo:hi], desc, lo)

        def full(opts, i):
            return full_fn(opts, feats, targets, idx[i], desc, i)
    opts = init_opt_states(cfg, mods)
    states, scalars, calls = [], [], []
    for lo, hi in [(i, i + 1) for i in range(SINGLE)] + [(SINGLE,
                                                          SINGLE + K)]:
        before = mesh.calls
        sm = chunk(opts, lo, hi)
        calls.append(mesh.calls - before)
        scalars.append(torch.stack(list(sm)))
        states.append(_state(mods, opts))
    before = mesh.calls
    m = full(opts, SINGLE + K)
    calls.append(mesh.calls - before)
    states.append(_state(mods, opts))
    return dict(states=states, scalars=scalars, calls=calls,
                full={k: getattr(m, k) for k in
                      ("loss_rec", "loss_sen", "accuracy", "dist",
                       "argmax")},
                record={k: getattr(m.exchange, k) for k in
                        ("sen_feats", "rec_feats", "stop_masks", "y",
                         "n_steps")})


def _grid_run(grid, case, graph):
    """tests/tp_cases.py's ``port_case`` on the body or eagerly, with the
    whole weights and slots after every step."""
    (kw, _, class_sharded, params_np, data, target, desc, uniforms) = case
    mods = tp_cases._port_modules(kw, params_np)
    tp = TensorParallel(grid, mods, class_sharded=class_sharded,
                        num_classes=len(desc))
    u = [{k: torch.from_numpy(v) for k, v in d.items()} for d in uniforms]
    step = make_train_step(mods, TOP_K, tp_cases.BATCH, "auto",
                           uniforms=u.__getitem__, mesh=grid, tp=tp,
                           graph=graph)
    opts = init_tp_opt_states(mods.cfg, tp)
    states = []
    for s in range(tp_cases.STEPS):
        m = step(opts, data, target, desc, s)
        states.append(_state(mods, opts))
    params = tp_cases.params_np_of(mods)
    chunk = make_multistep_train_step_indexed(
        mods, TOP_K, tp_cases.BATCH, "auto", uniforms=u.__getitem__,
        mesh=grid, tp=tp, graph=graph)
    before = (grid.calls, grid.model.calls)
    chunk(opts, torch.from_numpy(data), torch.from_numpy(target),
          np.arange(tp_cases.BATCH)[None], torch.from_numpy(desc), 0)
    states.append(_state(mods, opts))
    return dict(loss_rec=float(m.loss_rec), loss_sen=float(m.loss_sen),
                accuracy=float(m.accuracy), params=params, states=states,
                data_calls=grid.calls - before[0],
                model_calls=grid.model.calls - before[1])


def run_all(mesh, data, jax_cases, grid_cases):
    """Every case on this rank, in one process group."""
    dp = [{graph: _dp_run(mesh, case, data, graph)
           for graph in (False, True)} for case in DP_CASES]

    def on_body(mods, fast, uniforms):
        return make_train_step(mods, mesh_step.TOP_K, mesh_step.BATCH, fast,
                               uniforms=uniforms, mesh=mesh, graph=True)
    vs_jax = [mesh_step.port_case(mesh, case, on_body) for case in jax_cases]
    grid = make_mesh_2d(mesh, RANKS)
    on_grid = [{graph: _grid_run(grid, case, graph)
                for graph in (False, True)} for case in grid_cases]
    return dict(dp=dp, jax=vs_jax, grid=on_grid)


@pytest.fixture(scope="module")
def ranks():
    jax_cases = [mesh_step.jax_inputs(name) for name in JAX_CASES]
    grid_cases = []
    for name in GRID_CASES:
        w = tp_cases._jax_case(name)
        grid_cases.append((w["kw"], w["shape"], w["class_sharded"],
                           w["params"], w["data"], w["target"], w["desc"],
                           w["uniforms"]))
    return launch(run_all, ["cpu"] * RANKS,
                  (_data(), jax_cases, grid_cases), timeout=600)


def _equal_lists(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"{what}: call {i}"


@pytest.mark.parametrize("i", range(len(DP_CASES)), ids=DP_IDS)
def test_mesh_body_equals_eager_mesh_step(i, ranks):
    for rank in ranks:
        eager, body = rank["dp"][i][False], rank["dp"][i][True]
        _equal_lists(eager["states"], body["states"], "weights and slots")
        _equal_lists(eager["scalars"], body["scalars"], "scalars")
        for part in ("full", "record"):
            for k, v in eager[part].items():
                assert torch.equal(v, body[part][k]), (part, k)
        assert eager["scalars"][-1].shape[1] == K
        # The full step's metrics are the whole batch's.
        assert eager["full"]["argmax"].shape == (BATCH,)
    # Every rank holds the same weights.
    a, b = (r["dp"][i][True]["states"][-1] for r in ranks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("i", range(len(DP_CASES)), ids=DP_IDS)
def test_mesh_body_collectives_equal_eager(i, ranks):
    for rank in ranks:
        eager, body = rank["dp"][i][False], rank["dp"][i][True]
        assert body["calls"] == eager["calls"]
        # A step: the losses' batch statistics and one gradient sum; a
        # chunk of K makes K times a step's.
        per_step = eager["calls"][0]
        assert per_step > 0 and eager["calls"][SINGLE] == K * per_step


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_body_matches_jax(name, ranks):
    mesh_step.check_matches_jax(
        name, [r["jax"][JAX_CASES.index(name)] for r in ranks])


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_body_equals_eager_grid(name, ranks):
    for rank in ranks:
        got = rank["grid"][GRID_CASES.index(name)]
        _equal_lists(got[False]["states"], got[True]["states"],
                     "weights and slots")
        for k in ("data_calls", "model_calls"):
            assert got[True][k] == got[False][k], k


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_body_matches_jax(name, ranks):
    results = [r["grid"][GRID_CASES.index(name)][True] for r in ranks]
    tp_cases.check_steps_match_jax(name, results)
    tp_cases.check_collectives(name, results)


def _axis(backend, model=None, device="cuda"):
    return types.SimpleNamespace(device=torch.device(device), size=2,
                                 backend=backend, model=model)


@pytest.mark.parametrize("backend, device, want", [
    ("nccl", "cuda", "graph"), ("gloo", "cuda", "eager"),
    ("gloo", "cpu", "eager")])
def test_route_of_a_mesh_and_a_grid(backend, device, want):
    mesh = _axis(backend, device=device)
    assert step_route(device, mesh=mesh) == want
    grid = _axis(backend, model=_axis(backend, device=device), device=device)
    tp = types.SimpleNamespace(mesh=grid, axis=grid.model)
    assert step_route(device, mesh=grid, tp=tp) == want
