"""The graph route on a data-parallel mesh and a tensor-parallel grid, on
two gloo CPU ranks (``parallel/distributed.py:launch``), in float64.

On a card a rank of an NCCL mesh captures its step, collectives and all,
as one CUDA graph (``game/train.py:step_route``); on the CPU the same
body runs uncaptured, on the same static buffers and device counter. So
here, every case in one launch:

* data parallelism: the ranks' body against one process stepping on the
  whole batch, after every step (weights, optimizer slots, Adam's count,
  the step's scalars) at tests/test_torch_mesh_step.py's tolerances
  (the ranks sum their gradients in another order), three steps one a
  chunk, then a chunk of K, then a full-metrics step (its gathered
  predictions and record, the bits equal), for the indexed and the
  staged chunks, RMSprop and Adam, ``fast`` = kernel (its plain
  version), auto and False; each call's collective calls against the
  count the losses make (tests/test_torch_mesh_step.py's);
* the body's full step against JAX's ``make_sharded_train_step`` on a
  2-device mesh in float64, handed JAX's uniforms (a uniform source's
  numbers cut to the rank's rows), at tests/test_torch_mesh_step.py's
  tolerances;
* a 1 x 2 grid (tests/tp_cases.py): the body's whole weights after
  every step against one process's steps on the whole agents, and its
  step against JAX's ``make_sharded_train_step`` on
  ``make_mesh_2d(1, 2)``, the collectives of a chunk on each axis the
  count tests/tp_cases.py holds;
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

# tests/test_torch_mesh_step.py's float64 tolerances: the losses and
# scalars at ~1e-9, every weight's and slot's change at 1e-8 / 3e-11.
RTOL, ATOL = mesh_step.RTOL, mesh_step.ATOL
DELTA_RTOL, DELTA_ATOL = mesh_step.DELTA_RTOL, mesh_step.DELTA_ATOL

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
# The full step's outputs that a rank's steps give exactly as one process
# does: the predictions, the sampled bits and the turn count.
EXACT = ("argmax", "sen_feats", "rec_feats", "stop_masks", "n_steps")


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


def _dp_run(mesh, case, data):
    """The body's steps of one data-parallel case, on this rank of
    ``mesh`` or, with ``mesh`` None, in one process on the whole batch:
    the state and scalars after every call, the full step's metrics and,
    on the mesh, each call's collectives."""
    optim, fast, staged = case
    feats, targets, desc = (torch.from_numpy(a) for a in data[:3])
    idx = data[3]
    cfg = GameConfig(**{**BASE, "optim_type": optim})
    mods = init_params(AgentModules(cfg), seed=1).double()
    kw = dict(fast=fast, seed=9, mesh=mesh, device="cpu")
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

    def calls():
        return 0 if mesh is None else mesh.calls
    opts = init_opt_states(cfg, mods)
    states, scalars, counted = [_state(mods, opts)], [], []
    for lo, hi in [(i, i + 1) for i in range(SINGLE)] + [(SINGLE,
                                                          SINGLE + K)]:
        before = calls()
        sm = chunk(opts, lo, hi)
        counted.append(calls() - before)
        scalars.append(torch.stack(list(sm)))
        states.append(_state(mods, opts))
    before = calls()
    m = full(opts, SINGLE + K)
    counted.append(calls() - before)
    states.append(_state(mods, opts))
    return dict(states=states, scalars=scalars, calls=counted,
                full={k: getattr(m, k) for k in
                      ("loss_rec", "loss_sen", "accuracy", "dist",
                       "argmax")},
                record={k: getattr(m.exchange, k) for k in
                        ("sen_feats", "rec_feats", "stop_masks", "y",
                         "n_steps")})


def _grid_run(grid, case):
    """tests/tp_cases.py's ``port_case`` on the body, on this rank of
    ``grid`` or, with ``grid`` None, in one process on the whole agents:
    the whole weights after every step and, on the grid, a chunk's
    collectives."""
    (kw, _, class_sharded, params_np, data, target, desc, uniforms) = case
    mods = tp_cases._port_modules(kw, params_np)
    tp = None if grid is None else TensorParallel(
        grid, mods, class_sharded=class_sharded, num_classes=len(desc))
    u = [{k: torch.from_numpy(v) for k, v in d.items()} for d in uniforms]
    step = make_train_step(mods, TOP_K, tp_cases.BATCH, "auto",
                           uniforms=u.__getitem__, mesh=grid, tp=tp,
                           device="cpu")
    opts = (init_opt_states(mods.cfg, mods) if tp is None
            else init_tp_opt_states(mods.cfg, tp))
    # The whole weights alone: a rank's slots are its shards'.
    no_slots = dict.fromkeys(AGENT_NAMES, {})
    weights = [_state(mods, no_slots)]
    for s in range(tp_cases.STEPS):
        m = step(opts, data, target, desc, s)
        weights.append(_state(mods, no_slots))
    params = tp_cases.params_np_of(mods)
    chunk = make_multistep_train_step_indexed(
        mods, TOP_K, tp_cases.BATCH, "auto", uniforms=u.__getitem__,
        mesh=grid, tp=tp, device="cpu")
    before = (0, 0) if grid is None else (grid.calls, grid.model.calls)
    chunk(opts, torch.from_numpy(data), torch.from_numpy(target),
          np.arange(tp_cases.BATCH)[None], torch.from_numpy(desc), 0)
    weights.append(_state(mods, no_slots))
    out = dict(loss_rec=float(m.loss_rec), loss_sen=float(m.loss_sen),
               accuracy=float(m.accuracy), params=params, weights=weights)
    if grid is not None:
        out.update(data_calls=grid.calls - before[0],
                   model_calls=grid.model.calls - before[1])
    return out


def run_all(mesh, data, jax_cases, grid_cases):
    """Every case on this rank, in one process group."""
    dp = [_dp_run(mesh, case, data) for case in DP_CASES]

    def on_body(mods, fast, uniforms):
        return make_train_step(mods, mesh_step.TOP_K, mesh_step.BATCH, fast,
                               uniforms=uniforms, mesh=mesh, graph=True)
    vs_jax = [mesh_step.port_case(mesh, case, on_body) for case in jax_cases]
    grid = make_mesh_2d(mesh, RANKS)
    on_grid = [_grid_run(grid, case) for case in grid_cases]
    return dict(dp=dp, jax=vs_jax, grid=on_grid)


def _grid_cases():
    out = []
    for name in GRID_CASES:
        w = tp_cases._jax_case(name)
        out.append((w["kw"], w["shape"], w["class_sharded"], w["params"],
                    w["data"], w["target"], w["desc"], w["uniforms"]))
    return out


@pytest.fixture(scope="module")
def ranks():
    jax_cases = [mesh_step.jax_inputs(name) for name in JAX_CASES]
    return launch(run_all, ["cpu"] * RANKS,
                  (_data(), jax_cases, _grid_cases()), timeout=600)


@pytest.fixture(scope="module")
def one_process():
    """Every data-parallel and grid case in this process, on the whole
    batch: the ranks' reference."""
    return dict(dp=[_dp_run(None, case, _data()) for case in DP_CASES],
                grid=[_grid_run(None, case) for case in _grid_cases()])


def _close_lists(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL,
                                   msg=f"{what}: call {i}")


def _close_changes(a, b, what):
    """Each state's change from the first, at the changes' tolerances."""
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        torch.testing.assert_close(x - a[0], y - b[0], rtol=DELTA_RTOL,
                                   atol=DELTA_ATOL, msg=f"{what}: call {i}")


@pytest.mark.parametrize("i", range(len(DP_CASES)), ids=DP_IDS)
def test_mesh_body_equals_eager_mesh_step(i, ranks, one_process):
    """Each rank's steps against one process stepping on the whole batch
    from the same weights: the weights, slots and Adam's count after
    every call, every step's scalars, the full step's metrics and its
    record, the bits equal."""
    want = one_process["dp"][i]
    for rank in ranks:
        body = rank["dp"][i]
        assert torch.equal(body["states"][0], want["states"][0])
        _close_changes(body["states"], want["states"], "weights and slots")
        _close_lists(body["scalars"], want["scalars"], "scalars")
        for part in ("full", "record"):
            for k, v in want[part].items():
                if k in EXACT:
                    assert torch.equal(body[part][k], v), (part, k)
                else:
                    torch.testing.assert_close(body[part][k], v, rtol=RTOL,
                                               atol=ATOL, msg=k)
        assert body["scalars"][-1].shape[1] == K
        # The full step's metrics are the whole batch's.
        assert body["full"]["argmax"].shape == (BATCH,)
    # Every rank holds the same weights.
    a, b = (r["dp"][i]["states"][-1] for r in ranks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("i", range(len(DP_CASES)), ids=DP_IDS)
def test_mesh_body_collectives_equal_eager(i, ranks):
    """The same collectives on every rank: an update's (the losses'
    batch statistics and one gradient sum), K times that in a chunk of
    K, and the full step's two gathers of its predictions and record on
    top of an update's."""
    calls = [r["dp"][i]["calls"] for r in ranks]
    update = calls[0][0]
    assert update > 0
    for got in calls:
        assert got == [update] * SINGLE + [K * update, update + 2]


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_body_matches_jax(name, ranks):
    mesh_step.check_matches_jax(
        name, [r["jax"][JAX_CASES.index(name)] for r in ranks])


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_body_equals_eager_grid(name, ranks, one_process):
    want = one_process["grid"][GRID_CASES.index(name)]
    for rank in ranks:
        got = rank["grid"][GRID_CASES.index(name)]
        _close_changes(got["weights"], want["weights"], "whole weights")


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_body_matches_jax(name, ranks):
    results = [r["grid"][GRID_CASES.index(name)] for r in ranks]
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
