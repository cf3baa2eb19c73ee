"""The population's graph route on the CPU: the pieces of a captured
population step and a captured population dev batch, held against the
eager chunk and the JAX package.

A CUDA graph needs a card, so here each body runs uncaptured
(``graph=True`` on the CPU runs it on the same static buffers and device
counter):

* ``member_uniforms`` keyed by 0-dim int64 tensors equals the int key
  bit for bit, for the training streams and eval slots 1 and 2, at
  member bases 0 and 2;
* the body that a population graph captures equals the eager chunk bit
  for bit at K = 4, N = 3 with learning-rate scales, for RMSprop and
  Adam, on Philox and on a ``uniforms`` source;
* the body against JAX's ``make_population_train_step`` in float64 at
  the tolerance of tests/test_torch_population.py;
* the caller's tensors are left as they were by a call on tensors that
  are not the carry, and the carry is trained in place when it is passed
  back (JAX's donation);
* the dev batch's graph body against the eager ``batch_correct`` and
  JAX's counts, ``-flipout_dev`` off and on, at two batch shapes;
* ``population_route``: CUDA devices give "graph", the CPU "eager",
  decided without a card;
* the sweep with every population step and dev batch on the graph body
  prints what the eager sweep prints.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.parallel.population import (
    make_population_eval as jax_make_population_eval)
from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.ops.philox import member_uniforms
from multimodalgame_tpu_torch.parallel import population
from multimodalgame_tpu_torch.parallel.population import (
    init_population, init_population_opt_states, make_population_eval,
    make_population_train_step, member_params, population_route,
    stack_members)
from multimodalgame_tpu_torch.sweep import run_sweep
from multimodalgame_tpu_torch.utils.checkpoint import read_checkpoint
from multimodalgame_tpu_torch.utils.torch_interop import (
    params_to_torch_state)
from tests.jax_uniforms import jax_uniforms
from tests.port_runs import port_flags
from tests.test_torch_population import (ATOL, DELTA_ATOL, DELTA_RTOL, KW,
                                         RTOL, SCALES, TOP_K, _f64,
                                         _inputs, _jax_population,
                                         _member_agents, _np)
from tests.test_torch_population import B, K, N, jax_member_params
from tests.test_torch_sweep import sweep_argv

FLIP = dict(flipout_dev=True, flipout_sen=0.1, flipout_rec=0.2)


def _leaves(pop, opts):
    """Every tensor of a population's carry, in a fixed order."""
    return list(pop.values()) + [
        t for agent in AGENT_NAMES for k in sorted(opts[agent])
        for t in (opts[agent][k] if isinstance(opts[agent][k], list)
                  else [opts[agent][k]])]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("member_base", [0, 2])
@pytest.mark.parametrize("slot", [None, 1, 2])
def test_member_uniforms_tensor_key(slot, member_base):
    cfg = GameConfig(**{**KW, **FLIP})
    key = torch.tensor([11, 123457], dtype=torch.int64)
    got = member_uniforms(cfg, 5, key[0], key[1], 3, slot=slot,
                          member_base=member_base)
    want = member_uniforms(cfg, 5, 11, 123457, 3, slot=slot,
                           member_base=member_base)
    assert got.keys() == want.keys()
    assert set(got) == ({"fz", "fw"} if slot else
                        {"s", "z", "w", "fz", "fw"})
    for k in want:
        assert got[k].shape == (3, KW["max_exchange"], 5) + got[k].shape[3:]
        assert torch.equal(got[k], want[k]), k


def _chunks(optim, source, graph, splits=(2, 2)):
    """K = 4 steps of N = 3 members with learning-rate scales, as chunks
    of ``splits`` steps, each passing back what the last returned."""
    cfg = GameConfig(**{**KW, "optim_type": optim})
    data, target, desc = _inputs()
    pop = init_population(cfg, 0, N, device="cpu")
    opts = init_population_opt_states(cfg, pop)
    uniforms = None
    if source == "uniforms":
        def uniforms(step):
            return member_uniforms(cfg, B, 5, 100 + step, N)
    chunk = make_population_train_step(AgentModules(cfg), TOP_K, B, seed=3,
                                       uniforms=uniforms, graph=graph)
    feats = torch.from_numpy(data.reshape(K * B, -1)).float()
    targets = torch.from_numpy(target.reshape(-1))
    idx = np.arange(K * B).reshape(K, B)
    rows, at = [], 0
    for size in splits:
        pop, opts, m = chunk(pop, opts, feats, targets, idx[at:at + size],
                             torch.from_numpy(desc).float(), at,
                             lr_scale=SCALES)
        rows.append(m)
        at += size
    return pop, opts, [torch.cat(v) for v in zip(*rows)]


@pytest.mark.parametrize("source", ["philox", "uniforms"])
@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
def test_graph_body_matches_eager_chunk(optim, source):
    """The body a population graph captures, run uncaptured on its static
    buffers, against the eager chunk: weights, slots (Adam's count too)
    and every step's scalars bit for bit."""
    pop, opts, metrics = _chunks(optim, source, graph=False)
    gpop, gopts, gmetrics = _chunks(optim, source, graph=True)
    assert _equal(_leaves(gpop, gopts), _leaves(pop, opts))
    assert _equal(gmetrics, metrics)
    assert gmetrics[0].shape == (K, N)
    if optim == "Adam":
        assert int(gopts["sender"]["count"]) == K
    # One chunk of 4 on the graph equals two of 2.
    one = _chunks(optim, source, graph=True, splits=(K,))
    assert _equal(_leaves(one[0], one[1]), _leaves(gpop, gopts))


def test_graph_body_matches_jax():
    """The graph body in float64 against JAX's population chunk (K = 4,
    N = 3, learning-rate scales 0.5, 1, 2, JAX's uniforms), at
    tests/test_torch_population.py's tolerance."""
    want = _jax_population()
    data, target, desc = _inputs()
    pop = stack_members([_member_agents(want["pop"], i) for i in range(N)])
    modules = AgentModules(GameConfig(**KW)).double()
    chunk = make_population_train_step(
        modules, TOP_K, B, uniforms=lambda s: want["uniforms"][s],
        graph=True)
    new_pop, _, m = chunk(pop, init_population_opt_states(modules.cfg, pop),
                          torch.from_numpy(data.reshape(K * B, -1)),
                          torch.from_numpy(target.reshape(-1)),
                          np.arange(K * B).reshape(K, B),
                          torch.from_numpy(desc), 0, lr_scale=SCALES)
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


def test_caller_inputs_unchanged_and_carry_in_place():
    cfg = GameConfig(**{**KW, "optim_type": "Adam"})
    data, target, desc = _inputs()
    feats = torch.from_numpy(data.reshape(K * B, -1)).float()
    targets = torch.from_numpy(target.reshape(-1))
    desc = torch.from_numpy(desc).float()
    idx = np.arange(K * B).reshape(K, B)
    pop = init_population(cfg, 0, N, device="cpu")
    opts = init_population_opt_states(cfg, pop)
    given = [t.clone() for t in _leaves(pop, opts)]
    chunk = make_population_train_step(AgentModules(cfg), TOP_K, B,
                                       graph=True)
    eager = make_population_train_step(AgentModules(cfg), TOP_K, B,
                                       graph=False)
    p1, o1, _ = chunk(pop, opts, feats, targets, idx[:2], desc, 0)
    # A call on tensors that are not the carry leaves them as they were.
    assert _equal(_leaves(pop, opts), given)
    assert not any(a is b for a, b in zip(_leaves(p1, o1),
                                          _leaves(pop, opts)))
    e1 = eager(pop, opts, feats, targets, idx[:2], desc, 0)
    assert _equal(_leaves(p1, o1), _leaves(*e1[:2]))
    # Passed back, the carry is trained in place.
    carry = _leaves(p1, o1)
    p2, o2, _ = chunk(p1, o1, feats, targets, idx[2:], desc, 2)
    assert all(a is b for a, b in zip(_leaves(p2, o2), carry))
    e2 = eager(*e1[:2], feats, targets, idx[2:], desc, 2)
    assert _equal(_leaves(p2, o2), _leaves(*e2[:2]))
    # The first inputs again: copied into the carry, the run restarts.
    p3, o3, _ = chunk(pop, opts, feats, targets, idx[:2], desc, 0)
    assert _equal(_leaves(p3, o3), _leaves(*e1[:2]))
    assert _equal(_leaves(pop, opts), given)


@pytest.mark.parametrize("flipout_dev", [False, True])
def test_eval_graph_body_matches_eager_and_jax(flipout_dev):
    """The dev batch's graph body against the eager ``batch_correct`` and
    JAX's ``make_population_eval`` in float64, at a batch of 8 and the
    truncated 3 rows after it, each graph called twice."""
    kw = FLIP if flipout_dev else {}
    want = _jax_population()
    data, target, desc = _inputs()
    keys = jax.random.split(jax.random.PRNGKey(4), N)
    cfg = GameConfig(**{**KW, **kw})
    pop = stack_members([_member_agents(want["pop"], i, **kw)
                         for i in range(N)])
    graph_eval = make_population_eval(AgentModules(cfg).double(), TOP_K,
                                      graph=True)
    eager_eval = make_population_eval(AgentModules(cfg).double(), TOP_K,
                                      graph=False)
    with jax.enable_x64(True):
        jmods = JaxModules(JaxConfig(**{**KW, **kw}))
        jax_eval = jax_make_population_eval(jmods, top_k=TOP_K)
        for rows in (slice(0, B), slice(B, B + 3)):
            x, t = data.reshape(K * B, -1)[rows], target.reshape(-1)[rows]
            jc = np.asarray(jax_eval(_f64(want["pop"]), jnp.asarray(x),
                                     jnp.asarray(t), jnp.asarray(desc),
                                     keys))
            u = None
            if flipout_dev:
                u = {name: torch.stack([
                    jax_uniforms(jmods.cfg, keys[i], len(x), train=False,
                                 dtype=jnp.float64)[name]
                    for i in range(N)]) for name in ("fz", "fw")}
            args = (pop, torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(desc))
            got = eager_eval(*args, uniforms=u)
            np.testing.assert_array_equal(got.numpy(), jc)
            for _ in range(2):
                assert torch.equal(graph_eval(*args, uniforms=u), got)


def test_population_route():
    assert population_route("cuda") == "graph"
    assert population_route(torch.device("cuda", 1)) == "graph"
    assert population_route("cpu") == "eager"
    assert population_route(torch.device("cpu")) == "eager"


def test_cpu_takes_eager_by_route(monkeypatch):
    """``graph`` None on CPU tensors runs the eager chunk and dev batch:
    no graph object is made."""
    def refuse(*args, **kwargs):
        raise AssertionError("a graph on the CPU")
    monkeypatch.setattr(population, "_PopulationGraph", refuse)
    monkeypatch.setattr(population, "_PopulationEvalGraph", refuse)
    cfg = GameConfig(**KW)
    data, target, desc = _inputs()
    pop = init_population(cfg, 0, N, device="cpu")
    new_pop, _, m = make_population_train_step(AgentModules(cfg), TOP_K, B)(
        pop, init_population_opt_states(cfg, pop),
        torch.from_numpy(data.reshape(K * B, -1)).float(),
        torch.from_numpy(target.reshape(-1)), np.arange(B)[None],
        torch.from_numpy(desc).float(), 0)
    assert m.accuracy.shape == (1, N)
    hits = make_population_eval(AgentModules(cfg), TOP_K)(
        new_pop, torch.from_numpy(data[0]).float(),
        torch.from_numpy(target[0]), torch.from_numpy(desc).float())
    assert hits.shape == (N,)


@pytest.mark.parametrize("extra", [[], ["-flipout_dev", "-flipout_sen",
                                        "0.1", "-flipout_rec", "0.1"]])
def test_sweep_on_graph_body_matches_eager(synthetic_dataset, tmp_path,
                                           capsys, monkeypatch, extra):
    """``run_sweep`` at N = 3 with every population step and dev batch on
    the graph body (the route forced to "graph" on the CPU) prints the
    eager sweep's member lines, logs its dev accuracies and writes the
    same ``_best``."""
    argv = ["-population", "3", "-lr_scales", "0.5,1"] + extra
    runs = {}
    for route in ("eager", "graph"):
        monkeypatch.setattr(population, "population_route",
                            lambda device, route=route: route)
        flags = port_flags(sweep_argv(synthetic_dataset, tmp_path / route,
                                      "sw", argv))
        summary = run_sweep(flags, max_steps=6, eval_every=3, device="cpu")
        lines = [json.loads(ln) for ln in capsys.readouterr().out
                 .splitlines() if ln.startswith("{")]
        log = [ln.split("] ", 1)[1] for ln in open(flags.log_file)
               if "per-member dev acc" in ln]
        best = read_checkpoint(flags.checkpoint + "_best")
        runs[route] = (summary, lines[:3], log, best["models"])
    (s0, l0, g0, b0), (s1, l1, g1, b1) = runs["eager"], runs["graph"]
    assert l1 == l0 == s0["members"]
    assert g1 == g0 and len(g0) == 2
    assert s1["winner"] == s0["winner"]
    assert b1.keys() == b0.keys()
    for agent, sd in b0.items():
        for k, v in sd.items():
            assert torch.equal(b1[agent][k], v), (agent, k)
