"""The port's graph route on the CPU: the pieces a captured training step
and a captured eval conversation are made of, held against the eager
step and the JAX package.

A CUDA graph needs a card, so here each piece runs uncaptured:

* Philox keyed by a tensor ``(seed, step, row_base)`` equals the int key
  bit for bit, every stream, at row bases 0 and 32; the train kernel's
  plain version under ``key=`` equals it under ``seed``/``step``, and
  phase A takes the key on either sampler;
* Adam's count as a device tensor: against JAX's
  ``make_multistep_train_step_indexed`` at K = 3 in float64 (~1e-9, as
  tests/test_torch_multistep.py holds the staged chunk), and bit for bit
  against the int count's update;
* the step body that a graph captures (on the CPU it runs uncaptured,
  on the same static buffers and device counter): a chunk of K = 4, a
  second chunk and a full-metrics step equal the same seven updates
  taken one at a time through the one-step factories bit for bit, for
  RMSprop and Adam with the kernel sampler (its plain version), the
  plain sampler and the plain exchange;
* ``step_route``: a CUDA device alone or on an NCCL mesh or grid gives
  "graph", the CPU and a gloo mesh or grid "eager", decided without a
  card; ``graph=True`` with a gloo mesh on a card is refused before the
  device is touched, and taken on the CPU; the driver logs
  ``Step: eager`` and takes its full steps and its chunks from one
  trainer (tests/test_torch_mesh_graph.py holds the body on a mesh);
* the eval conversation's body reads the weights as they are after an
  update that bumped no version (as a graph replay's does), and equals
  the kernel route's conversation called directly; the plain route's
  body (visual attention with the ``fc`` context, description attention,
  ``mou``, ``flipout_dev``) equals :func:`exchange` called directly bit
  for bit, is built again when a parameter is replaced, and a dev sweep
  on it equals the sweep over :func:`exchange` called directly;
* a ``.pt`` of the tensor count, read back by JAX's
  ``load_reference_checkpoint`` and by the port, in place.
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
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.game.train import (
    make_multistep_train_step_indexed as jax_multistep)
from multimodalgame_tpu.utils import torch_interop as jax_interop
from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.game import train as game_train
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import exchange
from multimodalgame_tpu_torch.game.fast_eval import eval_dev_device
from multimodalgame_tpu_torch.game.train import (
    ScanMetrics, _flat_view, _kernel_exchange, answer_scores, flat_order,
    init_opt_states, make_eval_exchange,
    make_multistep_train_step, make_multistep_train_step_indexed,
    make_train_step, make_train_step_indexed, optimizer_update, step_route)
from multimodalgame_tpu_torch.ops import cuda_exchange
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    fused_train_forward, kernel_params)
from multimodalgame_tpu_torch.ops.philox import (member_uniforms,
                                                 philox4x32_10,
                                                 philox_eval_uniforms,
                                                 philox_uniforms)
from multimodalgame_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from tests.jax_uniforms import jax_step_provider
from tests.port_runs import port_flags, small_argv
from tests.test_torch_train import (ATOL, BASE, BATCH, DELTA_ATOL,
                                    DELTA_RTOL, NUM_CLASSES, RTOL, TOP_K,
                                    _f64, _np_tree, _port_agents)
from tests.tp_cases import params_np_of

# Both flipout streams on, so that every training stream is drawn.
FLIP = dict(BASE, flipout_sen=0.1, flipout_rec=0.2)
ROWS = 40
K = 4


def _key(seed, step, row_base):
    return torch.tensor([seed, step, row_base], dtype=torch.int64)


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ Philox

@pytest.mark.parametrize("row_base", [0, 32])
def test_tensor_key_philox_equals_int_key(row_base):
    """Every training stream, the eval slots' and the members', and the
    generator itself: the same words from a tensor key as from ints."""
    cfg = GameConfig(**FLIP, flipout_dev=True)
    seed, step = 2 ** 32 - 5, 123456
    k = _key(seed, step, row_base)
    want = philox_uniforms(cfg, 7, seed, step, row_base=row_base)
    got = philox_uniforms(cfg, 7, k[0], k[1], row_base=k[2])
    assert sorted(want) == ["fw", "fz", "s", "w", "z"]
    assert _equal(got, want)
    for slot in (0, 3):
        assert _equal(philox_eval_uniforms(cfg, 5, k[0], k[1], slot,
                                           row_base=k[2]),
                      philox_eval_uniforms(cfg, 5, seed, step, slot,
                                           row_base=row_base))
    assert _equal(member_uniforms(cfg, 4, k[0], k[1], 3),
                  member_uniforms(cfg, 4, seed, step, 3))
    counter = tuple(torch.arange(6) + i for i in range(4))
    for a, b in zip(philox4x32_10(counter, (k[0], k[1])),
                    philox4x32_10(counter, (seed, step))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("row_base", [0, 32])
@pytest.mark.parametrize("variant", [{}, {"flipout_sen": 0.1,
                                          "flipout_rec": 0.2},
                                     {"fixed_exchange": True}],
                         ids=["adaptive", "flipout", "fixed"])
def test_kernel_plain_version_under_tensor_key(variant, row_base):
    cfg = GameConfig(**{**BASE, **variant})
    params = kernel_params(init_params(AgentModules(cfg), seed=3))
    rng = np.random.RandomState(4)
    data = torch.from_numpy(rng.randn(9, cfg.img_feat_dim).astype(
        np.float32))
    desc = torch.from_numpy(rng.randn(NUM_CLASSES, cfg.wv_dim).astype(
        np.float32))
    want = fused_train_forward(cfg, params, data, desc, seed=11, step=7,
                               row_base=row_base)
    got = fused_train_forward(cfg, params, data, desc,
                              key=_key(11, 7, row_base))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sampler", ["kernel", "plain"])
def test_sample_conversation_takes_the_key(sampler):
    """Phase A under ``key=`` on either sampler equals it under the same
    key's uniforms."""
    from multimodalgame_tpu_torch.game.fast_train import sample_conversation
    cfg = GameConfig(**FLIP)
    mods = init_params(AgentModules(cfg), seed=3)
    rng = np.random.RandomState(4)
    data = torch.from_numpy(rng.randn(9, cfg.img_feat_dim).astype(
        np.float32))
    desc = torch.from_numpy(rng.randn(NUM_CLASSES, cfg.wv_dim).astype(
        np.float32))
    got = sample_conversation(mods, data, desc, sampler, key=_key(5, 6, 32))
    want = sample_conversation(mods, data, desc, sampler,
                               uniforms=philox_uniforms(cfg, 9, 5, 6,
                                                        row_base=32))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_key_is_checked():
    cfg = GameConfig(**BASE)
    params = kernel_params(init_params(AgentModules(cfg), seed=3))
    data = torch.zeros(3, cfg.img_feat_dim)
    desc = torch.zeros(NUM_CLASSES, cfg.wv_dim)
    with pytest.raises(ValueError, match="exactly one"):
        fused_train_forward(cfg, params, data, desc, seed=1, step=2,
                            key=_key(1, 2, 0))
    with pytest.raises(ValueError, match="int64"):
        fused_train_forward(cfg, params, data, desc,
                            key=_key(1, 2, 0).int())
    with pytest.raises(ValueError, match="row_base"):
        fused_train_forward(cfg, params, data, desc, key=_key(1, 2, 0),
                            row_base=4)


def test_launch_counts_round_trip():
    """What a graph's owner does around a capture and at each replay."""
    before = cuda_exchange.launch_counts()
    try:
        cuda_exchange.set_launch_counts((3, 5))
        cuda_exchange.add_launches((1, 2))
        assert cuda_exchange.fused_eval_exchange.launches == 4
        assert cuda_exchange.fused_train_forward.launches == 7
    finally:
        cuda_exchange.set_launch_counts(before)


# -------------------------------------------------------------------- Adam

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adam_tensor_count_equals_int_count(dtype):
    """Five of Adam's updates, the count an int and a 0-dim int64 tensor:
    the same updates and slots, bit for bit."""
    cfg = GameConfig(**{**BASE, "optim_type": "Adam"})
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (3,), (7,)]
    zeros = [torch.zeros(s, dtype=dtype) for s in shapes]
    states = [{"mu": list(zeros), "nu": list(zeros), "count": 0},
              {"mu": list(zeros), "nu": list(zeros),
               "count": torch.zeros((), dtype=torch.int64)}]
    for _ in range(5):
        grads = [torch.from_numpy(rng.randn(*s)).to(dtype) for s in shapes]
        out = [optimizer_update(cfg, grads, st) for st in states]
        for a, b in zip(out[0][0], out[1][0]):
            assert torch.equal(a, b)
        states = [st for _, st in out]
    assert isinstance(states[1]["count"], torch.Tensor)
    assert int(states[1]["count"]) == states[0]["count"] == 5
    for slot in ("mu", "nu"):
        for a, b in zip(states[0][slot], states[1][slot]):
            assert torch.equal(a, b)


def _indexed_data(seed=5):
    rng = np.random.RandomState(seed)
    feats = rng.randn(ROWS, BASE["img_feat_dim"])
    targets = rng.randint(0, NUM_CLASSES, ROWS)
    desc = rng.randn(NUM_CLASSES, BASE["wv_dim"])
    idx = np.stack([np.sort(rng.permutation(ROWS)[:BATCH]) for _ in range(K)])
    return feats, targets, desc, idx


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph_body"])
@pytest.mark.parametrize("preset", ["Adaptive", "Fixed"])
def test_adam_tensor_count_matches_jax_indexed_chunk(preset, graph):
    """K = 3 Adam steps of JAX's indexed trainer in float64 against the
    port's, eager and on the graph body, handed JAX's per-step uniforms:
    losses at ~1e-9, every weight's change at the trajectory tolerances,
    and the count a tensor at 3."""
    kw = {**BASE, "fixed_exchange": preset == "Fixed", "optim_type": "Adam"}
    feats, targets, desc, idx = _indexed_data()
    key = jax.random.PRNGKey(8)
    with jax.enable_x64(True):
        jmods = JaxModules(JaxConfig(**kw))
        params = _f64(jax_init_params(jmods, jax.random.PRNGKey(1),
                                      num_classes=NUM_CLASSES))
        start = _np_tree(params)
        chunk = jax_multistep(jmods, top_k=TOP_K, batch_denom=BATCH,
                              fast="auto")
        new, _, jm = chunk(params, jax_init_opt_states(jmods.cfg, params),
                           jnp.asarray(feats), jnp.asarray(targets),
                           jnp.asarray(idx[:3]), jnp.asarray(desc), key,
                           step0=0)
        new = _np_tree(new)
        want = {f: np.asarray(getattr(jm, f)) for f in jm._fields}
        provider = jax_step_provider(jmods.cfg, key, BATCH,
                                     dtype=jnp.float64)
        for s in range(3):
            provider(s)
    mods = _port_agents(kw, start)
    opts = init_opt_states(mods.cfg, mods)
    port = make_multistep_train_step_indexed(
        mods, TOP_K, BATCH, fast="kernel", uniforms=provider, device="cpu",
        graph=graph)
    sm = port(opts, torch.from_numpy(feats), torch.from_numpy(targets),
              idx[:3], torch.from_numpy(desc), 0)
    for f, v in want.items():
        np.testing.assert_allclose(getattr(sm, f).numpy(), v, rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    got = params_np_of(mods)
    from multimodalgame_tpu_torch.utils.torch_interop import (
        params_to_torch_state)
    want_p, base = params_to_torch_state(new), params_to_torch_state(start)
    for agent in AGENT_NAMES:
        for name, p in got[agent].items():
            np.testing.assert_allclose(
                p - base[agent][name], want_p[agent][name] - base[agent][name],
                rtol=DELTA_RTOL, atol=DELTA_ATOL, err_msg=f"{agent}.{name}")
        assert isinstance(opts[agent]["count"], torch.Tensor)
        assert int(opts[agent]["count"]) == 3


# ------------------------------------------------------ the captured body

def _run(optim, fast, staged, one_at_a_time):
    """Two chunks (K steps from step 5, 2 from step 9) and a full-metrics
    step (step 11) on the same agents, from the same seed; with
    ``one_at_a_time`` the chunks' updates each through the one-step
    factory instead. The metrics, weights and slots."""
    feats, targets, desc, idx = (torch.from_numpy(a) if i < 3 else a
                                 for i, a in enumerate(_indexed_data(3)))
    cfg = GameConfig(**{**BASE, "optim_type": optim})
    mods = init_params(AgentModules(cfg), seed=1).double()
    opts = init_opt_states(cfg, mods)
    kw = dict(fast=fast, seed=9, device="cpu")
    if staged:
        plan = torch.from_numpy(idx)
        chunk = make_multistep_train_step(mods, TOP_K, BATCH, **kw)
        step = make_train_step(mods, TOP_K, BATCH, **kw)

        def run_chunk(rows, s):
            return chunk(opts, feats[plan[rows]], targets[plan[rows]], desc,
                         s)

        def run_step(row, s):
            return step(opts, feats[plan[row]], targets[plan[row]], desc, s)
    else:
        chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH, **kw)
        step = make_train_step_indexed(mods, TOP_K, BATCH, **kw)

        def run_chunk(rows, s):
            return chunk(opts, feats, targets, idx[rows], desc, s)

        def run_step(row, s):
            return step(opts, feats, targets, idx[row], desc, s)

    def one_by_one(rows, s):
        ms = [run_step(r, s + i) for i, r in enumerate(range(K)[rows])]
        return ScanMetrics(*(torch.stack([getattr(m, f) for m in ms])
                             for f in ScanMetrics._fields))
    run = one_by_one if one_at_a_time else run_chunk
    first = run(slice(0, K), 5)
    second = run(slice(0, 2), 9)
    full = run_step(3, 11)
    return dict(first=first, second=second, full=full, mods=mods, opts=opts)


@pytest.mark.parametrize("staged", [False, True], ids=["indexed", "staged"])
@pytest.mark.parametrize("fast", ["kernel", "auto", False],
                         ids=["kernel_plain_version", "plain_sampler",
                              "plain_exchange"])
@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
def test_graph_body_equals_eager_chunk(optim, fast, staged):
    """The chunks' body against the same updates taken one at a time:
    every step's scalars, the full step's metrics and record, the
    weights, the slots and Adam's count, bit for bit."""
    single = _run(optim, fast, staged, one_at_a_time=True)
    body = _run(optim, fast, staged, one_at_a_time=False)
    for part in ("first", "second"):
        for f in single[part]._fields:
            a, b = getattr(single[part], f), getattr(body[part], f)
            assert torch.equal(a.to(b.dtype), b), (part, f)
    assert body["first"].loss_rec.shape == (K,)
    for f in ("loss_rec", "loss_sen", "accuracy", "dist", "argmax"):
        assert torch.equal(getattr(single["full"], f),
                           getattr(body["full"], f)), f
    assert torch.equal(single["full"].exchange.sen_feats,
                       body["full"].exchange.sen_feats)
    for (k, p), q in zip(single["mods"].named_parameters(),
                         body["mods"].parameters()):
        assert torch.equal(p, q), k
    for agent in AGENT_NAMES:
        a, b = single["opts"][agent], body["opts"][agent]
        for slot in ("mu", "nu"):
            for x, y in zip(a.get(slot, []), b.get(slot, [])):
                assert torch.equal(x, y), (agent, slot)
        if optim == "Adam":
            assert int(a["count"]) == int(b["count"]) == K + 3


# ------------------------------------------------------------------- route

def _mesh(backend, device="cuda", model=None):
    return types.SimpleNamespace(device=torch.device(device), size=2,
                                 backend=backend, model=model)


def test_step_route_by_configuration():
    assert step_route(None) == "graph"
    assert step_route("cuda") == "graph"
    assert step_route(torch.device("cuda", 0)) == "graph"
    assert step_route("cpu") == "eager"
    assert step_route("cuda", mesh=_mesh("nccl")) == "graph"
    assert step_route("cuda", mesh=_mesh("gloo")) == "eager"
    assert step_route("cpu", mesh=_mesh("gloo", "cpu")) == "eager"
    for backend, want in (("nccl", "graph"), ("gloo", "eager")):
        grid = _mesh(backend, model=_mesh(backend))
        tp = types.SimpleNamespace(mesh=grid, axis=grid.model)
        assert step_route("cuda", mesh=grid, tp=tp) == want


def test_graph_refused_on_a_mesh():
    """A gloo mesh on a card steps eagerly: ``graph=True`` there raises,
    before the modules move to the device (this machine may have none);
    on the CPU it runs the body uncaptured."""
    mods = init_params(AgentModules(GameConfig(**BASE)), seed=1)
    with pytest.raises(ValueError, match="cannot be captured"):
        make_multistep_train_step_indexed(mods, TOP_K, BATCH, fast="auto",
                                          mesh=_mesh("gloo"), graph=True)
    assert next(mods.parameters()).device.type == "cpu"
    chunk = make_multistep_train_step_indexed(
        mods, TOP_K, BATCH, fast="auto", mesh=_mesh("gloo", "cpu"),
        graph=True)
    assert callable(chunk)


def test_driver_logs_eager_route_on_the_cpu(synthetic_dataset, tmp_path):
    from multimodalgame_tpu_torch.train import run
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "route"))
    out = run(flags, max_steps=3, device="cpu")
    assert out["step"] == 3
    log = open(flags.log_file).read()
    assert "Step: eager" in log and "Step: graph" not in log


def test_run_fast_builds_one_trainer(synthetic_dataset, tmp_path,
                                     monkeypatch):
    """The driver's log-boundary steps and its chunks come from one
    trainer, which holds one step body of each kind."""
    from multimodalgame_tpu_torch.train import run
    built = []

    class Counted(game_train._Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(game_train, "_Trainer", Counted)
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "one"))
    out = run(flags, max_steps=3, device="cpu")
    assert out["step"] == 3
    assert len(built) == 1
    assert sorted(key[:2] for key in built[0]._graphs) == [
        ("indexed", False), ("indexed", True)]


# -------------------------------------------------------------------- eval

def _eval_inputs(cfg, batch=7):
    rng = np.random.RandomState(2)
    return (torch.from_numpy(rng.randn(batch, cfg.img_feat_dim).astype(
        np.float32)), torch.from_numpy(rng.randn(NUM_CLASSES, cfg.wv_dim)
                                       .astype(np.float32)))


def test_eval_cache_follows_generation():
    """A change through the flat buffer bumps no parameter's version (as
    a graph replay's update does not): the next eval conversation, on
    the same body, reads the new weights, as the kernel route called
    directly on them does."""
    cfg = GameConfig(**BASE)
    mods = init_params(AgentModules(cfg), seed=1)
    data, desc = _eval_inputs(cfg)
    opts = init_opt_states(cfg, mods)
    # Lay the carry out flat with one step.
    make_train_step(mods, TOP_K, BATCH, fast="kernel", device="cpu")(
        opts, data[:BATCH].double().numpy(), np.arange(BATCH) % NUM_CLASSES,
        desc, 0)
    run = make_eval_exchange(mods)
    before = run(data, desc)
    params = list(mods.sender.parameters())
    versions = [p._version for p in params]
    with torch.no_grad():
        _flat_view(params, flat_order(params)).add_(0.5)
    assert [p._version for p in params] == versions
    got = run(data, desc)
    assert not torch.equal(got.y, before.y)
    want = _kernel_exchange(cfg, kernel_params(mods), data, desc, None)
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert run.routes == {"kernel_graph": 0, "plain_graph": 0, "eager": 2}


@pytest.mark.parametrize("fixed", [False, True], ids=["adaptive", "fixed"])
def test_eval_graph_body_equals_eager(fixed):
    """The body an eval graph captures (uncaptured here, with a corrupt
    mask and without, each shape twice) against the kernel route's
    conversation called directly, and the answer against
    ``answer_scores`` of that record."""
    cfg = GameConfig(**BASE, fixed_exchange=fixed)
    mods = init_params(AgentModules(cfg), seed=1)
    data, desc = _eval_inputs(cfg)
    mask = torch.zeros(cfg.rec_w_dim)
    mask[:3] = 1
    body = make_eval_exchange(mods, graph=True)
    for corrupt in (None, mask, None, mask):
        want = _kernel_exchange(cfg, kernel_params(mods), data, desc,
                                corrupt)
        got, dist = body(data, desc, corrupt, answer=True)
        for f in want._fields:
            a, b = getattr(want, f), getattr(got, f)
            assert (a is None and b is None) or torch.equal(a, b), f
        assert torch.equal(dist, answer_scores(cfg, want))
        # The baselines' zeros come back packed once.
        assert got.br is got.bs
    assert body.routes == {"kernel_graph": 0, "plain_graph": 0, "eager": 4}


# The calls the eval kernel refuses, at the tests' widths: the
# AdaptiveAttention preset's switches (maps and the fc context),
# description attention, mou, and flipout in eval.
PLAIN = {"visual_attn_context": dict(visual_attn=True,
                                     attn_extra_context=True, attn_dim=8,
                                     attn_context_dim=20),
         "desc_attn": dict(desc_attn=True, desc_attn_dim=6),
         "mou": dict(sender_mix="mou"),
         "flipout_dev": dict(flipout_dev=True, flipout_sen=0.1,
                             flipout_rec=0.2)}
MAP = 3


def _plain_case(variant, seed=1):
    cfg = GameConfig(**BASE, fixed_exchange=False, **PLAIN[variant])
    mods = init_params(AgentModules(cfg), seed=seed)
    with torch.no_grad():
        # Keeps conversations going past turn 0.
        mods.receiver.s.bias.fill_(1.5)
    return cfg, mods


def _plain_inputs(cfg, batch, seed=4):
    """The call's keyword tensors: maps and their context under visual
    attention, the word sets under description attention, and under
    ``flipout_dev`` the eval uniforms with a key the conversation does
    not read."""
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    words = np.arange(3)[None] < rng.randint(1, 4, NUM_CLASSES)[:, None]
    u = philox_eval_uniforms(cfg, batch, 7, 3, 1)
    return dict(
        data=(t(batch, cfg.img_feat_dim, MAP, MAP) if cfg.visual_attn
              else t(batch, cfg.img_feat_dim)),
        desc=t(NUM_CLASSES, cfg.wv_dim),
        data_context=(t(batch, cfg.attn_context_dim)
                      if cfg.attn_extra_context else None),
        desc_set_padded=(t(NUM_CLASSES, 3, cfg.wv_dim)
                         * torch.from_numpy(words[..., None].astype(
                             np.float32)) if cfg.desc_attn else None),
        desc_set_mask=(torch.from_numpy(words.astype(np.float32))
                       if cfg.desc_attn else None),
        uniforms=(None if u is None else
                  {**u, "s": torch.rand(cfg.max_exchange, batch, 1)}))


@pytest.mark.parametrize("batch", [100, 37], ids=["batch100", "ragged"])
@pytest.mark.parametrize("variant", list(PLAIN))
def test_plain_eval_graph_body_equals_eager(variant, batch):
    """The body a plain-route eval graph captures (uncaptured here; with
    a corrupt mask and without, each shape twice) against
    :func:`exchange` called directly, bit for bit, ``attn_scores``
    included, and the answer against ``answer_scores``; the calls counted
    by route."""
    cfg, mods = _plain_case(variant)
    kw = _plain_inputs(cfg, batch)
    data, desc = kw.pop("data"), kw.pop("desc")
    mask = torch.zeros(cfg.rec_w_dim)
    mask[:3] = 1
    body = make_eval_exchange(mods, graph=True)
    for corrupt in (None, mask, None, mask):
        with torch.no_grad():
            want = exchange(mods, data, desc, corrupt, **kw)
        got, dist = body(data, desc, corrupt, answer=True, **kw)
        for f in want._fields:
            a, b = getattr(want, f), getattr(got, f)
            assert (a is None and b is None) or torch.equal(a, b), f
        assert torch.equal(dist, answer_scores(cfg, want))
    assert (want.attn_scores is not None) == cfg.visual_attn
    assert int(want.n_steps) > 1
    assert body.routes == {"kernel_graph": 0, "plain_graph": 0, "eager": 4}


def test_plain_eval_graph_follows_the_parameters(monkeypatch):
    """A plain-route graph reads the parameters where they lie: an
    in-place change is seen by the same graph, a replaced parameter (a
    new ``data_ptr``) builds the graph again. Uniforms missing under
    ``flipout_dev`` are refused as the eager conversation refuses them."""
    built = []

    class Counted(game_train._EvalGraph):
        def __init__(self, *args):
            built.append(1)
            super().__init__(*args)

    monkeypatch.setattr(game_train, "_EvalGraph", Counted)
    cfg, mods = _plain_case("visual_attn_context")
    kw = _plain_inputs(cfg, 9)
    run = make_eval_exchange(mods, graph=True)
    before = run(**kw)
    assert len(built) == 1
    orig = mods.sender.binary_layer.weight.detach().clone()
    with torch.no_grad():
        mods.sender.binary_layer.weight.add_(0.5)
    moved = run(**kw)
    assert len(built) == 1 and not torch.equal(moved.sen_probs,
                                               before.sen_probs)
    mods.sender.binary_layer.weight = torch.nn.Parameter(orig)
    again = run(**kw)
    assert len(built) == 2
    for a, b in zip(again, before):
        assert a is None or torch.equal(a, b)
    assert run.routes["eager"] == 3
    cfg, mods = _plain_case("flipout_dev")
    kw = _plain_inputs(cfg, 9)
    with pytest.raises(ValueError, match="needs the uniforms"):
        make_eval_exchange(mods, graph=True)(**{**kw, "uniforms": None})


def test_attention_dev_sweep_on_the_graph_body_equals_eager():
    """``eval_dev_device`` on the AdaptiveAttention preset's switches
    (maps, the fc context), batches of 100 and a ragged tail of 37: the
    eval conversation's body gives the accuracy, statistics, true labels
    and predictions of the sweep over :func:`exchange` called directly,
    one body call a batch."""
    cfg, mods = _plain_case("visual_attn_context")
    rng = np.random.RandomState(6)
    n = 237
    ds = DeviceDataset(
        rng.randn(n, cfg.img_feat_dim, MAP, MAP).astype(np.float32),
        rng.randint(0, NUM_CLASSES, n),
        context=rng.randn(n, cfg.attn_context_dim).astype(np.float32),
        device="cpu")
    desc = torch.from_numpy(rng.randn(NUM_CLASSES, cfg.wv_dim).astype(
        np.float32))

    def direct(data, desc, corrupt_mask=None, **kw):
        return exchange(mods, data, desc, corrupt_mask, **kw)
    run = make_eval_exchange(mods, graph=True)
    got = eval_dev_device(mods, run, ds, 0, False, 100, TOP_K, desc)
    want = eval_dev_device(mods, direct, ds, 0, False, 100, TOP_K, desc)
    assert run.routes["eager"] == 3
    assert got[0] == want[0]
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert want[1]["conversation_lengths_mean"] > 1


# -------------------------------------------------------------- checkpoint

def test_tensor_count_round_trips_through_pt(tmp_path):
    """Three Adam steps, then the ``.pt``: JAX reads the count as each
    slot's ``step``, and the port reads it back into its tensor in
    place."""
    kw = {**BASE, "optim_type": "Adam"}
    feats, targets, desc, idx = _indexed_data()
    mods = init_params(AgentModules(GameConfig(**kw)), seed=1).double()
    opts = init_opt_states(mods.cfg, mods)
    make_multistep_train_step_indexed(mods, TOP_K, BATCH, fast="kernel",
                                      device="cpu", graph=True)(
        opts, torch.from_numpy(feats), torch.from_numpy(targets), idx[:3],
        torch.from_numpy(desc), 0)
    path = str(tmp_path / "count.pt")
    save_checkpoint(path, {"step": 3, "best_dev_acc": 0.0}, mods, opts,
                    fmt="pt")
    raw = torch.load(path, weights_only=False)
    assert all(s["step"] == 3 for s in
               raw["optimizers"]["sender"]["state"].values())
    jmods = JaxModules(JaxConfig(**kw))
    template = jax_init_params(jmods, jax.random.PRNGKey(0),
                               num_classes=NUM_CLASSES)
    jopts = jax_init_opt_states(jmods.cfg, template)
    data, _, new_opts = jax_interop.load_reference_checkpoint(
        path, template, jopts, "Adam")
    assert data["step"] == 3
    back = jax_interop.opt_state_to_torch(
        "sender", template["sender"], new_opts["sender"], "Adam",
        step=3)["state"]
    assert all(int(s["step"]) == 3 for s in back.values())
    other = AgentModules(GameConfig(**kw)).double()
    port_opts = init_opt_states(other.cfg, other)
    counts = {a: port_opts[a]["count"] for a in AGENT_NAMES}
    load_checkpoint(path, other, port_opts)
    for agent in AGENT_NAMES:
        assert port_opts[agent]["count"] is counts[agent]
        assert int(counts[agent]) == 3
