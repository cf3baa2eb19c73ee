"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and
skips without one. This file imports no JAX, so on a machine without it
run it past the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances and the rule for a bit whose probability lies on its
threshold (0.5 in eval mode, the uniform in train mode) are those of
``ops.cuda_exchange.compare_outputs``: bits and masks exact,
probabilities at atol 1e-5, class scores at 1e-4.
"""

import numpy as np
import pytest
import torch

from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.masks import build_mask
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_multistep_train_step_indexed)
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    ROWS, _eval_launch, compare_outputs, fused_eval_exchange,
    fused_eval_exchange_reference, fused_train_forward,
    fused_train_forward_reference, kernel_params, kernel_registers,
    launch_plan, plan_for)
from multimodalgame_tpu_torch.ops.philox import philox_uniforms
from multimodalgame_tpu_torch.ops.sampling import uniform_widths
from multimodalgame_tpu_torch.serve import Predictor

pytestmark = pytest.mark.cuda

SMALL = dict(img_feat_dim=64, img_h_dim=32, sender_out_dim=16, rec_w_dim=16,
             rec_hidden=32, wv_dim=24, max_exchange=4, fixed_exchange=False)
CANON = dict(img_feat_dim=512, img_h_dim=256, sender_out_dim=32,
             rec_w_dim=32, rec_hidden=64, wv_dim=100, max_exchange=10,
             fixed_exchange=False)
VARIANTS = {"adaptive": {}, "fixed": dict(fixed_exchange=True),
            "prod": dict(sender_mix="prod"),
            "ignore_code": dict(ignore_code=True),
            "ignore_receiver": dict(ignore_receiver=True),
            "no_s_prob_prod": dict(s_prob_prod=False),
            "first_rec_1": dict(first_rec=1.0), "corrupt": {}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _agents(cfg, seed, stop_bias):
    """Random agents; the stop bias keeps Adaptive conversations going
    past turn 0 (random weights stop every row there)."""
    mods = init_params(AgentModules(cfg), seed=seed, device="cuda")
    with torch.no_grad():
        mods.receiver.s.bias.fill_(stop_bias)
    return mods


def _case(dims, batch, num_desc, seed=0, stop_bias=1.5, **kw):
    cfg = GameConfig(**{**dims, **kw})
    mods = _agents(cfg, seed, stop_bias)
    rng = np.random.RandomState(seed)
    data = torch.from_numpy(
        rng.randn(batch, cfg.img_feat_dim).astype(np.float32)).cuda()
    desc = torch.from_numpy(
        rng.randn(num_desc, cfg.wv_dim).astype(np.float32)).cuda()
    return cfg, mods, data, desc


def _check(cfg, params, data, desc, corrupt=None):
    with torch.inference_mode():
        got = fused_eval_exchange(cfg, params, data, desc, corrupt)
        want = fused_eval_exchange_reference(cfg, params, data, desc,
                                             corrupt)
    torch.cuda.synchronize()
    rep = compare_outputs(cfg, got, want)
    assert rep["ok"], rep
    return got


@pytest.mark.parametrize("batch", [1, 8, 13])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_kernel_matches_plain_version(cuda, name, batch):
    cfg, mods, data, desc = _case(SMALL, batch, 5, **VARIANTS[name])
    corrupt = (torch.from_numpy(build_mask("0:3,7", cfg.rec_w_dim)).cuda()
               if name == "corrupt" else None)
    _check(cfg, kernel_params(mods), data, desc, corrupt)


@pytest.mark.parametrize("batch", [1, 100])
def test_kernel_matches_plain_version_canonical_width(cuda, batch):
    cfg, mods, data, desc = _case(CANON, batch, 30, seed=1, stop_bias=2.5)
    got = _check(cfg, kernel_params(mods), data, desc)
    assert got.y.shape == (10, batch, 30)


def test_kernel_above_48k_shared_memory_and_many_classes(cuda):
    """The default img_feat_dim 4096 needs more than 48 KB of shared
    memory a block (the opt-in path); 70 classes take more than one warp
    pass in the softmax."""
    cfg, mods, data, desc = _case({**SMALL, "img_feat_dim": 4096}, 9, 70)
    _check(cfg, kernel_params(mods), data, desc)


def test_each_call_is_one_launch(cuda):
    cfg, mods, data, desc = _case(SMALL, 8, 5)
    params = kernel_params(mods)
    before = fused_eval_exchange.launches
    for _ in range(3):
        fused_eval_exchange(cfg, params, data, desc)
    assert fused_eval_exchange.launches == before + 3


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cfg, mods, data, desc = _case(SMALL, 8, 5)
    params = kernel_params(mods)
    bad = [
        (data.double(), desc, params),
        (data.t().contiguous().t(), desc, params),
        (data[:0], desc, params),
        (data, desc[:, :3].contiguous(), params),
        (data, desc, {**params, "wbin": params["wbin"].cpu()}),
    ]
    for d, ds, p in bad:
        with pytest.raises(ValueError):
            fused_eval_exchange(cfg, p, d, ds)


def test_predictor_serves_through_the_kernel(cuda):
    cfg = GameConfig(**CANON)
    desc = np.random.RandomState(2).randn(30, 100).astype(np.float32)
    pack = DescriptionPack(desc, desc, [1] * 30)
    mods = _agents(cfg, 2, 2.5)
    kernel = Predictor(cfg, mods, pack, device="cuda")
    plain = Predictor(cfg, mods, pack, device="cuda", use_kernel=False)
    x = np.abs(np.random.RandomState(3).randn(64, 512)).astype(np.float32)
    before = fused_eval_exchange.launches
    got = kernel.predict(x)
    assert fused_eval_exchange.launches == before + 1
    # Captured on the second request, replayed on the third: the same
    # answers, one launch each.
    for n in (2, 3):
        again = kernel.predict(x)
        assert fused_eval_exchange.launches == before + n
        for k, v in got.items():
            np.testing.assert_array_equal(again[k], v)
    before += 2
    want = plain.predict(x)
    assert fused_eval_exchange.launches == before + 1
    assert got["n_steps"] == want["n_steps"] > 1
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_array_equal(got["sender_messages"],
                                  want["sender_messages"])
    np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                               atol=1e-5)


# ---- Train mode ---------------------------------------------------------

TRAIN_VARIANTS = {"adaptive": {}, "fixed": dict(fixed_exchange=True),
                  "prod": dict(sender_mix="prod"),
                  "ignore_code": dict(ignore_code=True),
                  "ignore_receiver": dict(ignore_receiver=True),
                  "flipout": dict(flipout_sen=0.1, flipout_rec=0.1)}


def _numpy_uniforms(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.rand(cfg.max_exchange, batch, n)
                                .astype(np.float32)).cuda()
            for k, n in uniform_widths(cfg, train=True).items()}


def _check_train(cfg, params, data, desc, mode):
    """One launch in ``mode``: given uniforms, Philox keyed by value, or
    Philox keyed by the device tensor ``[seed, step, row_base]`` (which
    must also equal the by-value launch bit for bit)."""
    batch = data.shape[0]
    with torch.inference_mode():
        if mode == "uniforms":
            u = _numpy_uniforms(cfg, batch, batch)
            got = fused_train_forward(cfg, params, data, desc, uniforms=u)
        else:
            u = philox_uniforms(cfg, batch, 7, 3, device="cuda")
            got = fused_train_forward(cfg, params, data, desc, seed=7,
                                      step=3)
            if mode == "key":
                by_value = got
                got = fused_train_forward(
                    cfg, params, data, desc,
                    key=torch.tensor([7, 3, 0], device="cuda"))
                for a, b in zip(got, by_value):
                    assert torch.equal(a, b)
        want = fused_train_forward_reference(cfg, params, data, desc, u)
    torch.cuda.synchronize()
    rep = compare_outputs(cfg, got, want, uniforms=u)
    assert rep["ok"], rep
    return got


@pytest.mark.parametrize("mode", ["uniforms", "philox", "key"])
@pytest.mark.parametrize("batch", [1, 8, 13])
@pytest.mark.parametrize("name", list(TRAIN_VARIANTS))
def test_train_kernel_matches_plain_version(cuda, name, batch, mode):
    cfg, mods, data, desc = _case(SMALL, batch, 5, stop_bias=0.0,
                                  **TRAIN_VARIANTS[name])
    _check_train(cfg, kernel_params(mods), data, desc, mode)


@pytest.mark.parametrize("mode", ["uniforms", "philox", "key"])
def test_train_kernel_matches_plain_version_canonical_width(cuda, mode):
    cfg, mods, data, desc = _case(CANON, 64, 30, seed=1, stop_bias=0.0)
    got = _check_train(cfg, kernel_params(mods), data, desc, mode)
    assert got.y.shape == (10, 64, 30)
    # Sampled, not rounded: some bits disagree with rounding.
    assert (got.sen_feats != torch.floor(got.sen_probs + 0.5)).any()


@pytest.mark.parametrize("dims, batch, split", [(SMALL, 13, 6),
                                                 (CANON, 64, 32)],
                         ids=["small_ragged", "canonical"])
def test_train_kernel_row_base_numbers_a_shards_rows(cuda, dims, batch,
                                                     split):
    """Two Philox launches over a batch's rows, the second numbered from
    ``row_base``, equal one launch over the batch, and each its plain
    version at that ``row_base``."""
    cfg, mods, data, desc = _case(dims, batch, 5, stop_bias=0.0)
    params = kernel_params(mods)
    with torch.inference_mode():
        whole = fused_train_forward(cfg, params, data, desc, seed=7,
                                    step=3)
        parts = []
        for lo, hi in ((0, split), (split, batch)):
            got = fused_train_forward(cfg, params, data[lo:hi], desc,
                                      seed=7, step=3, row_base=lo)
            u = philox_uniforms(cfg, hi - lo, 7, 3, device="cuda",
                                row_base=lo)
            want = fused_train_forward_reference(cfg, params, data[lo:hi],
                                                 desc, u)
            rep = compare_outputs(cfg, got, want, uniforms=u)
            assert rep["ok"], rep
            parts.append(got)
    torch.cuda.synchronize()
    for k in ("sen_feats", "rec_feats", "stop_feats", "masks"):
        assert torch.equal(torch.cat([getattr(p, k) for p in parts], 1),
                           getattr(whole, k)), k
    for k in ("sen_probs", "rec_probs", "stop_probs", "y"):
        torch.testing.assert_close(
            torch.cat([getattr(p, k) for p in parts], 1), getattr(whole, k),
            rtol=0, atol=1e-5)


def test_train_kernel_device_key_is_read_when_it_runs(cuda):
    """A launch recorded in a CUDA graph under ``key=`` draws the numbers
    of the key as the device holds it at each replay."""
    cfg, mods, data, desc = _case(SMALL, 8, 5, stop_bias=0.0)
    params = kernel_params(mods)
    key = torch.tensor([7, 3, 0], device="cuda")
    with torch.inference_mode():
        fused_train_forward(cfg, params, data, desc, key=key)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fused_train_forward(cfg, params, data, desc, key=key)
        for step in (3, 4, 9):
            key[1] = step
            graph.replay()
            want = fused_train_forward(cfg, params, data, desc, seed=7,
                                       step=step)
            torch.cuda.synchronize()
            for a, b in zip(static, want):
                assert torch.equal(a, b)


def test_graph_route_replays_equal_eager_steps(cuda):
    """The bare trainer on the graph route (two eager warm-up steps, then
    replays) against the eager route from the same seed: weights and
    scalars equal after every step, one launch a step either way."""
    cfg = GameConfig(**SMALL, entropy_s=0.08, entropy_sen=0.01,
                     entropy_rec=0.01, baseline_hid_dim=16)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(40, 64).astype(np.float32)).cuda()
    targets = torch.from_numpy(rng.randint(0, 5, 40)).cuda()
    desc = torch.from_numpy(rng.randn(5, 24).astype(np.float32)).cuda()
    idx = np.stack([rng.permutation(40)[:8] for _ in range(6)])
    runs = []
    for graph in (False, True):
        mods = init_params(AgentModules(cfg), seed=0, device="cuda")
        chunk = make_multistep_train_step_indexed(
            mods, 2, 8, fast="kernel", seed=3, device="cuda", graph=graph)
        opts = init_opt_states(cfg, mods)
        before = fused_train_forward.launches
        steps = []
        for i in range(6):
            m = chunk(opts, feats, targets, idx[i:i + 1], desc, i)
            steps.append((torch.stack(list(m)).cpu(),
                          [p.detach().cpu().clone()
                           for p in mods.parameters()]))
        assert fused_train_forward.launches == before + 6
        runs.append(steps)
    for (ma, pa), (mb, pb) in zip(*runs):
        assert torch.equal(ma, mb)
        assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def nccl_rank_steps(mesh) -> dict:
    """On a one-rank NCCL mesh, six steps of the small game one a chunk
    through the train kernel, eagerly and on the graph route from the
    same seed: the scalars and weights after every step, the kernel's
    launches, the mesh's collective calls and the replays of each."""
    from multimodalgame_tpu_torch.game.train import step_route
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    cfg = GameConfig(**SMALL, entropy_s=0.08, entropy_sen=0.01,
                     entropy_rec=0.01, baseline_hid_dim=16,
                     optim_type="Adam")
    rng = np.random.RandomState(0)
    dev = mesh.device
    feats = torch.from_numpy(rng.randn(40, 64).astype(np.float32)).to(dev)
    targets = torch.from_numpy(rng.randint(0, 5, 40)).to(dev)
    desc = torch.from_numpy(rng.randn(5, 24).astype(np.float32)).to(dev)
    idx = np.stack([rng.permutation(40)[:8] for _ in range(6)])
    out = {"route": step_route(dev, mesh)}
    for graph in (False, True):
        mods = init_params(AgentModules(cfg), seed=0, device=dev)
        chunk = make_multistep_train_step_indexed(
            mods, 2, 8, fast="kernel", seed=3, mesh=mesh, graph=graph)
        opts = init_opt_states(cfg, mods)
        launches, calls = fused_train_forward.launches, mesh.calls
        replays, steps = Captured.replays, []
        for i in range(6):
            m = chunk(opts, feats, targets, idx[i:i + 1], desc, i)
            steps.append((torch.stack(list(m)).cpu(),
                          [p.detach().cpu().clone()
                           for p in mods.parameters()]))
        out[graph] = dict(steps=steps,
                          launches=fused_train_forward.launches - launches,
                          calls=mesh.calls - calls,
                          replays=Captured.replays - replays)
    return out


def test_nccl_mesh_graph_replays_equal_eager_steps(cuda):
    """A rank of an NCCL mesh takes the graph route, its collectives
    inside the graph: replays equal the eager mesh steps after every
    step, with the same launches and collective calls."""
    from multimodalgame_tpu_torch.parallel.distributed import launch
    got, = launch(nccl_rank_steps, ["cuda:0"], backend="nccl", timeout=300)
    assert got["route"] == "graph"
    eager, graph = got[False], got[True]
    assert graph["replays"] == 4 and eager["replays"] == 0
    assert eager["launches"] == graph["launches"] == 6
    assert eager["calls"] == graph["calls"] > 0
    for (ma, pa), (mb, pb) in zip(eager["steps"], graph["steps"]):
        assert torch.equal(ma, mb)
        assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_population_graph_replays_equal_eager_steps(cuda):
    """A population of three on the graph route (two eager warm-up steps,
    then replays, the carry passed back) against the eager route from the
    same seed: weights, slots and scalars equal after every step, and the
    dev batch's graph equal to the eager batch at two shapes."""
    from multimodalgame_tpu_torch.parallel.population import (
        init_population, init_population_opt_states, make_population_eval,
        make_population_train_step)
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    cfg = GameConfig(**SMALL, entropy_s=0.08, entropy_sen=0.01,
                     entropy_rec=0.01, baseline_hid_dim=16,
                     optim_type="Adam")
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(40, 64).astype(np.float32)).cuda()
    targets = torch.from_numpy(rng.randint(0, 5, 40)).cuda()
    desc = torch.from_numpy(rng.randn(5, 24).astype(np.float32)).cuda()
    idx = np.stack([rng.permutation(40)[:8] for _ in range(6)])
    runs, replays = [], Captured.replays
    for graph in (False, True):
        pop = init_population(cfg, 0, 3, "cuda")
        opts = init_population_opt_states(cfg, pop)
        chunk = make_population_train_step(AgentModules(cfg).cuda(), 2, 8,
                                           seed=3, graph=graph)
        steps = []
        for i in range(6):
            pop, opts, m = chunk(pop, opts, feats, targets, idx[i:i + 1],
                                 desc, i, lr_scale=[0.5, 1, 2])
            steps.append((torch.stack(list(m)).cpu(),
                          [v.cpu() for v in pop.values()],
                          [t.cpu() for st in opts.values()
                           for v in st.values()
                           for t in (v if isinstance(v, list) else [v])]))
        runs.append((steps, pop))
    assert Captured.replays == replays + 4
    for (ma, pa, sa), (mb, pb, sb) in zip(runs[0][0], runs[1][0]):
        assert torch.equal(ma, mb)
        assert all(torch.equal(a, b) for a, b in zip(pa + sa, pb + sb))
    pop = runs[1][1]
    evals = {g: make_population_eval(AgentModules(cfg).cuda(), 2, graph=g)
             for g in (False, True)}
    for rows in (slice(0, 8), slice(8, 11)):
        want = evals[False](pop, feats[rows], targets[rows], desc)
        for _ in range(3):
            assert torch.equal(evals[True](pop, feats[rows], targets[rows],
                                           desc), want)


def test_plain_eval_graph_replays_equal_eager(cuda):
    """The AdaptiveAttention preset's dev batch (100 maps of 512 x 8 x 8,
    the fc context of 1,000, 30 classes, 10 turns) on the plain route's
    graph: an eager warm-up, then the capture and three replays, each
    record and answer bit for bit the eager conversation's, one replay a
    call after the warm-up."""
    from multimodalgame_tpu_torch.game.train import (answer_scores,
                                                     make_eval_exchange)
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    cfg = GameConfig(**CANON, visual_attn=True, attn_extra_context=True,
                     attn_dim=256, attn_context_dim=1000)
    mods = _agents(cfg, 4, 2.5)
    rng = np.random.RandomState(4)
    data = torch.from_numpy(
        rng.randn(100, 512, 8, 8).astype(np.float32)).cuda()
    ctx = torch.from_numpy(rng.randn(100, 1000).astype(np.float32)).cuda()
    desc = torch.from_numpy(rng.randn(30, 100).astype(np.float32)).cuda()
    eager = make_eval_exchange(mods, graph=False)
    graph = make_eval_exchange(mods)
    with torch.no_grad():
        want = eager(data, desc, data_context=ctx)
        dist = answer_scores(cfg, want)
        graph(data, desc, data_context=ctx)
        replays = Captured.replays
        for n in (1, 2, 3):
            got, got_dist = graph(data, desc, data_context=ctx, answer=True)
            assert Captured.replays == replays + n
            for f in want._fields:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert torch.equal(got_dist, dist)
    assert int(want.n_steps) > 1
    assert graph.routes == {"kernel_graph": 0, "plain_graph": 4, "eager": 0}


def test_capture_outlives_graphs_collected_as_garbage(cuda):
    """Graphs dropped as cyclic garbage (a Captured and its body's owner
    refer to each other) are not freed in the middle of another graph's
    capture, which would invalidate it, however often the collector
    would run."""
    import gc

    from multimodalgame_tpu_torch.utils.cuda_graph import Captured

    class Owner:
        def __init__(self):
            self.x = torch.ones(4, device="cuda")
            self.run = Captured(self.body, torch.device("cuda"), warmup=0)

        def body(self):
            junk = [[i] for i in range(2000)]   # allocations, for the GC
            return self.x * 2 + len(junk)

    thresholds = gc.get_threshold()
    try:
        for _ in range(3):
            Owner().run()               # captured, then dropped in a cycle
        gc.set_threshold(1, 1, 1)
        out, replayed = Owner().run()
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*thresholds)
    assert replayed and torch.equal(out, torch.full((4,), 2002.0,
                                                    device="cuda"))


def test_train_kernel_each_call_is_one_launch(cuda):
    cfg, mods, data, desc = _case(SMALL, 8, 5)
    params = kernel_params(mods)
    u = _numpy_uniforms(cfg, 8, 0)
    before = fused_train_forward.launches
    fused_train_forward(cfg, params, data, desc, uniforms=u)
    fused_train_forward(cfg, params, data, desc, seed=1, step=2)
    assert fused_train_forward.launches == before + 2


def test_train_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cfg, mods, data, desc = _case(SMALL, 8, 5)
    params = kernel_params(mods)
    u = _numpy_uniforms(cfg, 8, 0)
    bad = [
        dict(uniforms={**u, "z": u["z"][:, :4].contiguous()}),
        dict(uniforms={**u, "w": u["w"].double()}),
        dict(uniforms={**u, "s": u["s"].cpu()}),
        dict(uniforms={k: v for k, v in u.items() if k != "s"}),
        dict(uniforms={**u, "fz": u["z"]}),
        dict(uniforms=u, seed=1, step=0),
        dict(),
        dict(seed=1),
        dict(seed=2 ** 32, step=0),
        dict(seed=1, step=0, row_base=-1),
        dict(uniforms=u, row_base=8),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            fused_train_forward(cfg, params, data, desc, **kw)
    continuous = GameConfig(**{**SMALL, "use_binary": False})
    with pytest.raises(ValueError):
        fused_train_forward(continuous, params, data, desc, seed=1, step=0)


def test_training_steps_launch_the_kernel_once_each(cuda):
    cfg = GameConfig(**SMALL, entropy_s=0.08, entropy_sen=0.01,
                     entropy_rec=0.01, baseline_hid_dim=16)
    mods = init_params(AgentModules(cfg), seed=0, device="cuda")
    chunk = make_multistep_train_step_indexed(mods, 2, 8, fast="kernel",
                                              seed=3, device="cuda")
    opts = init_opt_states(cfg, mods)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(40, 64).astype(np.float32)).cuda()
    targets = torch.from_numpy(rng.randint(0, 5, 40)).cuda()
    desc = torch.from_numpy(rng.randn(5, 24).astype(np.float32)).cuda()
    idx = np.stack([rng.permutation(40)[:8] for _ in range(5)])
    before = fused_train_forward.launches
    m = chunk(opts, feats, targets, idx, desc, 0)
    torch.cuda.synchronize()
    assert fused_train_forward.launches == before + 5
    assert torch.isfinite(m.loss_rec).all() and m.loss_rec.shape == (5,)


# ---- Launch plans: clusters, ragged tiles, weights in device memory ----

# The flags' defaults (F 4096, H 100, W 50, R 128) with 100 classes: a
# cluster of more than 2 CTAs, a ragged last tile at batch 37, widths that
# are no multiple of the split. TOO_LARGE: weights that do not all fit in
# the shared memory of 8 CTAs, so the plan reads some from device memory.
DEFAULTS = dict(img_feat_dim=4096, img_h_dim=100, sender_out_dim=50,
                rec_w_dim=50, rec_hidden=128, wv_dim=100, max_exchange=3,
                fixed_exchange=False)
TOO_LARGE = dict(img_feat_dim=512, img_h_dim=512, sender_out_dim=128,
                 rec_w_dim=128, rec_hidden=512, wv_dim=100, max_exchange=4,
                 fixed_exchange=False)
PLAN_CASES = {"defaults_100_classes": (DEFAULTS, 37, 100),
              "too_large_for_8": (TOO_LARGE, 37, 30),
              "canonical": (CANON, 64, 30)}


def _plan_case(name, stop_bias):
    dims, batch, num_desc = PLAN_CASES[name]
    cfg, mods, data, desc = _case(dims, batch, num_desc, seed=4,
                                  stop_bias=stop_bias)
    plan = plan_for(cfg, batch, num_desc)
    if name == "defaults_100_classes":
        assert plan.cluster > 2 and batch % ROWS != 0
    if name == "too_large_for_8":
        assert plan.cluster == 8 and plan.in_device_memory
    return cfg, kernel_params(mods), data, desc


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_kernel_matches_plain_version_across_plans(cuda, name):
    cfg, params, data, desc = _plan_case(name, stop_bias=2.5)
    before = fused_eval_exchange.launches
    _check(cfg, params, data, desc)
    assert fused_eval_exchange.launches == before + 1


@pytest.mark.parametrize("mode", ["uniforms", "philox", "key"])
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_train_kernel_matches_plain_version_across_plans(cuda, name, mode):
    cfg, params, data, desc = _plan_case(name, stop_bias=0.0)
    before = fused_train_forward.launches
    _check_train(cfg, params, data, desc, mode)
    # The key mode launches once more: by value, then under the key.
    assert fused_train_forward.launches == before + (2 if mode == "key"
                                                     else 1)


@pytest.mark.parametrize("train", [False, True])
def test_instances_report_their_registers(cuda, train):
    """Both instances fit the 255 registers of a thread at one CTA an SM
    (``__launch_bounds__(256, 1)``)."""
    regs = kernel_registers(train)
    assert 0 < regs["registers"] <= 255 and regs["local_bytes"] >= 0


def test_plans_that_do_not_fit_are_refused(cuda):
    cfg, mods, data, desc = _case(CANON, 8, 30)
    params = kernel_params(mods)
    eval_before = fused_eval_exchange.launches
    plan = plan_for(cfg, 8, 30)
    # A carve the kernel does not recompute: refused by the C side.
    with pytest.raises(RuntimeError):
        _eval_launch(cfg, params, data, desc, None,
                     plan._replace(smem_bytes=plan.smem_bytes + 16))
    # Every matrix of TOO_LARGE held by 4 CTAs needs more than the card's
    # opt-in shared memory: refused by the C side.
    big_cfg, big_mods, big_data, big_desc = _case(TOO_LARGE, 8, 30)
    big = launch_plan(512, 512, 128, 512, 30, 100, 8, smem_limit=10 ** 7)
    assert big.smem_bytes > 232448 and big.in_device_memory == ()
    with pytest.raises(RuntimeError):
        _eval_launch(big_cfg, kernel_params(big_mods), big_data, big_desc,
                     None, big)
    # Nothing fits at all: refused by the planner, before any launch.
    huge = GameConfig(img_feat_dim=64, img_h_dim=2048, sender_out_dim=512,
                      rec_w_dim=512, rec_hidden=1024, wv_dim=300,
                      max_exchange=2)
    mods = init_params(AgentModules(huge), seed=0, device="cuda")
    data = torch.zeros(4, 64, device="cuda")
    desc = torch.zeros(100, 300, device="cuda")
    with pytest.raises(ValueError):
        fused_eval_exchange(huge, kernel_params(mods), data, desc)
    with pytest.raises(ValueError):
        fused_train_forward(huge, kernel_params(mods), data, desc, seed=0,
                            step=0)
    assert fused_eval_exchange.launches == eval_before
