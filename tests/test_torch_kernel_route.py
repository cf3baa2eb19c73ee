"""Which conversation a call takes: the kernel where the config is one the
kernel supports *and* a launch plan fits the sizes, else the plain one
(``ops/cuda_exchange.py:eval_kernel_supports``,
``train_kernel_supports``).

At the big game (bench.py:511-520: 128-bit messages, sender hidden 1024,
receiver hidden 256, GloVe-300, 1,000 classes, batch 256) and its
500-class variants no plan fits 232,448 bytes of shared memory, so the
predicates say "plain"; at the canonical width and at chip_smoke.py's
PLAN_CASES they say "kernel". On the CPU the wrappers take their plain
versions and never ask for a plan, so the route is checked by spying on
the wrappers with a planner that finds nothing: the driver, the
``-nofast_driver`` loop, the sweep of one and ``make_eval_exchange`` all
consult it, as JAX gates its kernel on sizes (game/train.py:567).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import multimodalgame_tpu_torch.game.fast_train as fast_train
import multimodalgame_tpu_torch.game.train as game_train
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.ops import cuda_exchange
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    eval_kernel_supports, find_plan, launch_plan, supports_config,
    train_kernel_supports)
from tests.port_runs import port_flags, small_argv

BIG = dict(img_feat_dim=512, sender_out_dim=128, rec_w_dim=128,
           img_h_dim=1024, rec_hidden=256, wv_dim=300)


@pytest.mark.parametrize("hidden, classes", [(1024, 1000), (1024, 500),
                                             (512, 500)])
def test_no_plan_at_the_big_game(hidden, classes):
    cfg = GameConfig(**{**BIG, "img_h_dim": hidden})
    assert supports_config(cfg)     # the config alone would take it
    assert not eval_kernel_supports(cfg, 256, classes)
    assert not train_kernel_supports(cfg, 256, classes)
    assert find_plan(512, hidden, 128, 256, classes, 300, 256) is None
    with pytest.raises(ValueError, match="no launch plan"):
        launch_plan(512, hidden, 128, 256, classes, 300, 256)


def test_plans_at_the_canonical_width_and_the_plan_cases():
    cfg = GameConfig(**chip_smoke.CANON)
    for batch in (1, 64, 100):
        assert eval_kernel_supports(cfg, batch, chip_smoke.NUM_CLASSES)
        assert train_kernel_supports(cfg, batch, chip_smoke.NUM_CLASSES)
    plan = find_plan(512, 256, 32, 64, 30, 100, 64)
    assert plan == launch_plan(512, 256, 32, 64, 30, 100, 64)
    assert plan.cluster == 4 and plan.smem_bytes == 105696
    for dims, batch, classes in chip_smoke.PLAN_CASES.values():
        cfg = GameConfig(fixed_exchange=False, **dims)
        assert eval_kernel_supports(cfg, batch, classes)
        assert train_kernel_supports(cfg, batch, classes)
    # An empty batch has no plan; bfloat16 never samples in the kernel.
    assert not eval_kernel_supports(GameConfig(**chip_smoke.CANON), 0, 30)
    bf16 = GameConfig(**chip_smoke.CANON, compute_dtype="bfloat16")
    assert eval_kernel_supports(bf16, 64, 30)
    assert not train_kernel_supports(bf16, 64, 30)


@pytest.fixture
def spies(monkeypatch):
    """Counts of the two wrappers' calls on the CPU."""
    calls = {"train": 0, "eval": 0}
    real_train = fast_train.fused_train_forward
    real_eval = game_train.fused_eval_exchange

    def train_spy(*a, **k):
        calls["train"] += 1
        return real_train(*a, **k)

    def eval_spy(*a, **k):
        calls["eval"] += 1
        return real_eval(*a, **k)

    monkeypatch.setattr(fast_train, "fused_train_forward", train_spy)
    monkeypatch.setattr(game_train, "fused_eval_exchange", eval_spy)
    return calls


def _no_plan(monkeypatch):
    monkeypatch.setattr(cuda_exchange, "find_plan", lambda *a, **k: None)


@pytest.mark.parametrize("plan", [True, False], ids=["plan", "no_plan"])
@pytest.mark.parametrize("loop", [[], ["-nofast_driver"]],
                         ids=["driver", "nofast_driver"])
def test_training_loops_route_by_the_plan(plan, loop, spies, monkeypatch,
                                          synthetic_dataset, tmp_path):
    from multimodalgame_tpu_torch.train import run
    if not plan:
        _no_plan(monkeypatch)
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "route",
                                  loop))
    out = run(flags, max_steps=5, device="cpu")
    assert out["step"] == 5 and all(np.isfinite(out["batch_accuracy"]))
    log = open(flags.log_file).read()
    assert ("Phase A sampler: " + ("kernel" if plan else "plain")) in log
    assert spies["train"] == (5 if plan else 0)
    if plan:
        assert spies["eval"] > 0
    else:
        assert spies["eval"] == 0


@pytest.mark.parametrize("plan", [True, False], ids=["plan", "no_plan"])
def test_sweep_of_one_routes_by_the_plan(plan, spies, monkeypatch,
                                         synthetic_dataset, tmp_path):
    from multimodalgame_tpu_torch.sweep import run_sweep
    if not plan:
        _no_plan(monkeypatch)
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "sweep",
                                  ["-population", "1", "-lr_scales", "1"]))
    got = run_sweep(flags, max_steps=4, eval_every=2, device="cpu")
    assert got["steps"] == 4
    assert spies["train"] == (4 if plan else 0)
    assert (spies["eval"] > 0) == plan


def test_eval_exchange_asks_on_every_call(spies, monkeypatch):
    """The batch varies from call to call, so the plan is asked each
    time; the plain conversation gives the kernel path's answer."""
    cfg = GameConfig(**{**chip_smoke.CANON, "max_exchange": 3})
    mods = init_params(AgentModules(cfg), seed=0, device="cpu")
    run = game_train.make_eval_exchange(mods)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(4, 512).astype(np.float32))
    desc = torch.from_numpy(rng.randn(30, 100).astype(np.float32))
    with torch.no_grad():
        kernel = run(data, desc)
        assert spies["eval"] == 1
        sizes = []
        monkeypatch.setattr(cuda_exchange, "find_plan",
                            lambda *a, **k: sizes.append(a) or None)
        plain = run(data, desc)
        run(data[:3], desc)
    assert spies["eval"] == 1
    assert [s[-1] for s in sizes] == [4, 3]      # asked with each batch
    for k in ("sen_feats", "rec_feats", "stop_masks"):
        assert torch.equal(getattr(kernel, k), getattr(plain, k)), k
    np.testing.assert_allclose(kernel.y.numpy(), plain.y.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_kernel_sampler_raises_where_no_plan_fits(monkeypatch):
    cfg = GameConfig(**{**chip_smoke.CANON, "max_exchange": 3})
    mods = init_params(AgentModules(cfg), seed=0, device="cpu")
    step = game_train.make_train_step(mods, 2, 4, fast="kernel",
                                      device="cpu")
    opts = game_train.init_opt_states(cfg, mods)
    rng = np.random.RandomState(0)
    data = rng.randn(4, 512).astype(np.float32)
    desc = rng.randn(30, 100).astype(np.float32)
    _no_plan(monkeypatch)
    with pytest.raises(ValueError, match="no launch plan"):
        step(opts, data, rng.randint(0, 30, 4), desc, 0)
