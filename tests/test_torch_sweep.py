"""The port's population sweep (``sweep.py``) against the JAX package's,
on the CPU.

``run_sweep`` end to end on the synthetic set: N = 3 members at learning-
rate scales 0.5 and 1 (cycled), a population of one (the single-game
trainer, the train kernel's plain version on the CPU, the scale folded
into the learning rate) and FixedAttention at N = 2. The two packages
draw different random numbers (PRNG keys against Philox), so the runs
are held to the same structure: the member lines, the winner and the
summary's keys, the steps and the learning-rate scales. The winner's
``_best`` is the JAX package's single-game msgpack file, which JAX's
strict ``load_checkpoint`` restores and ``-eval_only`` scores at the
winner's final dev accuracy.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.sweep import parse_lr_scales as jax_parse_lr_scales
from multimodalgame_tpu.sweep import run_sweep as jax_run_sweep
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from multimodalgame_tpu_torch import sweep
from multimodalgame_tpu_torch.game.agents import AGENT_NAMES
from multimodalgame_tpu_torch.sweep import parse_lr_scales, run_sweep
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                       read_checkpoint)
from multimodalgame_tpu_torch.utils.torch_interop import (
    params_to_torch_state)
from tests.port_runs import jax_flags, port_flags

SUMMARY_KEYS = {"population", "steps", "winner", "winner_best_dev_acc",
                "winner_final_dev_acc", "wall_seconds",
                "steps_per_sec_total", "checkpoint", "members"}
MEMBER_KEYS = {"member", "lr_scale", "final_dev_acc", "best_dev_acc"}


def sweep_argv(paths, log_path, name, extra=()):
    """JAX tests/test_population.py's sweep flags."""
    return [
        "-experiment_name", name, "-model_type", "Adaptive",
        "-log_path", str(log_path),
        "-batch_size", "8", "-batch_size_dev", "8",
        "-rec_w_dim", "8", "-sender_out_dim", "8",
        "-img_h_dim", "16", "-rec_hidden", "16", "-baseline_hid_dim", "16",
        "-max_exchange", "3", "-max_epoch", "2",
        "-top_k_dev", "2", "-top_k_train", "2",
        "-descr_train", paths["descr"], "-descr_dev", paths["descr"],
        "-train_file", paths["train"], "-dev_file", paths["dev"],
        "-wv_dim", "16", "-glove_path", paths["glove"],
        "-branch", "main", "-sha", "0"] + list(extra)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _same_shape(got, want):
    assert set(got) == set(want) == SUMMARY_KEYS
    for k in ("population", "steps"):
        assert got[k] == want[k], k
    assert [m["member"] for m in got["members"]] == \
        [m["member"] for m in want["members"]]
    assert [m["lr_scale"] for m in got["members"]] == \
        [m["lr_scale"] for m in want["members"]]
    for m in got["members"]:
        assert set(m) == MEMBER_KEYS
        assert 0.0 <= m["final_dev_acc"] <= m["best_dev_acc"] <= 1.0
    assert 0 <= got["winner"] < got["population"]
    best = [m["best_dev_acc"] for m in got["members"]]
    assert got["winner"] == int(np.argmax(best))
    assert got["winner_best_dev_acc"] == best[got["winner"]]


def _check_winner_checkpoint(flags, summary, paths, tmp_path):
    """The winner's ``_best`` is msgpack, JAX restores it strictly; the
    port's -eval_only scores it at the winner's final dev accuracy."""
    path = flags.checkpoint + "_best"
    assert summary["checkpoint"] == path
    assert checkpoint_format(path) == "msgpack"
    payload = read_checkpoint(path)
    assert payload["data"]["step"] == summary["steps"]
    assert payload["data"]["final_dev_acc"] == summary[
        "winner_final_dev_acc"]
    jf = jax_flags(sweep_argv(paths, tmp_path / "jax_read", "read"))
    jmods = JaxModules(JaxConfig.from_flags(jf))
    template = jax_init_params(jmods, jax.random.PRNGKey(0), num_classes=6)
    data, params, _ = jax_load_checkpoint(
        path, template, jax_init_opt_states(jmods.cfg, template))
    assert data["step"] == summary["steps"]
    assert data["final_dev_acc"] == summary["winner_final_dev_acc"]
    got = params_to_torch_state(jax.tree_util.tree_map(np.asarray, params))
    for agent in AGENT_NAMES:
        for name, v in payload["models"][agent].items():
            np.testing.assert_array_equal(got[agent][name], v.numpy())
    eval_flags = port_flags(sweep_argv(paths, tmp_path / "eval", "ev",
                                       ["-eval_only", "-checkpoint", path]))
    out = run(eval_flags, device="cpu")
    assert out["dev_acc"] == summary["winner_final_dev_acc"]


def test_parse_lr_scales_matches_jax():
    assert parse_lr_scales(None, 4) is None
    for spec, n in (("0.5,1,2", 5), ("4", 3), ("0.5, 1,", 4)):
        np.testing.assert_array_equal(parse_lr_scales(spec, n),
                                      jax_parse_lr_scales(spec, n))


def test_sweep_matches_jax(synthetic_dataset, tmp_path, capsys):
    paths = synthetic_dataset
    extra = ["-population", "3", "-lr_scales", "0.5,1"]
    jf = jax_flags(sweep_argv(paths, tmp_path / "jax", "sw", extra))
    want = jax_run_sweep(jf, max_steps=6, eval_every=3)
    want_lines = _lines(capsys)
    pf = port_flags(sweep_argv(paths, tmp_path / "port", "sw", extra))
    got = run_sweep(pf, max_steps=6, eval_every=3, device="cpu")
    got_lines = _lines(capsys)
    _same_shape(got, want)
    assert len(got_lines) == len(want_lines) == 4
    assert [set(m) for m in got_lines[:3]] == [set(m) for m in
                                               want_lines[:3]]
    assert got_lines[:3] == got["members"]
    assert set(got_lines[3]) == set(want_lines[3]) == SUMMARY_KEYS - {
        "members"}
    assert [m["lr_scale"] for m in got_lines[:3]] == [0.5, 1.0, 0.5]
    log = open(pf.log_file).read()
    assert log.count("per-member dev acc") == 2
    assert "Population sweep: 3 members" in log and "Sweep summary" in log
    _check_winner_checkpoint(pf, got, paths, tmp_path)


def test_population_of_one_trains_the_single_game(synthetic_dataset,
                                                  tmp_path, capsys,
                                                  monkeypatch):
    """-population 1 takes the single-game indexed trainer with the train
    kernel's sampler (its plain version on CPU tensors) and the scale in
    the learning rate; the population trainer is not built."""
    import multimodalgame_tpu_torch.game.fast_train as fast_train

    def boom(*a, **k):
        raise AssertionError("population trainer built for N = 1")

    calls = []
    real = fast_train.fused_train_forward
    monkeypatch.setattr(sweep, "make_population_train_step", boom)
    monkeypatch.setattr(fast_train, "fused_train_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    paths = synthetic_dataset
    extra = ["-population", "1", "-lr_scales", "0.5"]
    jf = jax_flags(sweep_argv(paths, tmp_path / "jax", "one", extra))
    want = jax_run_sweep(jf, max_steps=6, eval_every=3)
    capsys.readouterr()
    pf = port_flags(sweep_argv(paths, tmp_path / "port", "one", extra))
    got = run_sweep(pf, max_steps=6, eval_every=3, device="cpu")
    assert len(_lines(capsys)) == 2
    _same_shape(got, want)
    assert got["members"][0]["lr_scale"] == 0.5
    assert len(calls) == 6
    payload = read_checkpoint(pf.checkpoint + "_best")
    # RMSprop slots travel with the winner.
    assert payload["optimizers"]["sender"]["state"]
    _check_winner_checkpoint(pf, got, paths, tmp_path)


def test_attention_sweep(synthetic_dataset, tmp_path, capsys):
    """FixedAttention at N = 2: visual attention over layer4_2 with the fc
    context, batched over the members."""
    paths = synthetic_dataset
    extra = ["-population", "2", "-model_type", "FixedAttention",
             "-attn_dim", "16"]
    pf = port_flags(sweep_argv(paths, tmp_path / "port", "attn", extra))
    assert pf.img_feat == "layer4_2" and pf.attn_extra_context
    got = run_sweep(pf, max_steps=3, eval_every=3, device="cpu")
    assert got["steps"] == 3 and got["population"] == 2
    assert len(_lines(capsys)) == 3
    assert all(np.isfinite(m["final_dev_acc"]) for m in got["members"])
    payload = read_checkpoint(pf.checkpoint + "_best")
    assert "attn_W_g.weight" in payload["models"]["sender"]


def test_set_smaller_than_a_batch(synthetic_dataset, tmp_path):
    pf = port_flags(sweep_argv(synthetic_dataset, tmp_path, "tiny",
                               ["-population", "2", "-batch_size", "4096"]))
    got = run_sweep(pf, max_steps=4, eval_every=2, device="cpu")
    assert got["steps"] == 0 and len(got["members"]) == 2


def test_sweep_refuses_a_mesh(synthetic_dataset, tmp_path):
    """The sweep refuses tensor parallelism (a ``ValueError``: it splits
    members only; JAX's sweep ignores the flag); under ``-ckpt_format
    orbax`` it writes the winner's ``_best`` as an Orbax directory,
    committed when it returns."""
    from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                           read_checkpoint)
    pf = port_flags(sweep_argv(synthetic_dataset, tmp_path, "mesh",
                               ["-population", "2", "-mesh_model", "2"]))
    with pytest.raises(ValueError, match="splits its members"):
        run_sweep(pf, device="cpu")
    pf = port_flags(sweep_argv(synthetic_dataset, tmp_path, "orbax",
                               ["-population", "2", "-ckpt_format",
                                "orbax"]))
    got = run_sweep(pf, max_steps=4, eval_every=2, device="cpu")
    best = pf.checkpoint + "_best"
    assert checkpoint_format(best) == "orbax"
    assert not os.path.exists(best + ".staging")
    data = read_checkpoint(best)["data"]
    assert data["step"] == got["steps"]
    assert data["best_dev_acc"] == got["winner_best_dev_acc"]


def test_sweep_refuses_cifar(synthetic_dataset, tmp_path):
    """The sweep stages feature files only: ``-images cifar`` raises,
    at every population size, rather than being ignored."""
    for n in ("1", "2"):
        pf = port_flags(sweep_argv(synthetic_dataset, tmp_path, "cifar",
                                   ["-population", n, "-images", "cifar"]))
        with pytest.raises(NotImplementedError, match="§1.10.4"):
            run_sweep(pf, device="cpu")


def test_python_m_sweep_needs_a_card(synthetic_dataset, tmp_path):
    """``python -m multimodalgame_tpu_torch.sweep`` runs on cuda, and
    without a card it fails with the device error, not later."""
    out = subprocess.run(
        [sys.executable, "-m", "multimodalgame_tpu_torch.sweep"]
        + sweep_argv(synthetic_dataset, tmp_path, "cli",
                     ["-population", "2"]),
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
