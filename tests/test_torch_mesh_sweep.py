"""The population sweep with its members split over two gloo ranks on
the CPU (JAX sweep.py:121-145, ``shard_population``), against the same
sweep in one process: every member's dev accuracies, the winner and its
``_best`` (the JAX package's msgpack file, which JAX restores strictly).
A population the devices do not divide falls back to fewer
devices, and says so in the log, as JAX's sweep does.
"""

import jax
import numpy as np

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from multimodalgame_tpu_torch.sweep import run_sweep
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                       read_checkpoint)
from multimodalgame_tpu_torch.utils.torch_interop import (
    params_to_torch_state)
from tests.port_runs import jax_flags, port_flags, small_argv


def _accs(summary):
    return [(m["member"], m["lr_scale"], m["final_dev_acc"],
             m["best_dev_acc"]) for m in summary["members"]]


def test_split_sweep_matches_one_process(synthetic_dataset, tmp_path):
    paths = synthetic_dataset
    got = {}
    for name, device in (("one", "cpu"), ("mesh", ["cpu", "cpu"])):
        flags = port_flags(small_argv(paths, tmp_path / name, name, [
            "-population", "4", "-lr_scales", "0.5,1,2"]))
        got[name] = (flags, run_sweep(flags, max_steps=8, eval_every=4,
                                      device=device))
    (f1, one), (f2, two) = got["one"], got["mesh"]
    assert [r["rank"] for r in two["ranks"]] == [0, 1]
    assert two["steps"] == one["steps"] == 8
    assert _accs(two) == _accs(one)
    assert two["winner"] == one["winner"]
    # The winner's rank wrote its _best: the same weights as one process.
    a = read_checkpoint(f1.checkpoint + "_best")
    b = read_checkpoint(f2.checkpoint + "_best")
    assert a["data"] == b["data"]
    assert checkpoint_format(f2.checkpoint + "_best") == "msgpack"
    jf = jax_flags(small_argv(paths, tmp_path / "jax_read", "read"))
    jmods = JaxModules(JaxConfig.from_flags(jf))
    template = jax_init_params(jmods, jax.random.PRNGKey(0), num_classes=6)
    data, params, _ = jax_load_checkpoint(
        f2.checkpoint + "_best", template,
        jax_init_opt_states(jmods.cfg, template))
    assert data == b["data"]
    state = params_to_torch_state(jax.tree_util.tree_map(np.asarray, params))
    for agent, sd in b["models"].items():
        for k, v in sd.items():
            np.testing.assert_array_equal(state[agent][k], v.numpy())
    for agent, sd in a["models"].items():
        for k, v in sd.items():
            np.testing.assert_allclose(b["models"][agent][k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{agent}.{k}")
    # -eval_only on it scores the winner's final accuracy.
    ev = port_flags(small_argv(paths, tmp_path / "eval", "eval", [
        "-eval_only", "-checkpoint", f2.checkpoint + "_best"]))
    assert run(ev, device="cpu")["dev_acc"] == two["winner_final_dev_acc"]


def test_population_the_devices_do_not_divide_falls_back(synthetic_dataset,
                                                         tmp_path):
    paths = synthetic_dataset
    got = {}
    for name, device in (("one", "cpu"), ("three", ["cpu", "cpu"])):
        flags = port_flags(small_argv(paths, tmp_path / name, name,
                                      ["-population", "3"]))
        got[name] = (flags, run_sweep(flags, max_steps=4, eval_every=4,
                                      device=device))
    (_, one), (f3, three) = got["one"], got["three"]
    assert "ranks" not in three
    assert _accs(three) == _accs(one)
    assert ("Population 3 not divisible by 2 devices; sharding over a "
            "1-device mesh instead") in open(f3.log_file).read()
