"""``train.run -mesh 2``: the chunked driver over two gloo ranks on the
CPU against the port's single-device run, held as JAX's mesh driver is
held against its single device (tests/test_mesh_driver.py:57-111): the
accuracy stream, the weights (rtol 5e-3, atol 1e-5; ``receiver.y2.bias``
excluded, as there), the logged metric history and rank 0's log line for
line. tests/test_torch_driver.py holds the single-device run against
JAX's line for line. Also ``-mesh -1`` over a two-device list with a
ragged final dev batch, and ``-eval_only -mesh 2`` against the
single-device ``-eval_only``. Rank 0's checkpoint is the JAX package's
msgpack file, as the single device's is: JAX restores it strictly, its
data equal to the single device's and its weights within the mesh
tolerance.
"""

import os
import re

import jax
import numpy as np
import pytest

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                       read_checkpoint)
from multimodalgame_tpu_torch.utils.torch_interop import (
    params_to_torch_state)
from tests.port_runs import jax_flags, port_flags, small_argv

PARAM_RTOL, PARAM_ATOL = 5e-3, 1e-5


def _kinds(path):
    """The log's lines from the first epoch on, numbers replaced by
    ``#``, the mesh banner left out (tests/test_mesh_driver.py:96-107)."""
    rows = []
    for ln in open(path).read().splitlines():
        if "Data-parallel mesh" in ln:
            continue
        rows.append((ln, re.sub(r"[-+]?\d+\.?\d*(e[-+]?\d+)?", "#",
                                ln.split(": ", 1)[-1])))
    start = next(i for i, (raw, _) in enumerate(rows)
                 if "Starting epoch" in raw)
    return [k for _, k in rows[start:]]


def _assert_params_close(got, want):
    for (name, a), (_, b) in zip(got.named_parameters(),
                                 want.named_parameters()):
        if name == "receiver.y2.bias":
            continue
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


def _assert_history_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert [s for s, _ in got[k]] == [s for s, _ in want[k]], k
        np.testing.assert_allclose([v for _, v in got[k]],
                                   [v for _, v in want[k]], rtol=2e-2,
                                   atol=2e-3, err_msg=k)


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_driver")
    one = port_flags(small_argv(synthetic_dataset, root / "one", "one"))
    mesh = port_flags(small_argv(synthetic_dataset, root / "mesh", "mesh",
                                 ["-mesh", "2"]))
    return {"one": (one, run(one, max_steps=8, device="cpu")),
            "mesh": (mesh, run(mesh, max_steps=8, device="cpu"))}


def test_mesh_driver_matches_single_device(runs):
    f_one, r_one = runs["one"]
    f_mesh, r_mesh = runs["mesh"]
    assert r_one["step"] == r_mesh["step"] == 8
    np.testing.assert_allclose(r_mesh["batch_accuracy"],
                               r_one["batch_accuracy"], atol=1e-6)
    _assert_params_close(r_mesh["modules"], r_one["modules"])
    _assert_history_close(r_mesh["metrics"], r_one["metrics"])
    assert _kinds(f_mesh.log_file) == _kinds(f_one.log_file)
    assert "Data-parallel mesh: 2 devices (cpu, gloo)" in open(
        f_mesh.log_file).read()


def test_mesh_ranks_hold_equal_weights_and_keep_their_logs(runs):
    f_mesh, r_mesh = runs["mesh"]
    a, b = (r["modules"] for r in r_mesh["ranks"])
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert (p == q).all(), name
    # Rank 1 writes its own log, the same lines as rank 0's; the
    # checkpoints are rank 0's alone.
    assert _kinds(f_mesh.log_file + ".p1") == _kinds(f_mesh.log_file)
    assert os.path.exists(f_mesh.checkpoint)
    assert not os.path.exists(f_mesh.checkpoint + ".p1")
    # One gradient all-reduce a step on each rank.
    assert [r["collectives"]["grad_calls"] for r in r_mesh["ranks"]] == \
        [8, 8]


def test_mesh_checkpoint_restores_as_the_single_device_file(runs):
    """Rank 0's periodic file (step 4) and its _best: msgpack, restored by
    JAX's strict ``load_checkpoint`` to the weights the port reads, with
    the single device's data and its weights within the mesh tolerance."""
    f_one, _ = runs["one"]
    f_mesh, _ = runs["mesh"]
    jf = jax_flags(small_argv({"descr": "", "train": "", "dev": "",
                               "glove": ""}, f_mesh.log_path, "jax"))
    jmods = JaxModules(JaxConfig.from_flags(jf))
    template = jax_init_params(jmods, jax.random.PRNGKey(0), num_classes=6)
    for suffix in ("", "_best"):
        paths = [f.checkpoint + suffix for f in (f_mesh, f_one)]
        assert [checkpoint_format(p) for p in paths] == ["msgpack"] * 2
        got, want = (read_checkpoint(p) for p in paths)
        assert got["data"] == want["data"]
        data, params, _ = jax_load_checkpoint(
            paths[0], template, jax_init_opt_states(jmods.cfg, template))
        assert data == got["data"]
        state = params_to_torch_state(jax.tree_util.tree_map(np.asarray,
                                                             params))
        for agent, sd in got["models"].items():
            for k, v in sd.items():
                np.testing.assert_array_equal(state[agent][k], v.numpy())
                if k != "y2.bias":
                    np.testing.assert_allclose(
                        v.numpy(), want["models"][agent][k].numpy(),
                        rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
            assert got["optimizers"][agent]["state"].keys() == \
                want["optimizers"][agent]["state"].keys()


def test_eval_only_on_a_mesh_matches_one_device(runs, synthetic_dataset,
                                                tmp_path):
    f_mesh, _ = runs["mesh"]
    got = {}
    for name, extra in (("one", []), ("mesh", ["-mesh", "2"])):
        flags = port_flags(small_argv(
            synthetic_dataset, tmp_path / name, "eval",
            ["-eval_only", "-checkpoint", f_mesh.checkpoint + "_best"]
            + extra))
        got[name] = (flags, run(flags, device="cpu"))
    (f1, one), (f2, two) = got["one"], got["mesh"]
    assert two["dev_acc"] == one["dev_acc"]
    assert two["extra"] == one["extra"]
    assert open(f2.eval_csv_file).read() == open(f1.eval_csv_file).read()


def test_mesh_minus_one_over_a_device_list_with_a_ragged_dev_batch(
        synthetic_dataset, tmp_path):
    """``-mesh -1`` takes every device of the list; a dev set of 23 rows
    at ``-batch_size_dev 8`` ends in a batch of 7, which runs whole on
    both ranks."""
    paths = synthetic_dataset
    pack = load_descriptions(paths["descr"], "glove.6B", 16,
                             glove_path=paths["glove"])
    train = DeviceDataset.from_hdf5(paths["train"], "avgpool_512",
                                    map_labels=pack.map_labels,
                                    device="cpu")
    dev = DeviceDataset.from_hdf5(paths["dev"], "avgpool_512",
                                  map_labels=pack.map_labels, device="cpu")
    dev = DeviceDataset(dev.feats[:23], dev.targets_host[:23], device="cpu")
    inputs = (pack, pack, train, dev)
    out = {}
    for name, extra, device in (("one", [], "cpu"),
                                ("mesh", ["-mesh", "-1"], ["cpu", "cpu"])):
        flags = port_flags(small_argv(paths, tmp_path / name, name, extra))
        out[name] = (flags, run(flags, max_steps=8, device=device,
                                inputs=inputs))
    (f1, one), (f2, two) = out["one"], out["mesh"]
    assert len(two["ranks"]) == 2
    np.testing.assert_allclose(two["batch_accuracy"], one["batch_accuracy"],
                               atol=1e-6)
    _assert_history_close(two["metrics"], one["metrics"])
    assert _kinds(f2.log_file) == _kinds(f1.log_file)
