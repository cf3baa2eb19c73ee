"""``train.run -mesh 4 -mesh_model 2``: the chunked driver on a (2 data x
2 model) grid of gloo ranks on the CPU against the port's single-device
run, held as JAX's mesh driver is held against its single device
(tests/test_mesh_driver.py:57-111): the accuracy stream, the weights
(rtol 5e-3, atol 1e-5; ``receiver.y2.bias`` excluded, as there), the
logged metric history and rank 0's log line for line. Its checkpoint
(the JAX package's msgpack file) is in the single-device layout (every
weight and optimizer slot whole), JAX's strict ``load_checkpoint``
restores it, a tensor-parallel run resumes from it, and ``-eval_only
-mesh 4 -mesh_model 2`` reproduces the single-device ``-eval_only``.
Also JAX's ``resolve_mesh`` errors, and the refusals of the sweep and of
serving.
"""

import os
import re
import shutil

import jax
import numpy as np
import pytest

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.driver import resolve_mesh as jax_resolve_mesh
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.utils import checkpoint as jax_checkpoint
from multimodalgame_tpu_torch.game.agents import AGENT_NAMES
from multimodalgame_tpu_torch.game.driver import resolve_mesh
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                       read_checkpoint)
from multimodalgame_tpu_torch.utils.torch_interop import (
    params_to_torch_state)
from tests.port_runs import jax_flags, port_flags, small_argv

PARAM_RTOL, PARAM_ATOL = 5e-3, 1e-5
TP = ["-mesh", "4", "-mesh_model", "2"]
BANNER = "Mesh: 4 devices = 2 data x 2 model (cpu, gloo)"


def _kinds(path):
    """The log's lines from the first epoch on, numbers replaced by
    ``#``, the mesh banner left out (tests/test_mesh_driver.py:96-107)."""
    rows = []
    for ln in open(path).read().splitlines():
        if "Mesh: " in ln or "Data-parallel mesh" in ln:
            continue
        rows.append((ln, re.sub(r"[-+]?\d+\.?\d*(e[-+]?\d+)?", "#",
                                ln.split(": ", 1)[-1])))
    start = next(i for i, (raw, _) in enumerate(rows)
                 if "Starting epoch" in raw)
    return [k for _, k in rows[start:]]


def _assert_close(got, want, what):
    for name in want:
        if name.endswith("y2.bias"):
            continue
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(want[name]), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{what} {name}")


def _params(modules):
    return {n: p.detach().numpy() for n, p in modules.named_parameters()}


def _history_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert [s for s, _ in got[k]] == [s for s, _ in want[k]], k
        np.testing.assert_allclose([v for _, v in got[k]],
                                   [v for _, v in want[k]], rtol=2e-2,
                                   atol=2e-3, err_msg=k)


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_driver")
    one = port_flags(small_argv(synthetic_dataset, root / "one", "one"))
    tp = port_flags(small_argv(synthetic_dataset, root / "tp", "tp", TP))
    return {"one": (one, run(one, max_steps=8, device="cpu")),
            "tp": (tp, run(tp, max_steps=8, device="cpu"))}


def test_tp_driver_matches_single_device(runs):
    f_one, r_one = runs["one"]
    f_tp, r_tp = runs["tp"]
    assert r_one["step"] == r_tp["step"] == 8
    np.testing.assert_allclose(r_tp["batch_accuracy"],
                               r_one["batch_accuracy"], atol=1e-6)
    _assert_close(_params(r_tp["modules"]), _params(r_one["modules"]),
                  "weights")
    _history_close(r_tp["metrics"], r_one["metrics"])
    assert _kinds(f_tp.log_file) == _kinds(f_one.log_file)
    assert BANNER in open(f_tp.log_file).read()


def test_tp_ranks_hold_equal_weights_and_keep_their_logs(runs):
    f_tp, r_tp = runs["tp"]
    ranks = r_tp["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    first = _params(ranks[0]["modules"])
    for r in ranks[1:]:
        for name, p in _params(r["modules"]).items():
            np.testing.assert_array_equal(p, first[name], err_msg=name)
    for i in (1, 2, 3):
        assert _kinds(f"{f_tp.log_file}.p{i}") == _kinds(f_tp.log_file)
    assert os.path.exists(f_tp.checkpoint)
    assert not os.path.exists(f_tp.checkpoint + ".p1")
    # One gradient all-reduce a step on the data axis; the model axis
    # runs its own collectives.
    for r in ranks:
        assert r["collectives"]["grad_calls"] == 8
        assert r["collectives"]["model"]["calls"] >= 8 * 10


def test_tp_checkpoint_is_the_single_device_layout(runs):
    """The periodic checkpoint (step 4), msgpack as the single-device
    run's, holds whole weights and slots, close to the single-device run's
    at the same step, and JAX restores it strictly."""
    f_one, _ = runs["one"]
    f_tp, _ = runs["tp"]
    assert checkpoint_format(f_tp.checkpoint) == \
        checkpoint_format(f_one.checkpoint) == "msgpack"
    got, want = (read_checkpoint(f.checkpoint) for f in (f_tp, f_one))
    assert got["data"] == want["data"]
    for agent in AGENT_NAMES:
        _assert_close({k: v.numpy() for k, v in got["models"][agent].items()},
                      {k: v.numpy() for k, v in
                       want["models"][agent].items()}, agent)
        slots_got = got["optimizers"][agent]["state"]
        slots_want = want["optimizers"][agent]["state"]
        assert slots_got.keys() == slots_want.keys()
        for i in slots_want:
            a, b = (s[i]["square_avg"].numpy()
                    for s in (slots_got, slots_want))
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-9,
                                       err_msg=f"{agent} slot {i}")
    jf = jax_flags(small_argv({"descr": "", "train": "", "dev": "",
                               "glove": ""}, f_tp.log_path, "jax"))
    jmods = JaxModules(JaxConfig.from_flags(jf))
    template = jax_init_params(jmods, jax.random.PRNGKey(0), num_classes=6)
    data, params, _ = jax_checkpoint.load_checkpoint(
        f_tp.checkpoint, template, jax_init_opt_states(jmods.cfg, template))
    assert data == got["data"]
    state = params_to_torch_state(jax.tree_util.tree_map(np.asarray, params))
    for agent in AGENT_NAMES:
        for k, v in got["models"][agent].items():
            np.testing.assert_array_equal(state[agent][k], v.numpy())


def test_tp_run_resumes_like_one_device(runs, synthetic_dataset, tmp_path):
    """Both runs resume the tensor-parallel run's step-4 ``.pt`` (the
    whole state loaded, each rank taking its blocks) and train to step
    8: the same stream and weights."""
    f_tp, _ = runs["tp"]
    out = {}
    for name, extra in (("one", []), ("tp", TP)):
        flags = port_flags(small_argv(synthetic_dataset, tmp_path / name,
                                      "resume", extra))
        shutil.copy(f_tp.checkpoint, flags.checkpoint)
        out[name] = (flags, run(flags, max_steps=8, device="cpu"))
    (f1, one), (f2, two) = out["one"], out["tp"]
    assert one["step"] == two["step"] == 8
    assert "Loaded at step: 4" in open(f2.log_file).read()
    np.testing.assert_allclose(two["batch_accuracy"], one["batch_accuracy"],
                               atol=1e-6)
    _assert_close(_params(two["modules"]), _params(one["modules"]),
                  "resumed")


def test_eval_only_on_a_grid_matches_one_device(runs, synthetic_dataset,
                                                tmp_path):
    f_tp, _ = runs["tp"]
    got = {}
    for name, extra in (("one", []), ("tp", TP)):
        flags = port_flags(small_argv(
            synthetic_dataset, tmp_path / name, "eval",
            ["-eval_only", "-checkpoint", f_tp.checkpoint + "_best"]
            + extra))
        got[name] = (flags, run(flags, device="cpu"))
    (f1, one), (f2, two) = got["one"], got["tp"]
    assert two["dev_acc"] == one["dev_acc"]
    assert two["extra"] == one["extra"]
    assert open(f2.eval_csv_file).read() == open(f1.eval_csv_file).read()
    assert BANNER in open(f2.log_file).read()


@pytest.mark.parametrize("extra", [
    ["-mesh_model", "2"],
    ["-mesh", "1", "-mesh_model", "2"],
    ["-mesh", "6", "-mesh_model", "4"],
    ["-mesh", "8", "-mesh_model", "2", "-batch_size", "6"],
    ["-mesh", "8", "-mesh_model", "4", "-batch_size_dev", "5"],
], ids=["no_mesh", "mesh_1", "indivisible_model", "batch",
        "dev_batch"])
def test_resolve_mesh_errors_are_jaxs(extra, synthetic_dataset, tmp_path):
    argv = small_argv(synthetic_dataset, tmp_path, "bad", extra)
    with pytest.raises(ValueError) as want:
        jax_resolve_mesh(jax_flags(argv))
    with pytest.raises(ValueError) as got:
        resolve_mesh(port_flags(argv), device="cpu")
    assert str(got.value) == str(want.value)
    # train.run raises it before any process starts or any file is
    # written.
    flags = port_flags(argv)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        run(flags, device="cpu")
    assert not os.path.exists(flags.log_file)


def test_grid_devices(synthetic_dataset, tmp_path):
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "ok",
                                  ["-mesh", "8", "-mesh_model", "4"]))
    assert [str(d) for d in resolve_mesh(flags, device="cpu")] == ["cpu"] * 8


def test_serving_refuses_mesh_model(runs, synthetic_dataset, tmp_path):
    from multimodalgame_tpu_torch.data.descriptions import load_descriptions
    from multimodalgame_tpu_torch.serve import Predictor, main
    f_tp, _ = runs["tp"]
    argv = small_argv(synthetic_dataset, tmp_path, "serve",
                      ["-checkpoint", f_tp.checkpoint, "-mesh_model", "2"])
    pack = load_descriptions(synthetic_dataset["descr"], "glove.6B", 16,
                             glove_path=synthetic_dataset["glove"])
    with pytest.raises(ValueError, match="serving shards"):
        Predictor.from_checkpoint(port_flags(argv), pack, device="cpu")
    with pytest.raises(ValueError, match="serving shards"):
        main(argv, device="cpu")


def test_two_processes_train_one_grid(synthetic_dataset, tmp_path):
    """``-mesh 2 -mesh_model 2 -num_processes 2``: two processes joined
    over ``tcp://``, one rank each, form a (1 data x 2 model) grid (JAX
    train.py:195-206) and write the single-device layout's ``.pt``, close
    to a single-device CLI run's."""
    import json
    import socket
    import subprocess
    import sys
    from multimodalgame_tpu_torch.cli import main
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = small_argv(synthetic_dataset, tmp_path / "job", "job", [
        "-mesh", "2", "-mesh_model", "2", "-num_processes", "2",
        "-coordinator", f"127.0.0.1:{port}"])
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import sys, json; from multimodalgame_tpu_torch.cli import "
            "main; main(json.loads(sys.argv[1]), device='cpu')")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(argv + ["-process_id",
                                                        str(i)])],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    one = port_flags(small_argv(synthetic_dataset, tmp_path / "one", "one"))
    main(small_argv(synthetic_dataset, tmp_path / "one", "one"),
         device="cpu")
    job = port_flags(argv)
    log = open(job.log_file).read()
    assert "Mesh: 2 devices = 1 data x 2 model (cpu, gloo)" in log
    assert _kinds(job.log_file + ".p1") == _kinds(job.log_file) == \
        _kinds(one.log_file)
    got, want = (read_checkpoint(f.checkpoint) for f in (job, one))
    assert got["data"] == want["data"]
    for agent in AGENT_NAMES:
        _assert_close({k: v.numpy() for k, v in got["models"][agent].items()},
                      {k: v.numpy() for k, v in
                       want["models"][agent].items()}, agent)
