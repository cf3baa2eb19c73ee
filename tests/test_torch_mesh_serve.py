"""Serving over several devices, the mesh flags' refusals, and a job of
two processes joined over ``tcp://`` on the CPU.

``Predictor`` over ``["cpu", "cpu"]`` splits each request's rows into one
block a device (a batch they do not divide runs whole), and must answer
as the one-device ``Predictor`` does (JAX ``Predictor(mesh=...)``,
serve.py:36-71). The flags fail as JAX's do, before any process starts
or joins a job. Two ``python -m multimodalgame_tpu_torch.parallel.
distributed`` processes (JAX's ``_main``, distributed.py:422-438) take one
data-parallel step together, as tests/test_distributed.py runs JAX's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.parallel import distributed
from multimodalgame_tpu_torch.serve import Predictor, serving_devices
from multimodalgame_tpu_torch.train import job_devices, run
from tests.port_runs import port_flags, small_argv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=10, rec_w_dim=10,
           rec_hidden=14, wv_dim=16, max_exchange=4, fixed_exchange=False)
NUM_CLASSES = 5


def _predictor(device, **over):
    cfg = GameConfig(**{**CFG, **over})
    mods = init_params(AgentModules(cfg), seed=3, device="cpu")
    # A stop bias that lets conversations run a few turns.
    mods.receiver.s.bias.data.fill_(1.5)
    desc = np.random.RandomState(4).randn(NUM_CLASSES, 16).astype(np.float32)
    pack = DescriptionPack(desc, desc, [1] * NUM_CLASSES,
                           {i: i for i in range(NUM_CLASSES)},
                           {i: f"c{i}" for i in range(NUM_CLASSES)})
    return Predictor(cfg, mods, pack, device=device)


@pytest.mark.parametrize("over", [{}, {"flipout_dev": True,
                                       "flipout_sen": 0.2,
                                       "flipout_rec": 0.2}],
                         ids=["adaptive", "flipout_dev"])
def test_predictor_over_two_devices_answers_as_one(over):
    one = _predictor("cpu", **over)
    two = _predictor(["cpu", "cpu"], **over)
    rng = np.random.RandomState(0)
    for batch in (1, 6, 7):
        x = np.abs(rng.randn(batch, 24)).astype(np.float32)
        got, want = two.predict(x), one.predict(x)
        assert got["n_steps"] == want["n_steps"]
        for k in ("prediction", "sender_messages", "receiver_messages",
                  "conversation_length"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                                   rtol=1e-5, atol=1e-5)


def test_serving_devices():
    assert serving_devices(0, "cpu") == serving_devices(1, "cpu")
    assert len(serving_devices(2, "cpu")) == 2
    assert len(serving_devices(-1, ["cpu", "cpu", "cpu"])) == 3
    with pytest.raises(ValueError, match="only 2 devices"):
        serving_devices(3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="-mesh -1"):
        serving_devices(-1, "cpu")


@pytest.mark.parametrize("extra, device, error, match", [
    (["-mesh", "3"], "cpu", ValueError, "-batch_size 8 is not divisible"),
    (["-mesh", "4"], ["cpu", "cpu"], ValueError, "only 2 devices"),
    (["-mesh", "-1"], "cpu", ValueError, "-mesh -1"),
    (["-num_processes", "2"], "cpu", ValueError, "-coordinator"),
    (["-num_processes", "2", "-coordinator", "127.0.0.1:1"], "cpu",
     ValueError, "requires -mesh"),
    (["-mesh", "2", "-nofast_driver"], "cpu", ValueError, "fast driver"),
    (["-mesh", "2", "-binary_only"], "cpu", ValueError, "fast driver"),
    (["-mesh_model", "2"], "cpu", ValueError, "-mesh_model requires -mesh"),
], ids=["indivisible", "too_few_devices", "minus_one_cpu",
        "no_coordinator", "no_mesh", "nofast_driver", "binary_only",
        "mesh_model"])
def test_mesh_flags_fail_before_any_process_starts(synthetic_dataset,
                                                   tmp_path, extra, device,
                                                   error, match):
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "bad", extra))
    with pytest.raises(error, match=match):
        run(flags, device=device)
    # Nothing was written: the flags failed before the run began.
    assert not os.path.exists(flags.log_file)


def test_job_devices_split_the_mesh_over_the_processes(synthetic_dataset,
                                                       tmp_path):
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "job", [
        "-mesh", "4", "-num_processes", "2", "-coordinator",
        "127.0.0.1:1", "-process_id", "1"]))
    assert [str(d) for d in job_devices(flags, "cpu")] == ["cpu", "cpu"]
    single = port_flags(small_argv(synthetic_dataset, tmp_path, "one"))
    assert job_devices(single, "cpu") is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_take_one_step_together():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "multimodalgame_tpu_torch.parallel.distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), "--device", "cpu"],
        env=env, cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=180)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    a, b = sorted(outs, key=lambda o: o["process_id"])
    assert {k: v for k, v in a.items() if k != "process_id"} == \
        {k: v for k, v in b.items() if k != "process_id"}
    # The same step as two ranks launched on this host, and, up to the
    # order of summation, as one device.
    local = distributed.launch(distributed.dryrun_step, ["cpu", "cpu"],
                               timeout=180)[0]
    for k in ("loss_rec", "loss_sen", "accuracy"):
        assert a[k] == local[k], k
    alone = distributed.dryrun_step(None)
    for k in ("loss_rec", "loss_sen", "accuracy", "weight_sum"):
        assert a[k] == pytest.approx(alone[k], rel=1e-5), k
