"""``python -m multimodalgame_tpu_torch`` against the JAX package's CLI, on
the CPU (``cli.main(argv, device="cpu")``).

* ``-eval_only`` (device sweep and ``-nofast_driver`` host loop) on the
  same weights: the eval CSV's header and row, the conf-mat file and the
  flag-dump JSON equal JAX's, the paths aside.
* ``-binary_only``: the two datasets of ``bv.hdf5`` equal JAX
  ``extract_binary``'s (ids, indices, ranks and bits exactly, the
  probabilities and scores to 1e-5).
* JAX's own msgpack file: the port's ``-eval_only`` on it writes JAX's
  eval CSV and conf-mat for the same file, and ``Predictor`` answers as
  JAX's; a run resumed from a msgpack file or a ``.pt`` keeps writing its
  format, and JAX restores the port's msgpack file.
* Bad flags fail as in the JAX CLI; without a GPU and without
  ``device="cpu"`` the CLI raises; ``python -m`` reaches it.
"""

import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from multimodalgame_tpu import cli as jax_cli
from multimodalgame_tpu import serve as jax_serve
from multimodalgame_tpu.data.descriptions import (
    load_descriptions as jax_load_descriptions)
from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.utils import checkpoint as jax_checkpoint
from multimodalgame_tpu.utils import torch_interop as jax_interop
from multimodalgame_tpu_torch import cli
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.data.hdf5_loader import load_hdf5
from multimodalgame_tpu_torch.serve import Predictor
from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                       read_checkpoint)
from tests.port_runs import jax_flags, port_flags, small_argv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checkpoints(paths, argv, jax_path, port_path, stop_bias=1.5,
                 orbax_path=None):
    """One set of JAX weights, as JAX's msgpack file and as a reference
    ``.pt`` (and, given ``orbax_path``, as JAX's Orbax directory), all at
    step 3 with best dev accuracy 0.25. The stop bias keeps conversations
    going past turn 0."""
    jf = jax_flags(argv)
    pack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                 glove_path=paths["glove"])
    jmods = JaxModules(JaxConfig.from_flags(jf))
    params = jax_init_params(jmods, jax.random.PRNGKey(4),
                             num_classes=pack.num_classes)
    params["receiver"]["s"]["bias"] = params["receiver"]["s"]["bias"] \
        + stop_bias
    opts = jax_init_opt_states(jmods.cfg, params)
    data = {"step": 3, "best_dev_acc": 0.25}
    jax_checkpoint.save_checkpoint(jax_path, data, params, opts)
    jax_interop.save_reference_checkpoint(
        port_path, data, jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, opts), jf.optim_type)
    if orbax_path is not None:
        jax_checkpoint.save_checkpoint(orbax_path, data, params, opts,
                                       fmt="orbax")
        jax_checkpoint.wait_for_checkpoints()


def _both(paths, tmp_path, mode_argv):
    """Run JAX's CLI and the port's on the same argv, each in a directory
    of its own; returns the two directories."""
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    argvs = {k: small_argv(paths, d, "cli",
                           ["-checkpoint", str(d / "ckpt")] + mode_argv(d))
             for k, d in dirs.items()}
    os.makedirs(dirs["jax"], exist_ok=True)
    os.makedirs(dirs["port"], exist_ok=True)
    _checkpoints(paths, argvs["jax"], str(dirs["jax"] / "ckpt"),
                 str(dirs["port"] / "ckpt"))
    jax_cli.main(argvs["jax"])
    cli.main(argvs["port"], device="cpu")
    return dirs


def _read(path, d):
    with open(path) as f:
        return f.read().replace(str(d), "<dir>")


@pytest.mark.parametrize("extra", [[], ["-nofast_driver"]],
                         ids=["device_sweep", "host_loop"])
def test_eval_only_matches_jax(synthetic_dataset, tmp_path, extra):
    dirs = _both(synthetic_dataset, tmp_path,
                 lambda d: ["-eval_only"] + extra)
    jd, pd = dirs["jax"], dirs["port"]
    want = _read(jd / "cli.eval.csv", jd).splitlines()
    got = _read(pd / "cli.eval.csv", pd).splitlines()
    assert got[0] == want[0] == ("checkpoint,eval_file,topk,step,"
                                 "best_dev_acc,eval_acc,convlen_mean,"
                                 "convlen_std")
    g, w = got[1].split(","), want[1].split(",")
    assert g[:5] == w[:5]
    assert g[3:5] == ["3", "0.25"]
    np.testing.assert_allclose([float(x) for x in g[5:]],
                               [float(x) for x in w[5:]], atol=1e-6)
    assert float(w[6]) > 0.5          # conversations past turn 0
    assert _read(pd / "cli.conf_mat.txt", pd) == \
        _read(jd / "cli.conf_mat.txt", jd)
    assert _read(pd / "cli.json", pd) == _read(jd / "cli.json", jd)


def test_binary_only_matches_jax(synthetic_dataset, tmp_path):
    # Batches of 4 hold one class each (4 dev examples a class, in class
    # blocks), as the rank column requires.
    dirs = _both(synthetic_dataset, tmp_path,
                 lambda d: ["-binary_only", "-batch_size_dev", "4",
                            "-binary_output", str(d / "bv.hdf5")])
    exact = {"Communication": ("ExampleId", "AgentId", "Index", "Target",
                               "Rank", "BinaryVec"),
             "Predictions": ("ExampleId", "AgentId", "Index", "Target",
                             "Rank", "StopVec", "StopMask")}
    close = {"Communication": ("BinaryProb",),
             "Predictions": ("Predictions", "StopProb")}
    with h5py.File(dirs["jax"] / "bv.hdf5", "r") as jf, \
            h5py.File(dirs["port"] / "bv.hdf5", "r") as pf:
        assert set(pf) == set(jf) == set(exact)
        for name in exact:
            want, got = jf[name][()], pf[name][()]
            assert got.dtype == want.dtype
            assert len(got) == len(want) > 24
            for field in exact[name]:
                np.testing.assert_array_equal(got[field], want[field],
                                              err_msg=field)
            for field in close[name]:
                np.testing.assert_allclose(got[field], want[field],
                                           atol=1e-5, err_msg=field)


def test_eval_only_and_predictor_read_jax_msgpack(synthetic_dataset,
                                                 tmp_path):
    """JAX's msgpack file of ``_checkpoints``, read by the port: the eval
    CSV and conf-mat of its ``-eval_only`` are JAX's on the same file, and
    ``Predictor.from_checkpoint`` answers each dev batch as JAX's."""
    paths = synthetic_dataset
    ckpt = str(tmp_path / "ckpt.msgpack")
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    argvs = {k: small_argv(paths, d, "cli", ["-checkpoint", ckpt,
                                             "-eval_only"])
             for k, d in dirs.items()}
    for d in dirs.values():
        os.makedirs(d)
    _checkpoints(paths, argvs["jax"], ckpt, str(tmp_path / "unused.pt"))
    assert checkpoint_format(ckpt) == "msgpack"
    jax_cli.main(argvs["jax"])
    cli.main(argvs["port"], device="cpu")
    jd, pd = dirs["jax"], dirs["port"]
    want = _read(jd / "cli.eval.csv", jd).splitlines()
    got = _read(pd / "cli.eval.csv", pd).splitlines()
    assert got[0] == want[0]
    g, w = got[1].split(","), want[1].split(",")
    assert g[:5] == w[:5] == [ckpt, paths["dev"], "2", "3", "0.25"]
    np.testing.assert_allclose([float(x) for x in g[5:]],
                               [float(x) for x in w[5:]], atol=1e-6)
    assert _read(pd / "cli.conf_mat.txt", pd) == \
        _read(jd / "cli.conf_mat.txt", jd)

    jpack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                  glove_path=paths["glove"])
    pack = load_descriptions(paths["descr"], "glove.6B", 16,
                             glove_path=paths["glove"])
    want_pred = jax_serve.Predictor.from_checkpoint(jax_flags(argvs["jax"]),
                                                    jpack)
    got_pred = Predictor.from_checkpoint(port_flags(argvs["port"]), pack,
                                         device="cpu")
    for batch in load_hdf5(paths["dev"], 8, 0, False, True, pack.map_labels):
        want, got = (p.predict(batch["avgpool_512"])
                     for p in (want_pred, got_pred))
        assert got["n_steps"] == want["n_steps"]
        np.testing.assert_allclose(got["log_probs"],
                                   np.asarray(want["log_probs"]), atol=1e-5)
        for k in ("prediction", "sender_messages", "receiver_messages",
                  "conversation_length"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


def test_eval_only_binary_only_and_predictor_read_jax_orbax(
        synthetic_dataset, tmp_path):
    """JAX's Orbax directory of ``_checkpoints``, read by the port: its
    ``-eval_only`` CSV and conf-mat are JAX's on the same directory,
    ``-binary_only`` writes what it writes from JAX's msgpack file of the
    same state, and ``Predictor.from_checkpoint`` answers as JAX's."""
    paths = synthetic_dataset
    ckpt, mp = str(tmp_path / "ckpt.orbax"), str(tmp_path / "ckpt.msgpack")
    dirs = {k: tmp_path / k for k in ("jax", "port", "bin")}
    argvs = {k: small_argv(paths, d, "cli", ["-checkpoint", ckpt,
                                             "-eval_only"])
             for k, d in dirs.items()}
    for d in dirs.values():
        os.makedirs(d)
    _checkpoints(paths, argvs["jax"], mp, str(tmp_path / "unused.pt"),
                 orbax_path=ckpt)
    assert checkpoint_format(ckpt) == "orbax"
    jax_cli.main(argvs["jax"])
    cli.main(argvs["port"], device="cpu")
    jd, pd = dirs["jax"], dirs["port"]
    want = _read(jd / "cli.eval.csv", jd).splitlines()
    got = _read(pd / "cli.eval.csv", pd).splitlines()
    assert got[0] == want[0]
    g, w = got[1].split(","), want[1].split(",")
    assert g[:5] == w[:5] == [ckpt, paths["dev"], "2", "3", "0.25"]
    np.testing.assert_allclose([float(x) for x in g[5:]],
                               [float(x) for x in w[5:]], atol=1e-6)
    assert _read(pd / "cli.conf_mat.txt", pd) == \
        _read(jd / "cli.conf_mat.txt", jd)

    outs = {}
    for name, path in (("orbax", ckpt), ("msgpack", mp)):
        out = str(dirs["bin"] / f"{name}.hdf5")
        cli.main(small_argv(paths, dirs["bin"], name, [
            "-checkpoint", path, "-binary_only", "-batch_size_dev", "4",
            "-binary_output", out]), device="cpu")
        outs[name] = out
    with h5py.File(outs["orbax"], "r") as a, \
            h5py.File(outs["msgpack"], "r") as b:
        assert set(a) == set(b) == {"Communication", "Predictions"}
        for name in a:
            assert a[name][()].tobytes() == b[name][()].tobytes(), name

    jpack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                  glove_path=paths["glove"])
    pack = load_descriptions(paths["descr"], "glove.6B", 16,
                             glove_path=paths["glove"])
    want_pred = jax_serve.Predictor.from_checkpoint(jax_flags(argvs["jax"]),
                                                    jpack)
    got_pred = Predictor.from_checkpoint(port_flags(argvs["port"]), pack,
                                         device="cpu")
    for batch in load_hdf5(paths["dev"], 8, 0, False, True, pack.map_labels):
        want, got = (p.predict(batch["avgpool_512"])
                     for p in (want_pred, got_pred))
        np.testing.assert_allclose(got["log_probs"],
                                   np.asarray(want["log_probs"]), atol=1e-5)
        for k in ("prediction", "sender_messages", "conversation_length"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


@pytest.mark.parametrize("fmt", ["msgpack", "pt", "orbax"])
def test_resume_keeps_the_artifacts_format(synthetic_dataset, tmp_path,
                                           fmt):
    """A run resumed from JAX's state at step 3, given as its msgpack
    file, as a ``.pt`` or as its Orbax directory at the checkpoint path,
    writes its periodic and best checkpoints in that format (the ``.pt``
    and the directory named in the log, JAX's line for the directory);
    JAX's strict ``load_checkpoint`` restores the msgpack and Orbax
    ones."""
    paths = synthetic_dataset
    argv = small_argv(paths, tmp_path, "resume", ["-max_epoch", "1"])
    flags = port_flags(argv)
    found = {f: str(tmp_path / f"a.{f}") for f in ("msgpack", "pt",
                                                     "orbax")}
    _checkpoints(paths, argv, found["msgpack"], found["pt"],
                 orbax_path=found["orbax"])
    os.replace(found[fmt], flags.checkpoint)
    cli.main(argv, device="cpu")
    log = open(flags.log_file).read()
    assert "Loaded at step: 3 and best dev acc: 0.25" in log
    assert ("Checkpoint is a reference .pt file" in log) == (fmt == "pt")
    assert ("Checkpoint is an orbax directory; using -ckpt_format orbax "
            "for this run" in log) == (fmt == "orbax")
    assert log.count("Checkpointing.") == 2          # steps 4 and 8
    for path in (flags.checkpoint, flags.checkpoint + "_best"):
        assert checkpoint_format(path) == fmt, path
    assert read_checkpoint(flags.checkpoint)["data"]["step"] == 8
    if fmt != "pt":
        jf = jax_flags(argv)
        jmods = JaxModules(JaxConfig.from_flags(jf))
        template = jax_init_params(jmods, jax.random.PRNGKey(0),
                                   num_classes=6)
        data, _, _ = jax_checkpoint.load_checkpoint(
            flags.checkpoint, template,
            jax_init_opt_states(jmods.cfg, template))
        assert data["step"] == 8


@pytest.mark.parametrize("argv", [
    ["-no_such_flag", "1"], ["-batch_size"], ["-optim_type", "Foo"],
    ["-batch_size", "x"], ["-nofast_driver=true"], ["stray"],
    ["-sender_out_dim", "8", "-rec_w_dim", "16"],
    ["-exchange_samples", "40", "-batch_size", "8"]])
def test_bad_flags_fail_as_in_jax(argv):
    argv = ["-experiment_name", "bad"] + argv
    with pytest.raises(Exception) as want:
        jax_cli.main(argv)
    with pytest.raises(Exception) as got:
        cli.main(argv, device="cpu")
    # Each package has its own FlagError (a ValueError).
    assert type(got.value).__name__ == type(want.value).__name__
    assert type(got.value).__mro__[1:] == type(want.value).__mro__[1:]
    assert str(got.value) == str(want.value)


def test_cli_raises_without_a_gpu(synthetic_dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = small_argv(synthetic_dataset, tmp_path, "nogpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "nogpu.log")


def test_python_m_reaches_the_cli(synthetic_dataset, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-m", "multimodalgame_tpu_torch",
                          "-help"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0
    assert "usage: python -m multimodalgame_tpu_torch" in out.stdout
    assert "msgpack (one file, atomic rename) or orbax (async checkpoint " \
        "directory)" in " ".join(out.stdout.split())
    out = subprocess.run(
        [sys.executable, "-m", "multimodalgame_tpu_torch"]
        + small_argv(synthetic_dataset, tmp_path, "sub"), cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("extra", [
    ["-model_type", "FixedAttention"], ["-model_type", "AdaptiveAttention"],
    ["-desc_attn"], ["-sender_mix", "mou"], ["-sender_mix", "mou",
                                             "-ignore_code"],
    ["-flipout_dev", "-flipout_sen", "0.1", "-flipout_rec", "0.1"]])
def test_check_supported_takes_attention_mou_and_flipout_dev(extra,
                                                             tmp_path):
    """Every flag the JAX package takes is ported: the attention presets,
    ``mou``, ``-flipout_dev``, bfloat16, CIFAR, a mesh, tensor
    parallelism and ``-ckpt_format orbax`` all make a config, and the
    flags keep their values."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.game.config import GameConfig
    for ported in ([], ["-compute_dtype", "bfloat16"], ["-images", "cifar"],
                   ["-mesh", "2"], ["-mesh", "2", "-mesh_model", "2"],
                   ["-ckpt_format", "orbax"]):
        flags = flags_from_argv(["-experiment_name", "ok", "-log_path",
                                 str(tmp_path)] + extra + ported)
        GameConfig.from_flags(flags)
        for name, value in zip(ported[::2], ported[1::2]):
            assert str(getattr(flags, name[1:])) == value, name