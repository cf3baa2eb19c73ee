"""The port's training driver against the JAX package's, on the CPU.

* The pure parts: the chunk decomposition and piece planner, the log
  payload's fields, and the log-window formatter.
* Dev evaluation: ``game/fast_eval.py`` and the host ``eval.py`` on the
  same weights as JAX's, with a ragged dev tail and with ``top_k`` above
  the class count: accuracy and statistics to 1e-6, conf-mat files byte
  for byte.
* Whole runs: ``train.run(flags, max_steps=8, device="cpu")`` against
  JAX's ``run(flags, max_steps=8)`` on tests/test_driver.py's small
  flags. The port starts from the msgpack file that JAX's
  ``save_checkpoint`` wrote from JAX's own initial weights at step 0,
  and replays JAX's uniforms (``fold_in(PRNGKey(random_seed +
  1), step)``, tests/jax_uniforms.py), so the sampled bits are JAX's and
  the two logs agree line for line: the same messages in the same order,
  the "Predictions" and sparkline dumps as text, every other number to
  1e-4 (float32). The same holds for a resumed run.
"""

import filecmp
import os
import re

import jax
import numpy as np
import pytest

from multimodalgame_tpu.data.descriptions import (
    load_descriptions as jax_load_descriptions)
from multimodalgame_tpu.data.device_dataset import (
    DeviceDataset as JaxDeviceDataset)
from multimodalgame_tpu.eval import eval_dev as jax_eval_dev
from multimodalgame_tpu.game import driver as jax_driver
from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.fast_eval import (
    run_device_dev_eval as jax_run_device_dev_eval)
from multimodalgame_tpu.game.logpack import LogPacker as JaxLogPacker
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.game.train import (
    make_eval_exchange as jax_make_eval_exchange)
from multimodalgame_tpu.train import emit_log_window as jax_emit_log_window
from multimodalgame_tpu.train import run as jax_run
from multimodalgame_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from multimodalgame_tpu.utils.logging import FileLogger as JaxFileLogger
from multimodalgame_tpu.utils.logging import VisdomLogger as JaxVisdomLogger
from multimodalgame_tpu.utils.logging import read_log_load as jax_read_log_load
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.eval import eval_dev
from multimodalgame_tpu_torch.game import driver
from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.fast_eval import run_device_dev_eval
from multimodalgame_tpu_torch.game.logpack import LogPacker
from multimodalgame_tpu_torch.game.train import make_eval_exchange
from multimodalgame_tpu_torch.train import emit_log_window
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils.logging import (FileLogger, VisdomLogger,
                                                    read_log_load)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_split_chain_provider, jax_step_provider
from tests.port_runs import (assert_same_messages, jax_flags, port_flags,
                             runs_of, small_argv)


# ------------------------------------------------------------ pure parts

def test_chunk_decomposition_and_planner_match_jax():
    for k in range(1, 1101):
        assert driver.decompose_chunks(k) == jax_driver.decompose_chunks(k)
    assert driver.decompose_chunks(0) == []
    # A remainder that recurs (487 of a 999-step window) becomes one
    # exact piece from its second occurrence on, up to the cap.
    ks = list(range(1, 1101)) + [999, 487, 5, 37] + list(range(40, 60)) * 2
    got, want = driver.make_piece_planner(), jax_driver.make_piece_planner()
    plans = [got(k) for k in ks]
    assert plans == [want(k) for k in ks]
    fresh = driver.make_piece_planner()
    assert [fresh(999), fresh(999)] == [[512, 256, 128, 64, 32, 4, 2, 1],
                                        [512, 487]]


@pytest.mark.parametrize("samples,T", [(1, 3), (0, 3), (3, 1)])
def test_log_packer_fields_match_jax(samples, T):
    kw = dict(sender_out_dim=8, rec_w_dim=8, max_exchange=T)
    got = LogPacker(GameConfig(**kw), 8, samples).spec
    want = JaxLogPacker(JaxConfig(**kw), 8, samples).spec
    assert got.fields == want.fields
    assert got.total == want.total


def _host_window(rng, T=3, B=8, S=2, W=8):
    host = dict(loss_sen=-7.25, nll_loss=1.5, loss_binary_rec=-11.0,
                loss_binary_s=-1.25, loss_bas_sen=2.5, loss_bas_rec=5.0,
                target=rng.randint(0, 6, B).astype(np.int32),
                argmax=rng.randint(0, 6, B).astype(np.float32),
                n_steps=np.float32(2), ent_binary_sen=rng.rand(T),
                ent_binary_rec=rng.rand(T - 1), ent_y_rec=rng.rand(T))
    for p in ("train_", "eval_"):
        host.update({
            p + "sen_probs": rng.rand(T, S, W).astype(np.float32),
            p + "sen_feats": (rng.rand(T, S, W) > 0.5).astype(np.float32),
            p + "rec_probs": rng.rand(T, S, W).astype(np.float32),
            p + "rec_feats": (rng.rand(T, S, W) > 0.5).astype(np.float32),
            p + "stop_probs": rng.rand(T, S, 1).astype(np.float32),
            p + "stop_masks_post": (rng.rand(T, S, 1) > 0.5)
            .astype(np.float32),
            p + "n_steps": np.float32(T)})
    return host


@pytest.mark.parametrize("extra", [[], ["-use_alpha", "-model_type",
                                        "Fixed", "-exchange_samples", "2"]])
def test_log_window_matches_jax(tmp_path, synthetic_dataset, extra):
    argv = small_argv(synthetic_dataset, tmp_path, "win", extra)
    logs = {}
    for name, flags, emit, flog, vlog in (
            ("jax", jax_flags(argv), jax_emit_log_window, JaxFileLogger,
             JaxVisdomLogger),
            ("port", port_flags(argv), emit_log_window, FileLogger,
             VisdomLogger)):
        path = str(tmp_path / (name + ".log"))
        logger = vlog()
        emit(flags, flog(path), logger, 1, 12, 3, 0.375,
             _host_window(np.random.RandomState(4)))
        with open(path) as f:
            text = re.sub(r"^\d\d-\d\d-\d\d \d\d:\d\d:\d\d ", "",
                          f.read(), flags=re.M)
        logs[name] = (text, logger.history)
    assert logs["port"] == logs["jax"]
    assert "Eval:" in logs["port"][0]


# -------------------------------------------------------- dev evaluation

def _carried_game(paths, argv, stop_bias=1.5):
    """JAX's initial weights (stop bias raised so that conversations run
    past turn 0) and the port's agents holding the same weights."""
    jf, pf = jax_flags(argv), port_flags(argv)
    jpack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                  glove_path=paths["glove"])
    jmods = JaxModules(JaxConfig.from_flags(jf))
    params = jax_init_params(jmods, jax.random.PRNGKey(3),
                             num_classes=jpack.num_classes)
    params["receiver"]["s"]["bias"] = params["receiver"]["s"]["bias"] \
        + stop_bias
    mods = AgentModules(GameConfig.from_flags(pf))
    load_torch_state(mods, params_to_torch_state(
        jax.tree_util.tree_map(np.asarray, params)))
    pack = load_descriptions(paths["descr"], "glove.6B", 16,
                             glove_path=paths["glove"])
    return jf, pf, jmods, params, jpack, mods, pack


@pytest.mark.parametrize("batch,top_k", [(7, 2), (8, 8)],
                         ids=["ragged_tail", "top_k_above_classes"])
def test_dev_eval_matches_jax(synthetic_dataset, tmp_path, batch, top_k):
    paths = synthetic_dataset
    argv = small_argv(paths, tmp_path, "dev", [
        "-batch_size_dev", str(batch), "-top_k_dev", str(top_k)])
    jf, pf, jmods, params, jpack, mods, pack = _carried_game(paths, argv)
    jds = JaxDeviceDataset.from_hdf5(paths["dev"], "avgpool_512",
                                     map_labels=jpack.map_labels)
    ds = DeviceDataset.from_hdf5(paths["dev"], "avgpool_512",
                                 map_labels=pack.map_labels, device="cpu")
    assert ds.size % batch or batch == 8      # a ragged tail where asked
    port_ev = make_eval_exchange(mods)

    results = {}
    for name, fn in (
            ("jax_fast", lambda: jax_run_device_dev_eval(
                jf, jmods, params, jpack, jds, 0, jax.random.PRNGKey(0))),
            ("jax_host", lambda: jax_eval_dev(
                jf, jmods, params, jax_make_eval_exchange(jmods),
                paths["dev"], batch, 0, False, top_k, jpack)),
            ("port_fast", lambda: run_device_dev_eval(
                pf, mods, port_ev, pack, ds, 0)),
            ("port_host", lambda: eval_dev(
                pf, mods, port_ev, paths["dev"], batch, 0, False, top_k,
                pack))):
        flags = jf if name.startswith("jax") else pf
        flags.conf_mat = str(tmp_path / (name + ".conf_mat.txt"))
        results[name] = fn() + (flags.conf_mat,)

    want_acc, want_extra, want_cm = results["jax_fast"]
    assert 0 < want_acc
    for name, (acc, extra, cm) in results.items():
        assert acc == pytest.approx(want_acc, abs=1e-6), name
        assert extra.keys() == want_extra.keys()
        for k in extra:
            assert extra[k] == pytest.approx(want_extra[k], abs=1e-6), \
                (name, k)
        assert filecmp.cmp(cm, want_cm, shallow=False), name
    assert want_extra["conversation_lengths_mean"] > 0.5


def test_conf_mat_indexes_the_labels_present(tmp_path):
    """sklearn's layout: the sorted union of the labels that occur, not
    range(num_classes)."""
    from multimodalgame_tpu_torch.eval import (confusion_matrix,
                                               write_confusion_matrix)
    from sklearn.metrics import confusion_matrix as sk_confusion_matrix
    rng = np.random.RandomState(0)
    for _ in range(20):
        t = rng.choice([1, 4, 5, 9], size=30)
        p = rng.choice([0, 4, 9, 11], size=30)
        np.testing.assert_array_equal(confusion_matrix(t, p),
                                      sk_confusion_matrix(t, p))
    write_confusion_matrix(str(tmp_path / "cm.txt"), t, p)
    np.savetxt(str(tmp_path / "sk.txt"), sk_confusion_matrix(t, p),
               delimiter=",", fmt="%d")
    assert filecmp.cmp(str(tmp_path / "cm.txt"), str(tmp_path / "sk.txt"),
                       shallow=False)


# ------------------------------------------------------------ whole runs

def _start_from_jax_weights(paths, jf, pf):
    """Write, at the port's checkpoint path, JAX's step-0 msgpack file of
    the weights JAX's ``run`` initialises for ``jf``; returns JAX's
    config."""
    jpack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                  glove_path=paths["glove"])
    jmods = JaxModules(JaxConfig.from_flags(jf))
    params = jax_init_params(jmods, jax.random.PRNGKey(jf.random_seed),
                             num_classes=jpack.num_classes,
                             max_words=max(jpack.desc_set_lens))
    jax_save_checkpoint(pf.checkpoint, {"step": 0, "best_dev_acc": 0.0},
                        params, jax_init_opt_states(jmods.cfg, params))
    return jmods.cfg


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    """JAX's run and the port's, 8 steps each from the same weights and
    uniforms; then each resumed from its step-4 checkpoint to step 7."""
    paths = synthetic_dataset
    root = tmp_path_factory.mktemp("runs")
    jf = jax_flags(small_argv(paths, root / "jax", "run"))
    pf = port_flags(small_argv(paths, root / "port", "run"))
    cfg = _start_from_jax_weights(paths, jf, pf)
    provider = jax_step_provider(cfg,
                                 jax.random.PRNGKey(jf.random_seed + 1),
                                 jf.batch_size)
    out = {"jax": jax_run(jf, max_steps=8),
           "port": run(pf, max_steps=8, device="cpu", uniforms=provider),
           "jax_flags": jf, "port_flags": pf}
    out["jax_resumed"] = jax_run(jax_flags(small_argv(paths, root / "jax",
                                                      "run")), max_steps=7)
    out["port_resumed"] = run(port_flags(small_argv(paths, root / "port",
                                                    "run")),
                              max_steps=7, device="cpu", uniforms=provider)
    return out


def test_run_matches_jax(runs):
    jf, pf = runs["jax_flags"], runs["port_flags"]
    want = runs_of(jf.log_file)[0]
    got = runs_of(pf.log_file)[0]
    assert sum("Training Accuracy" in m for m in want) == 2
    assert sum(m.startswith("Epoch") and "Development Accuracy" in m
               for m in want) == 2
    assert_same_messages(got, want)
    assert runs["port"]["step"] == runs["jax"]["step"] == 8
    np.testing.assert_allclose(runs["port"]["batch_accuracy"],
                               runs["jax"]["batch_accuracy"], atol=1e-6)
    assert runs["port"]["best_dev_acc"] == pytest.approx(
        runs["jax"]["best_dev_acc"], abs=1e-6)
    for f in (jf, pf):
        for path in (f.checkpoint, f.checkpoint + "_best", f.conf_mat,
                     f.json_file):
            assert os.path.isfile(path), path
    # The log's flag dump reads back as the flags (both packages' parser).
    assert read_log_load(pf.log_file, last=False) == \
        jax_read_log_load(pf.log_file, last=False) == \
        pf.flag_values_dict()


def test_resumed_run_matches_jax(runs):
    """Both resume from their periodic checkpoint of step 4 with the
    reference's replay semantics (model.py:1149-1156, 1190): the step is
    restored, the epochs count from 0 again, and step 4 runs again on
    epoch 0's first batch. So a run resumed to 7 is not a run to 7 from
    scratch; it is the JAX package's resumed run, weights and optimizer
    slots included."""
    jf, pf = runs["jax_flags"], runs["port_flags"]
    want = runs_of(jf.log_file)[1]
    got = runs_of(pf.log_file)[1]
    assert "Loaded at step: 4 and best dev acc: 0.0" in \
        open(pf.log_file).read()
    assert any(m.startswith("Epoch: 0 Step: 4 Batch: 0 Training Accuracy")
               for m in got)
    assert_same_messages(got, want)
    assert runs["port_resumed"]["step"] == runs["jax_resumed"]["step"] == 7
    want_w = params_to_torch_state(jax.tree_util.tree_map(
        np.asarray, runs["jax_resumed"]["params"]))
    mods = runs["port_resumed"]["modules"]
    for agent in AGENT_NAMES:
        for name, p in getattr(mods, agent).named_parameters():
            if name == "y2.bias":
                # Its gradient is zero but for rounding (log_softmax),
                # which RMSprop scales up to lr / eps.
                continue
            np.testing.assert_allclose(p.detach().numpy(),
                                       want_w[agent][name], atol=2e-5,
                                       err_msg=f"{agent}.{name}")


def test_dataset_smaller_than_a_batch_prints_every_banner(
        synthetic_dataset, tmp_path):
    """No step runs, but each epoch's Starting line prints, as in JAX
    (tests/test_driver.py:383-403)."""
    argv = small_argv(synthetic_dataset, tmp_path, "tiny",
                      ["-batch_size", "64"])
    jf, pf = jax_flags(argv), port_flags(argv + ["-log_path",
                                                 str(tmp_path / "p")])
    jax_run(jf)
    out = run(pf, device="cpu")
    assert out["step"] == 0
    assert runs_of(pf.log_file) == runs_of(jf.log_file)
    assert sum("Starting epoch" in m for m in runs_of(pf.log_file)[0]) == 2


def test_per_batch_run_matches_jax(synthetic_dataset, tmp_path):
    """``-nofast_driver`` in both packages, 8 steps from the same weights:
    batches read from the file, the dev evaluation on the host, and the
    port replaying JAX's per-batch key chain (a split each step, one more
    at a log window with an eval dump). The two logs agree as the
    drivers' do."""
    paths = synthetic_dataset
    jf = jax_flags(small_argv(paths, tmp_path / "jax", "loop",
                              ["-nofast_driver"]))
    pf = port_flags(small_argv(paths, tmp_path / "port", "loop",
                               ["-nofast_driver"]))
    cfg = _start_from_jax_weights(paths, jf, pf)
    provider = jax_split_chain_provider(
        cfg, jax.random.PRNGKey(jf.random_seed + 1), jf.batch_size,
        lambda s: s % jf.log_interval == 0 and jf.exchange_samples > 0)
    want = jax_run(jf, max_steps=8)
    got = run(pf, max_steps=8, device="cpu", uniforms=provider)
    want_log = runs_of(jf.log_file)[0]
    assert sum("Training Accuracy" in m for m in want_log) == 2
    assert sum(m.startswith("Epoch") and "Development Accuracy" in m
               for m in want_log) == 2
    assert_same_messages(runs_of(pf.log_file)[0], want_log)
    assert got["step"] == want["step"] == 8
    np.testing.assert_allclose(got["batch_accuracy"],
                               want["batch_accuracy"], atol=1e-6)
    assert got["best_dev_acc"] == pytest.approx(want["best_dev_acc"],
                                                abs=1e-6)
    for f in (jf, pf):
        for path in (f.checkpoint, f.checkpoint + "_best", f.conf_mat,
                     f.json_file):
            assert os.path.isfile(path), path


def test_per_batch_loop_matches_the_driver(synthetic_dataset, tmp_path):
    """``-nofast_driver`` reads batches from the file and evaluates on the
    host; with the randomness keyed by the same global steps it prints
    what the driver prints."""
    paths = synthetic_dataset
    fast = port_flags(small_argv(paths, tmp_path / "fast", "loop"))
    slow = port_flags(small_argv(paths, tmp_path / "slow", "loop",
                                 ["-nofast_driver"]))
    run(fast, max_steps=8, device="cpu")
    run(slow, max_steps=8, device="cpu")
    assert_same_messages(runs_of(slow.log_file)[0],
                         runs_of(fast.log_file)[0], rtol=1e-6, atol=1e-6)


def test_unported_flags_raise(synthetic_dataset, tmp_path):
    """``-ckpt_format orbax`` runs and writes both checkpoints as Orbax
    directories; ``-mesh_model`` without a mesh fails with JAX's
    ``resolve_mesh`` error."""
    from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                           read_checkpoint)
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "x",
                                  ["-ckpt_format", "orbax"]))
    run(flags, max_steps=8, device="cpu")
    for path in (flags.checkpoint, flags.checkpoint + "_best"):
        assert checkpoint_format(path) == "orbax", path
        assert not os.path.exists(path + ".staging")
    assert read_checkpoint(flags.checkpoint)["data"]["step"] == 4
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "x",
                                  ["-mesh_model", "2"]))
    with pytest.raises(ValueError, match="-mesh_model requires -mesh"):
        run(flags, device="cpu")
