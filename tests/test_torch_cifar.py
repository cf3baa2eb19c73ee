"""``-images cifar`` in the port against the JAX package, on the CPU.

A 40-image CIFAR-10 python-format pickle written by the test (the layout
of JAX tests/test_cifar.py:15-33) stands in for the test split. The
streaming loader and the staged pixels equal JAX's bit for bit; the
staged set's on-device normalization equals the streaming loader's; its
plan is the streaming loader's whatever ``-noshuffle_train`` says; and a
3-step ``train.run`` with ``-images cifar`` prints JAX's log line for line
(the port handed the uniforms JAX's driver draws, from the weights JAX's
``run`` initialises), flat pixels under Adaptive and the pixel maps with
the derived ``fc`` context under FixedAttention. The images are resized
to 32 instead of 227 to keep the runs small (``CIFAR_IMAGE_SIZE`` of both
drivers).
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

import multimodalgame_tpu.game.driver as jax_driver
from multimodalgame_tpu.data.cifar import load_cifar as jax_load_cifar
from multimodalgame_tpu.data.cifar import (
    load_cifar_staged as jax_load_cifar_staged)
from multimodalgame_tpu.data.descriptions import (
    load_descriptions as jax_load_descriptions)
from multimodalgame_tpu.data.device_dataset import (
    DeviceDataset as JaxDeviceDataset)
from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.train import run as jax_run
from multimodalgame_tpu.utils.torch_interop import (
    save_reference_checkpoint as jax_save_reference_checkpoint)
from multimodalgame_tpu_torch.data.cifar import (cifar_epoch_perm,
                                                 load_cifar,
                                                 load_cifar_staged, normalize)
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.data.synthetic import write_descriptions_csv
from multimodalgame_tpu_torch.game import driver
from multimodalgame_tpu_torch.train import run
from tests.jax_uniforms import jax_step_provider
from tests.port_runs import (assert_same_messages, jax_flags, port_flags,
                             runs_of)

N_IMAGES, SIZE = 40, 32


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    """A tiny test_batch in the real pickle layout: ``{b'data': (N, 3072)
    uint8 row-major CHW, b'labels': [int]}``."""
    root = tmp_path_factory.mktemp("cifar")
    os.makedirs(root / "cifar-10-batches-py")
    rng = np.random.RandomState(0)
    payload = {
        b"data": rng.randint(0, 256, size=(N_IMAGES, 3072), dtype=np.uint8),
        b"labels": [int(x) for x in rng.randint(0, 10, size=N_IMAGES)],
    }
    with open(root / "cifar-10-batches-py" / "test_batch", "wb") as f:
        pickle.dump(payload, f)
    return str(root)


@pytest.mark.parametrize("image_size", [32, 64])
def test_load_cifar_matches_jax(cifar_root, image_size):
    for epoch in (0, 3):
        got = list(load_cifar(8, epoch, root=cifar_root,
                              image_size=image_size))
        want = list(jax_load_cifar(8, epoch, root=cifar_root,
                                   image_size=image_size))
        assert len(got) == len(want) == N_IMAGES // 8
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_load_cifar_staged_matches_jax(cifar_root):
    pixels, labels = load_cifar_staged(cifar_root, image_size=64)
    want_pixels, want_labels = jax_load_cifar_staged(cifar_root,
                                                     image_size=64)
    assert pixels.dtype == np.uint8 and pixels.shape == (N_IMAGES, 3, 64, 64)
    np.testing.assert_array_equal(pixels, want_pixels)
    np.testing.assert_array_equal(labels, want_labels)


def test_missing_copy_raises():
    with pytest.raises(NotImplementedError, match="local CIFAR-10"):
        next(load_cifar(8, epoch=0, root="/nonexistent"))


def test_staged_normalization_equals_the_streaming_loader(cifar_root,
                                                          monkeypatch):
    """The staged uint8 pixels, gathered by the plan and normalized on the
    device, are the streaming loader's batches bit for bit."""
    monkeypatch.chdir(cifar_root)
    ds = DeviceDataset.from_cifar(image_size=64, device="cpu")
    assert ds.feats.dtype == torch.uint8
    jds = JaxDeviceDataset.from_cifar(image_size=64)
    np.testing.assert_array_equal(ds.feats.numpy(), np.asarray(jds.feats))
    plan = ds.epoch_indices(2, True, 8)
    stream = list(load_cifar(8, 2, root=cifar_root, image_size=64))
    assert plan.shape[0] == len(stream) == N_IMAGES // 8
    for row, b in zip(plan, stream):
        np.testing.assert_array_equal(row, b["example_ids"])
        np.testing.assert_array_equal(ds.targets_host[row], b["target"])
        staged = normalize(ds.feats[torch.from_numpy(row)])
        np.testing.assert_array_equal(staged.numpy(), b["layer4_2"])
        np.testing.assert_array_equal(staged.reshape(8, -1).numpy(),
                                      b["avgpool_512"])
        np.testing.assert_array_equal(normalize(ds.feats.numpy()[row]),
                                      b["layer4_2"])


def test_epoch_indices_ignore_noshuffle(cifar_root, monkeypatch):
    """The streaming loader (and the reference's CIFAR DataLoader) always
    shuffles, so the staged plan does too; a truncated plan is refused,
    as the streaming loader drops the ragged tail. The plans are JAX's."""
    monkeypatch.chdir(cifar_root)
    ds = DeviceDataset.from_cifar(image_size=32, device="cpu")
    jds = JaxDeviceDataset.from_cifar(image_size=32)
    on = ds.epoch_indices(1, True, 8)
    np.testing.assert_array_equal(on, ds.epoch_indices(1, False, 8))
    np.testing.assert_array_equal(on.reshape(-1), np.random.RandomState(
        12).permutation(N_IMAGES))
    for epoch, batch in ((1, 8), (4, 7)):
        np.testing.assert_array_equal(
            ds.epoch_indices(epoch, False, batch),
            jds.epoch_indices(epoch, False, batch))
        np.testing.assert_array_equal(ds.epoch_indices(epoch, True, batch),
                                      cifar_epoch_perm(N_IMAGES, epoch,
                                                       batch))
    with pytest.raises(ValueError, match="truncate_final_batch"):
        ds.epoch_indices(1, True, 8, truncate_final_batch=True)


def test_uint8_pixels_make_a_cifar_set(synthetic_dataset, tmp_path,
                                       monkeypatch):
    """The feature dtype is the one decision: uint8 pixels are kept as
    stored and take the streaming loader's plan; other features become
    float32 with the reference plan, and ``-images cifar`` refuses them."""
    rng = np.random.RandomState(0)
    px = rng.randint(0, 256, (20, 3, SIZE, SIZE)).astype(np.uint8)
    labels = rng.randint(0, 10, 20)
    for feats in (px, torch.from_numpy(px)):
        ds = DeviceDataset(feats, labels, device="cpu")
        assert ds.cifar and ds.feats.dtype == torch.uint8
        assert torch.equal(ds.feats, torch.from_numpy(px))
        np.testing.assert_array_equal(ds.epoch_indices(3, False, 8),
                                      cifar_epoch_perm(20, 3, 8))
    floats = DeviceDataset(px.astype(np.float64), labels, device="cpu")
    assert not floats.cifar and floats.feats.dtype == torch.float32
    np.testing.assert_array_equal(floats.epoch_indices(3, False, 8),
                                  np.arange(16).reshape(2, 8))

    monkeypatch.setattr(driver, "CIFAR_IMAGE_SIZE", SIZE)
    descr = str(tmp_path / "descr10.csv")
    write_descriptions_csv(descr, 10)
    pack = load_descriptions(descr, "glove.6B", 16,
                             glove_path=synthetic_dataset["glove"])
    dev = DeviceDataset(rng.randn(8, 3 * SIZE * SIZE), np.arange(8) % 10,
                        device="cpu")
    pf = port_flags(_argv(synthetic_dataset, tmp_path, "f", "Adaptive",
                          "unused.hdf5", descr))
    with pytest.raises(ValueError, match="uint8"):
        run(pf, max_steps=1, device="cpu", inputs=(pack, pack, floats, dev))


def _dev_file(path, attention):
    import h5py
    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as fh:
        fh.create_dataset("Target", data=np.arange(8, dtype=np.int64) % 10)
        fh.create_dataset("Location", data=np.asarray(
            [b"p%d.jpg" % i for i in range(8)], dtype="S50"))
        if attention:
            fh.create_dataset("layer4_2", data=rng.randn(
                8, 3, SIZE, SIZE).astype(np.float32))
            fh.create_dataset("fc", data=rng.randn(
                8, 1, 3 * SIZE * SIZE).astype(np.float32))
        else:
            fh.create_dataset("avgpool_512", data=rng.randn(
                8, 1, 3 * SIZE * SIZE).astype(np.float32))
    return str(path)


MODELS = {
    "Adaptive": ["-img_feat", "avgpool_512",
                 "-img_feat_dim", str(3 * SIZE * SIZE)],
    "FixedAttention": ["-img_feat_dim", "3",
                       "-attn_context_dim", str(3 * SIZE * SIZE),
                       "-attn_dim", "8"],
}


def _argv(paths, root, name, model, dev, descr):
    return [
        "-experiment_name", name, "-model_type", model, "-images", "cifar",
        "-log_path", str(root), "-batch_size", "8", "-batch_size_dev", "8",
        "-rec_w_dim", "8", "-sender_out_dim", "8", "-img_h_dim", "8",
        "-rec_hidden", "8", "-baseline_hid_dim", "8", "-max_exchange", "2",
        "-max_epoch", "2", "-top_k_dev", "2", "-top_k_train", "2",
        "-descr_train", descr, "-descr_dev", descr,
        "-train_file", paths["train"], "-dev_file", dev,
        "-wv_dim", "16", "-glove_path", paths["glove"],
        "-log_interval", "2", "-log_dev", "2", "-save_after", "1000",
        "-save_interval", "1000", "-exchange_samples", "1",
        "-branch", "main", "-sha", "0"] + MODELS[model]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_cifar_run_matches_jax(model, cifar_root, synthetic_dataset,
                               tmp_path, monkeypatch):
    """3 steps of ``train.run`` with ``-images cifar`` from JAX's initial
    weights and with JAX's uniforms: the same log, line for line (log
    windows and dev sweeps at steps 0 and 2). The port's -nofast_driver
    streaming loop prints the same as its driver."""
    monkeypatch.chdir(cifar_root)
    monkeypatch.setattr(jax_driver, "CIFAR_IMAGE_SIZE", SIZE)
    monkeypatch.setattr(driver, "CIFAR_IMAGE_SIZE", SIZE)
    descr = str(tmp_path / "descr10.csv")
    write_descriptions_csv(descr, 10)
    dev = _dev_file(tmp_path / "dev.hdf5", model != "Adaptive")
    jf = jax_flags(_argv(synthetic_dataset, tmp_path / "jax", "c", model,
                         dev, descr))
    pf = port_flags(_argv(synthetic_dataset, tmp_path / "port", "c", model,
                          dev, descr))
    slow = port_flags(_argv(synthetic_dataset, tmp_path / "slow", "c",
                            model, dev, descr) + ["-nofast_driver"])
    jpack = jax_load_descriptions(descr, "glove.6B", 16,
                                  glove_path=synthetic_dataset["glove"])
    jmods = JaxModules(JaxConfig.from_flags(jf))
    params = jax_init_params(jmods, jax.random.PRNGKey(jf.random_seed),
                             num_classes=jpack.num_classes,
                             max_words=max(jpack.desc_set_lens))
    for f in (pf, slow):
        jax_save_reference_checkpoint(
            f.checkpoint, {"step": 0, "best_dev_acc": 0.0}, params,
            jax_init_opt_states(jmods.cfg, params), "RMSprop")
    provider = jax_step_provider(jmods.cfg,
                                 jax.random.PRNGKey(jf.random_seed + 1), 8)

    want = jax_run(jf, max_steps=3)
    got = run(pf, max_steps=3, device="cpu", uniforms=provider)
    want_log = runs_of(jf.log_file)[0]
    assert sum("Training Accuracy" in m for m in want_log) == 2
    assert sum(m.startswith("Epoch") and "Development Accuracy" in m
               for m in want_log) == 2
    assert_same_messages(runs_of(pf.log_file)[0], want_log)
    assert got["step"] == want["step"] == 3
    np.testing.assert_allclose(got["batch_accuracy"],
                               want["batch_accuracy"], atol=1e-6)

    run(slow, max_steps=3, device="cpu", uniforms=provider)
    assert_same_messages(runs_of(slow.log_file)[0],
                         runs_of(pf.log_file)[0], rtol=1e-6, atol=1e-6)
