"""The port's serving path against the JAX package's, on the CPU.

A reference-layout ``.pt`` is written by the JAX package's
``save_reference_checkpoint``; both packages' ``Predictor`` load it and
answer the same requests. Predictions, messages and conversation lengths
must be equal; log-probabilities are held at atol 1e-5. Also covered:
the CLI's JSONL lines, the checkpoint round trip, and the copied host
modules (flags, descriptions, HDF5 loader).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from multimodalgame_tpu import serve as jax_serve
from multimodalgame_tpu.config import finalize_flags as jax_finalize_flags
from multimodalgame_tpu.config import make_flags as jax_make_flags
from multimodalgame_tpu.config import parse_args as jax_parse_args
from multimodalgame_tpu.data.descriptions import (
    load_descriptions as jax_load_descriptions)
from multimodalgame_tpu.data.hdf5_loader import load_hdf5 as jax_load_hdf5
from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.utils.torch_interop import (
    load_reference_checkpoint as jax_load_reference_checkpoint)
from multimodalgame_tpu.utils.torch_interop import (
    save_reference_checkpoint as jax_save_reference_checkpoint)
from multimodalgame_tpu_torch import serve
from multimodalgame_tpu_torch.config import (finalize_flags, flags_from_argv,
                                             make_flags, parse_args)
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.data.hdf5_loader import load_hdf5
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.ops.cuda_exchange import fused_eval_exchange
from multimodalgame_tpu_torch.serve import Predictor
from multimodalgame_tpu_torch.utils.checkpoint import load_agents
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_reference_checkpoint, params_to_torch_state,
    save_reference_checkpoint)


def _argv(paths, tmp_path, ckpt, model_type="Adaptive"):
    return ["-experiment_name", "srv", "-model_type", model_type,
            "-log_path", str(tmp_path / "logs"), "-checkpoint", ckpt,
            "-batch_size", "8", "-batch_size_dev", "8",
            "-rec_w_dim", "8", "-sender_out_dim", "8",
            "-img_h_dim", "16", "-rec_hidden", "16",
            "-baseline_hid_dim", "16", "-max_exchange", "3",
            "-descr_train", paths["descr"], "-descr_dev", paths["descr"],
            "-train_file", paths["train"], "-dev_file", paths["dev"],
            "-wv_dim", "16", "-glove_path", paths["glove"],
            "-exchange_samples", "0"]


def _jax_flags(argv):
    flags = jax_make_flags()
    jax_parse_args(flags, argv)
    return jax_finalize_flags(flags, argv)


def _port_flags(argv):
    flags = make_flags()
    parse_args(flags, argv)
    return finalize_flags(flags, argv)


def _write_jax_checkpoint(argv, num_classes, seed=0, stop_bias=1.5):
    """Random JAX weights as a reference .pt. The stop bias keeps random
    Adaptive conversations going past turn 0."""
    jflags = _jax_flags(argv)
    jm = JaxModules(JaxConfig.from_flags(jflags))
    params = jax_init_params(jm, jax.random.PRNGKey(seed),
                             num_classes=num_classes)
    params["receiver"]["s"]["bias"] = (params["receiver"]["s"]["bias"]
                                       + stop_bias)
    jax_save_reference_checkpoint(jflags.checkpoint, {"step": 7}, params)
    return jflags, params


@pytest.mark.parametrize("model_type", ["Adaptive", "Fixed"])
def test_predictor_matches_jax_on_reference_checkpoint(
        synthetic_dataset, tmp_path, model_type):
    paths = synthetic_dataset
    argv = _argv(paths, tmp_path, str(tmp_path / "ref.pt"), model_type)
    jpack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                  glove_path=paths["glove"])
    jflags, _ = _write_jax_checkpoint(argv, jpack.num_classes)
    want_pred = jax_serve.Predictor.from_checkpoint(jflags, jpack)

    pack = load_descriptions(paths["descr"], "glove.6B", 16,
                             glove_path=paths["glove"])
    flags = _port_flags(argv)
    got_pred = Predictor.from_checkpoint(flags, pack, device="cpu")
    plain = Predictor.from_checkpoint(flags, pack, device="cpu",
                                      use_kernel=False)
    assert got_pred.cfg.fixed_exchange == (model_type == "Fixed")

    before = fused_eval_exchange.launches
    n_steps = []
    for batch in load_hdf5(paths["dev"], 8, 0, False, True, pack.map_labels):
        x = batch["avgpool_512"]
        want = want_pred.predict(x)
        n_steps.append(want["n_steps"])
        for got in (got_pred.predict(x), plain.predict(x)):
            assert got["n_steps"] == want["n_steps"]
            np.testing.assert_array_equal(got["prediction"],
                                          np.asarray(want["prediction"]))
            np.testing.assert_allclose(got["log_probs"],
                                       np.asarray(want["log_probs"]),
                                       atol=1e-5)
            for k in ("sender_messages", "receiver_messages",
                      "conversation_length"):
                np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                              err_msg=k)
    assert fused_eval_exchange.launches == before   # CPU: plain version
    assert max(n_steps) > 1


def test_serve_main_lines_match_jax(synthetic_dataset, tmp_path, capsys):
    paths = synthetic_dataset
    argv = _argv(paths, tmp_path, str(tmp_path / "main.pt"))
    jpack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                  glove_path=paths["glove"])
    _write_jax_checkpoint(argv, jpack.num_classes, seed=1)
    capsys.readouterr()
    jax_serve.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    serve.main(argv, device="cpu")
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == 24          # 6 classes x 4 dev examples
    assert got == want
    for line in got:
        assert set(json.loads(line)) == {"example_id", "prediction",
                                         "label", "target"}


def test_predictor_without_device_raises_when_no_gpu(synthetic_dataset,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = synthetic_dataset
    pack = load_descriptions(paths["descr"], "fake", 16)
    cfg = GameConfig(img_feat_dim=512, img_h_dim=16, sender_out_dim=8,
                     rec_w_dim=8, rec_hidden=16, wv_dim=16, max_exchange=3)
    mods = init_params(AgentModules(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, mods, pack)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["-checkpoint", "unused.pt", "-descr_dev", paths["descr"],
                    "-wv_type", "fake", "-wv_dim", "16",
                    "-experiment_name", "x"])
    out = Predictor(cfg, mods, pack, device="cpu").predict(
        np.random.RandomState(0).randn(3, 512).astype(np.float32))
    assert out["prediction"].shape == (3,)


def test_checkpoint_round_trip(tmp_path):
    cfg = GameConfig(img_feat_dim=64, img_h_dim=16, sender_out_dim=8,
                     rec_w_dim=8, rec_hidden=16, wv_dim=12, max_exchange=3,
                     baseline_hid_dim=16)
    mods = init_params(AgentModules(cfg), seed=5)
    path = str(tmp_path / "port.pt")
    save_reference_checkpoint(path, {"step": 11}, mods)

    data, loaded = load_reference_checkpoint(path, cfg, device="cpu")
    assert data == {"step": 11}
    for agent in ("sender", "receiver"):
        a = getattr(mods, agent).state_dict()
        b = getattr(loaded, agent).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (agent, k)

    # The JAX package reads the same file into its trees.
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    template = jax_init_params(JaxModules(jcfg), jax.random.PRNGKey(0),
                               num_classes=4)
    jdata, jparams = jax_load_reference_checkpoint(path, template)
    assert jdata["step"] == 11
    carried = params_to_torch_state(jparams)
    for agent in ("sender", "receiver"):
        for k, v in getattr(mods, agent).state_dict().items():
            np.testing.assert_array_equal(carried[agent][k], v.numpy())


def test_non_reference_checkpoint_raises_clearly(tmp_path):
    """A file that is not a torch zip is read as msgpack, by its content
    and not its ``.pt`` name: a truncated map raises ``ValueError`` naming
    the path, in serving's loader, and the ``.pt`` reader refuses it."""
    path = tmp_path / "native.pt"
    path.write_bytes(b"\x85\xa6sender\x80")      # a truncated msgpack map
    cfg = GameConfig(sender_out_dim=8, rec_w_dim=8)
    with pytest.raises(ValueError, match="not a readable msgpack checkpoint"
                       ": truncated") as err:
        load_agents(str(path), cfg)
    assert str(path) in str(err.value)
    with pytest.raises(ValueError, match="not a reference-layout"):
        load_reference_checkpoint(str(path), cfg)


@pytest.mark.parametrize("extra", [
    [], ["-model_type", "Fixed", "-noshuffle_train"],
    ["-model_type", "AdaptiveAttention", "-attn_dim", "512"],
    ["--sender_out_dim=16", "--rec_w_dim=16", "-use_binary", "false"]])
def test_flags_match_jax(extra, tmp_path):
    argv = ["-experiment_name", "cfg", "-log_path", str(tmp_path)] + extra
    want = _jax_flags(argv).flag_values_dict()
    got = flags_from_argv(argv).flag_values_dict()
    for k in ("branch", "sha"):      # git provenance is not copied
        want.pop(k)
        assert got.pop(k) is None
    assert got == want


def test_log_load_round_trip(tmp_path):
    dump = _jax_flags(["-experiment_name", "dumped", "-model_type",
                       "Adaptive", "-rec_hidden", "48", "-max_exchange",
                       "7", "-log_path", str(tmp_path)])
    path = tmp_path / "dumped.json"
    path.write_text(json.dumps(dump.flag_values_dict()))
    flags = flags_from_argv(["-log_load", str(path), "-batch_size_dev",
                             "100"])
    assert (flags.rec_hidden, flags.max_exchange) == (48, 7)
    assert flags.img_feat_dim == 512 and not flags.fixed_exchange
    assert flags.batch_size_dev == 100
    cfg = GameConfig.from_flags(flags)
    assert cfg == GameConfig(**{k: getattr(cfg, k)
                                for k in cfg.__dataclass_fields__})


@pytest.mark.parametrize("wv_type", ["glove.6B", "fake"])
def test_descriptions_match_jax(synthetic_dataset, wv_type):
    paths = synthetic_dataset
    got = load_descriptions(paths["descr"], wv_type, 16,
                            glove_path=paths["glove"])
    want = jax_load_descriptions(paths["descr"], wv_type, 16,
                                 glove_path=paths["glove"])
    for k in ("desc", "desc_set", "desc_set_padded", "desc_set_mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.desc_set_lens == want.desc_set_lens
    assert got.label_id_to_idx == want.label_id_to_idx
    assert got.idx_to_label == want.idx_to_label


@pytest.mark.parametrize("shuffle,batch,truncate", [
    (False, 8, True), (True, 5, False), (True, 7, True)])
def test_hdf5_loader_matches_jax(synthetic_dataset, shuffle, batch,
                                 truncate):
    path = synthetic_dataset["train"]
    got = list(load_hdf5(path, batch, 3, shuffle, truncate))
    want = list(jax_load_hdf5(path, batch, 3, shuffle, truncate))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert os.path.exists(path)
