"""The attention presets, ``-desc_attn``, ``mou`` and ``-flipout_dev``
through the port's entry points, against the JAX package's, on the CPU.

* ``train.run(flags, max_steps=8, device="cpu")`` against JAX's ``run``
  for AdaptiveAttention (``layer4_2`` maps and the ``fc`` context, the
  attention width cut to 8) and for ``-desc_attn`` on
  tests/test_driver.py's small flags (tests/port_runs.py), from JAX's
  initial weights and with JAX's uniforms: the same log line for line,
  the dumps as text, every other number to 1e-4.
* A dev sweep under ``-flipout_dev`` with a ragged tail, handed JAX's
  per-batch draws through ``eval_dev_device``'s ``uniforms`` seam, against
  JAX's ``eval_dev_device``: accuracy, statistics and predictions.

The serving and CLI entry points are in tests/test_torch_attention_cli.py.
"""

import jax
import numpy as np
import pytest

from multimodalgame_tpu.data.descriptions import (
    load_descriptions as jax_load_descriptions)
from multimodalgame_tpu.data.device_dataset import (
    DeviceDataset as JaxDeviceDataset)
from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.fast_eval import (
    eval_dev_device as jax_eval_dev_device)
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.train import run as jax_run
from multimodalgame_tpu.utils.torch_interop import (
    save_reference_checkpoint as jax_save_reference_checkpoint)
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import description_inputs
from multimodalgame_tpu_torch.game.fast_eval import eval_dev_device
from multimodalgame_tpu_torch.game.train import make_eval_exchange
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)
from tests.jax_uniforms import jax_step_provider, jax_uniforms
from tests.port_runs import (assert_same_messages, jax_flags, port_flags,
                             runs_of, small_argv)

# The small flags' widths with the attention presets' maps and context;
# the attention width is cut from the preset's 256.
ATTENTION = ["-model_type", "AdaptiveAttention", "-attn_dim", "8"]
DESC_ATTN = ["-desc_attn", "-desc_attn_dim", "6"]
VARIANTS = {
    "FixedAttention": ["-model_type", "FixedAttention", "-attn_dim", "8"],
    "AdaptiveAttention": ATTENTION,
    "desc_attn": DESC_ATTN,
    "mou": ["-sender_mix", "mou"],
    "mou_ignore_code": ["-sender_mix", "mou", "-ignore_code"],
    "flipout_dev": ["-flipout_dev", "-flipout_sen", "0.1", "-flipout_rec",
                    "0.1"],
}


def _jax_weights(paths, jf, stop_bias=0.0, seed=None):
    """JAX's initial weights for ``jf`` (those its ``run`` makes when
    ``seed`` is None), its modules and description pack."""
    jpack = jax_load_descriptions(paths["descr"], "glove.6B", 16,
                                  glove_path=paths["glove"])
    jmods = JaxModules(JaxConfig.from_flags(jf))
    params = jax_init_params(
        jmods, jax.random.PRNGKey(jf.random_seed if seed is None else seed),
        num_classes=jpack.num_classes, max_words=max(jpack.desc_set_lens))
    params["receiver"]["s"]["bias"] = params["receiver"]["s"]["bias"] \
        + stop_bias
    return jmods, params, jpack


@pytest.mark.parametrize("extra", [ATTENTION, DESC_ATTN],
                         ids=["AdaptiveAttention", "desc_attn"])
def test_run_matches_jax(synthetic_dataset, tmp_path, extra):
    paths = synthetic_dataset
    jf = jax_flags(small_argv(paths, tmp_path / "jax", "run", extra))
    pf = port_flags(small_argv(paths, tmp_path / "port", "run", extra))
    jmods, params, _ = _jax_weights(paths, jf)
    jax_save_reference_checkpoint(
        pf.checkpoint, {"step": 0, "best_dev_acc": 0.0}, params,
        jax_init_opt_states(jmods.cfg, params), "RMSprop")
    provider = jax_step_provider(jmods.cfg,
                                 jax.random.PRNGKey(jf.random_seed + 1),
                                 jf.batch_size)
    want = jax_run(jf, max_steps=8)
    got = run(pf, max_steps=8, device="cpu", uniforms=provider)
    want_log = runs_of(jf.log_file)[0]
    assert sum("Training Accuracy" in m for m in want_log) == 2
    assert sum(m.startswith("Epoch") and "Development Accuracy" in m
               for m in want_log) == 2
    assert_same_messages(runs_of(pf.log_file)[0], want_log)
    assert got["step"] == want["step"] == 8
    np.testing.assert_allclose(got["batch_accuracy"], want["batch_accuracy"],
                               atol=1e-6)
    assert got["best_dev_acc"] == pytest.approx(want["best_dev_acc"],
                                                abs=1e-6)
    if pf.visual_attn:
        assert pf.img_feat == "layer4_2" and pf.attn_extra_context
        assert got["modules"].sender.attn_W_g.in_features == 1000


def test_flipout_dev_sweep_matches_jax(synthetic_dataset, tmp_path):
    """Batches of 7 over 24 dev examples: three full batches draw from
    ``split(key_full, 3)``, the tail from ``split(key_tail, 1)`` (JAX
    fast_eval.py:233, 63)."""
    paths = synthetic_dataset
    argv = small_argv(paths, tmp_path, "flip", VARIANTS["flipout_dev"]
                      + ["-batch_size_dev", "7"])
    jf, pf = jax_flags(argv), port_flags(argv)
    jmods, params, jpack = _jax_weights(paths, jf, stop_bias=1.5, seed=3)
    mods = load_torch_state(AgentModules(GameConfig.from_flags(pf)),
                            params_to_torch_state(params))
    pack = load_descriptions(paths["descr"], "glove.6B", 16,
                             glove_path=paths["glove"])
    jds = JaxDeviceDataset.from_hdf5(paths["dev"], "avgpool_512",
                                     map_labels=jpack.map_labels)
    ds = DeviceDataset.from_hdf5(paths["dev"], "avgpool_512",
                                 map_labels=pack.map_labels, device="cpu")
    key = jax.random.PRNGKey(5)
    want = jax_eval_dev_device(jmods, params, jds, 0, False, 7, 2,
                               jax.numpy.asarray(jpack.desc), key)

    key_full, key_tail = jax.random.split(key)
    nb = ds.size // 7
    keys = list(jax.random.split(key_full, nb)) + \
        [jax.random.split(key_tail, 1)[0]]

    def uniforms(i, batch):
        return jax_uniforms(jmods.cfg, keys[i], batch, train=False)

    descs = description_inputs(pack, mods.cfg, "cpu")
    got = eval_dev_device(mods, make_eval_exchange(mods), ds, 0, False, 7,
                          2, uniforms=uniforms, **descs)
    assert got[0] == pytest.approx(want[0], abs=1e-6)
    for k in want[1]:
        assert got[1][k] == pytest.approx(want[1][k], abs=1e-6), k
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    # The flips matter: all-ones uniforms flip nothing and give another
    # sweep.
    calm = eval_dev_device(mods, make_eval_exchange(mods), ds, 0, False, 7,
                           2, uniforms=lambda i, b: {
                               k: v.fill_(1.0)
                               for k, v in uniforms(i, b).items()}, **descs)
    assert calm[1] != got[1]
    assert want[1]["conversation_lengths_mean"] > 0.5
