"""The attention presets, ``-desc_attn``, ``mou`` and ``-flipout_dev``
through the port's serving and CLI entry points, against the JAX
package's, on the CPU.

* ``Predictor`` with the ``fc`` context (and with the padded word sets)
  against JAX's ``Predictor`` on a ``.pt`` that JAX wrote.
* Every variant trains through the CLI (``cli.main``) for two epochs
  with finite losses, writes its checkpoints, and ``-eval_only`` on its
  ``_best`` reproduces the run's best dev accuracy.
* AdaptiveAttention's ``-eval_only -nofast_driver`` and ``-binary_only``
  against JAX's CLI on the same weights.
"""

import os
import re

import h5py
import numpy as np
import pytest

from multimodalgame_tpu import serve as jax_serve
from multimodalgame_tpu.data.hdf5_loader import load_hdf5 as jax_load_hdf5
from multimodalgame_tpu.utils.torch_interop import (
    save_reference_checkpoint as jax_save_reference_checkpoint)
from multimodalgame_tpu_torch import cli
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.serve import Predictor
from tests.port_runs import jax_flags, port_flags, small_argv
from tests.test_torch_attention_driver import (ATTENTION, DESC_ATTN,
                                               VARIANTS, _jax_weights)
from tests.test_torch_cli import _both, _read


@pytest.mark.parametrize("extra", [ATTENTION, DESC_ATTN],
                         ids=["AdaptiveAttention", "desc_attn"])
def test_predictor_matches_jax(synthetic_dataset, tmp_path, extra):
    paths = synthetic_dataset
    argv = small_argv(paths, tmp_path, "srv",
                      extra + ["-checkpoint", str(tmp_path / "ref.pt")])
    jf, pf = jax_flags(argv), port_flags(argv)
    jmods, params, jpack = _jax_weights(paths, jf, stop_bias=1.5, seed=1)
    jax_save_reference_checkpoint(jf.checkpoint, {"step": 7}, params)
    want_pred = jax_serve.Predictor.from_checkpoint(jf, jpack)
    pack = load_descriptions(paths["descr"], "glove.6B", 16,
                             glove_path=paths["glove"])
    got_pred = Predictor.from_checkpoint(pf, pack, device="cpu")
    n_steps = []
    for batch in jax_load_hdf5(paths["dev"], 8, 0, False, True,
                               jpack.map_labels):
        x = batch[pf.img_feat]
        ctx = batch["fc"] if pf.attn_extra_context else None
        want = want_pred.predict(x, data_context=ctx)
        got = got_pred.predict(x, data_context=ctx)
        n_steps.append(want["n_steps"])
        assert got["n_steps"] == want["n_steps"]
        np.testing.assert_array_equal(got["prediction"],
                                      np.asarray(want["prediction"]))
        np.testing.assert_allclose(got["log_probs"],
                                   np.asarray(want["log_probs"]), atol=1e-4)
        for k in ("sender_messages", "receiver_messages",
                  "conversation_length"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
    assert max(n_steps) > 1


# Each variant through the chunked driver, and two through the per-batch
# loop (``-nofast_driver``: the file's fc column, the host dev loop).
CLI_VARIANTS = {**VARIANTS,
                "AdaptiveAttention_per_batch": ATTENTION + ["-nofast_driver"],
                "flipout_dev_per_batch": VARIANTS["flipout_dev"]
                + ["-nofast_driver"]}


@pytest.mark.parametrize("name", list(CLI_VARIANTS))
def test_cli_trains_and_reevaluates_every_variant(synthetic_dataset,
                                                   tmp_path, name):
    """``python -m multimodalgame_tpu_torch``'s ``main`` on the CPU: two
    epochs (12 steps) end in "Finished training." with finite losses and
    both checkpoints; ``-eval_only`` on ``_best`` (configured from the
    run's JSON) reproduces its best dev accuracy, ``-flipout_dev``'s draws
    included (they are keyed by the checkpoint's step)."""
    argv = small_argv(synthetic_dataset, tmp_path, name, CLI_VARIANTS[name]
                      + ["-log_dev", "4", "-save_after", "0"])
    cli.main(argv, device="cpu")
    log = open(tmp_path / (name + ".log")).read()
    assert "Finished training." in log
    losses = [float(v) for v in re.findall(r"Loss [^:]*: (\S+)", log)]
    assert losses and np.isfinite(losses).all()
    ckpt = str(tmp_path / (name + ".pt"))
    assert os.path.isfile(ckpt) and os.path.isfile(ckpt + "_best")
    best = float(re.findall(r"best Development Accuracy: (\S+)", log)[-1])
    # A preset re-applies after -log_load, so its overridden flags are
    # given again (the reference's order, config.py:finalize_flags).
    cli.main(["-log_load", str(tmp_path / (name + ".json")), "-eval_only",
              "-checkpoint", ckpt + "_best"] + CLI_VARIANTS[name],
             device="cpu")
    row = open(tmp_path / (name + ".eval.csv")).read().splitlines()[1]
    fields = row.split(",")
    assert float(fields[4]) == best
    assert float(fields[5]) == best


def test_eval_only_and_binary_only_match_jax_with_attention(
        synthetic_dataset, tmp_path):
    """AdaptiveAttention through both CLIs on one set of JAX weights:
    ``-eval_only -nofast_driver`` (the host loop reading the ``fc``
    column) gives JAX's eval CSV row, and ``-binary_only`` JAX's
    ``bv.hdf5`` (ids, ranks and bits exactly, probabilities and scores to
    1e-4)."""
    dirs = _both(synthetic_dataset, tmp_path / "eval",
                 lambda d: ATTENTION + ["-eval_only", "-nofast_driver"])
    jd, pd = dirs["jax"], dirs["port"]
    want = _read(jd / "cli.eval.csv", jd).splitlines()[1].split(",")
    got = _read(pd / "cli.eval.csv", pd).splitlines()[1].split(",")
    assert got[:5] == want[:5]
    np.testing.assert_allclose([float(x) for x in got[5:]],
                               [float(x) for x in want[5:]], atol=1e-6)
    assert float(want[6]) > 0.5          # conversations past turn 0

    dirs = _both(synthetic_dataset, tmp_path / "bv",
                 lambda d: ATTENTION + ["-binary_only", "-batch_size_dev",
                                        "4", "-binary_output",
                                        str(d / "bv.hdf5")])
    with h5py.File(dirs["jax"] / "bv.hdf5", "r") as jf, \
            h5py.File(dirs["port"] / "bv.hdf5", "r") as pf:
        for name, exact, close in (
                ("Communication", ("ExampleId", "Index", "Rank",
                                   "BinaryVec"), ("BinaryProb",)),
                ("Predictions", ("ExampleId", "Rank", "StopVec",
                                 "StopMask"), ("Predictions", "StopProb"))):
            want, got = jf[name][()], pf[name][()]
            assert len(got) == len(want) > 24
            for field in exact:
                np.testing.assert_array_equal(got[field], want[field],
                                              err_msg=field)
            for field in close:
                np.testing.assert_allclose(got[field], want[field],
                                           atol=1e-4, err_msg=field)
