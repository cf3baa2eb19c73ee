"""Shared set-up of the tests that hold the port's driver, CLI and
checkpoints against the JAX package's: the small flags of
tests/test_driver.py:314-334, both packages' flag objects, and a parser
of the training log into its messages."""

import os
import re

import numpy as np

from multimodalgame_tpu.config import finalize_flags as jax_finalize_flags
from multimodalgame_tpu.config import make_flags as jax_make_flags
from multimodalgame_tpu.config import parse_args as jax_parse_args
from multimodalgame_tpu_torch.config import (finalize_flags, make_flags,
                                             parse_args)


def small_argv(paths, log_path, name, extra=()):
    """tests/test_driver.py's small Adaptive game; ``-branch``/``-sha``
    are given so that neither package asks git for them."""
    return [
        "-experiment_name", name, "-model_type", "Adaptive",
        "-log_path", str(log_path),
        "-batch_size", "8", "-batch_size_dev", "8",
        "-rec_w_dim", "8", "-sender_out_dim", "8",
        "-img_h_dim", "16", "-rec_hidden", "16", "-baseline_hid_dim", "16",
        "-max_exchange", "3", "-max_epoch", "2",
        "-top_k_dev", "2", "-top_k_train", "2",
        "-descr_train", paths["descr"], "-descr_dev", paths["descr"],
        "-train_file", paths["train"], "-dev_file", paths["dev"],
        "-wv_dim", "16", "-glove_path", paths["glove"],
        "-log_interval", "4", "-log_dev", "6",
        "-save_after", "2", "-save_interval", "4",
        "-exchange_samples", "1", "-branch", "main", "-sha", "0",
    ] + list(extra)


def jax_flags(argv):
    f = jax_make_flags()
    jax_parse_args(f, argv)
    jax_finalize_flags(f, argv)
    os.makedirs(f.log_path, exist_ok=True)
    return f


def port_flags(argv):
    f = make_flags()
    parse_args(f, argv)
    finalize_flags(f, argv)
    os.makedirs(f.log_path, exist_ok=True)
    return f


_STAMP = re.compile(r"^\d\d-\d\d-\d\d \d\d:\d\d:\d\d \[\d\] ", re.M)
_FLOAT = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")

# Lines left out of the comparisons: the modules' reprs, the resume lines
# (the format a resume adopts among them), wall-clock timings (the flag
# dumps start the runs) and the port's lines naming phase A's sampler and
# the step's route, which the JAX package does not print.
SKIPPED = ("Architecture:", "Loading from", "Loaded at step",
           "Checkpoint is a", "step timing", "Phase A sampler",
           "Step: graph", "Step: eager")


def runs_of(path):
    """The messages of each run appended to one log (a run starts at its
    flag dump), without time stamps and without the SKIPPED lines."""
    runs = []
    for m in _STAMP.split(open(path).read())[1:]:
        m = m.rstrip("\n")
        if m.startswith("Flag Values"):
            runs.append([])
        elif not any(s in m for s in SKIPPED):
            runs[-1].append(m)
    return runs


def assert_same_messages(got, want, rtol=1e-4, atol=1e-4,
                         exact=("Predictions", "Train:", "Eval:")):
    """Same messages in the same order: text equal once the floats are
    taken out, the floats within ``rtol``/``atol``, and the messages that
    start with an ``exact`` head equal as text."""
    assert [m.split("\n")[0][:40] for m in got] == \
        [m.split("\n")[0][:40] for m in want]
    for g, w in zip(got, want):
        if g.startswith(exact):
            assert g == w
            continue
        assert _FLOAT.sub("#", g) == _FLOAT.sub("#", w), (g, w)
        np.testing.assert_allclose(
            [float(x) for x in _FLOAT.findall(g)],
            [float(x) for x in _FLOAT.findall(w)], rtol=rtol, atol=atol,
            err_msg=w)
