"""The pixel-serving cell on the CPU at a small game and a small image:
the reference agrees with the port's pixel path; a fault planted in the
timed path, the TF32 controls and the entry's planted fault come out not
correct; the tower's operation counts equal PyTorch's own count of the
reference's; and the readers of its metrics take the tower's operations
from a trace."""

import json
from types import SimpleNamespace

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from gamebench import run
from gamebench.counts_resnet import is_tower_op, tower_times, tower_work
from gamebench.entries.serve_pixels import make_pixels, tower_state
from gamebench.reference import resnet as ref
from gamebench.tests.conftest import tiny_sizes
from gamebench.tests.test_gamebench_run import cell_objects

CELL = "resnet34_adaptive.serve_pixels"
# The tiny game, reading the tower's 512 pooled features, on 35x35 crops.
SIZES = dict(tiny_sizes(CELL), img_feat_dim=512, feature_shape=[512],
             image_shape=[3, 35, 35])


def result(capsys, trace=0, seed=2 ** 31 + 11):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], device="cpu", sizes=SIZES)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cell_is_correct_on_the_cpu(capsys):
    out = result(capsys)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"serve_p95_ms", "setup_s"}
    assert out["attempted"] > 0


def test_traced_cell_reads_its_metrics(capsys):
    out = result(capsys, trace=1)
    assert out["correct"], out["compared"]
    # No device on the CPU: the readers of device operations read
    # nothing; the counts and the spans read.
    assert set(out["metrics"]) == {"mfu.serve_pixels", "predict_tower_ms"}
    assert out["metrics"]["predict_tower_ms"]["value"] > 0


def test_skipped_normalisation_is_not_correct(capsys, monkeypatch):
    from multimodalgame_tpu_torch.models import resnet
    monkeypatch.setattr(resnet, "normalize_pixels",
                        lambda pixels: pixels.float())
    out = result(capsys)
    assert not out["correct"], out["compared"]


def test_control_and_fault_are_not_correct():
    """The TF32 control (tower and game), the TF32 tower alone and the
    planted fault (one block's shortcut dropped), each in the program's
    place on the sampled requests, come out not correct against the
    cell's committed limits: at the cell's game (its 32-bit messages over
    up to 10 turns, which a tower's rounding moves across the rounding
    of some bit; the tiny game's few bits it moves across none), a few
    rows of small crops."""
    from gamebench import compare
    entry, sets, made = cell_objects(
        CELL, {"dev_per_class": 4, "image_shape": [3, 35, 35]})
    entry.setup()
    entry.window(0.5)
    entry.after_window()
    run.free(entry, "cpu")
    sides = entry.control_readings(sets, made)
    assert set(sides) == {"control_tf32", "control_tf32_tower",
                          "fault_residual"}
    limits = compare.limits_for(CELL)
    for side, numbers in sides.items():
        ok, shown = compare.verdict(numbers, limits)
        assert not ok, (side, shown)


def test_tower_flops_are_pytorchs_count_of_the_reference():
    sd = tower_state({"num_classes": 2, "image_shape": [3, 35, 35]}, 1,
                     "cpu")
    px = make_pixels({"num_classes": 2, "image_shape": [3, 227, 227],
                      "dev_per_class": 1}, "dev", 1, "cpu")[:1]
    with FlopCounterMode(display=False) as count:
        ref.features(sd, px)
    flops = count.get_flop_counts()["Global"]
    assert set(flops) == {torch.ops.aten.convolution}
    assert count.get_total_flops() == tower_work(1, 227)["flops"]
    assert round(tower_work(1, 227)["flops"] / 1e9, 2) == 8.30
    with FlopCounterMode(display=False) as count:
        ref.features(sd, px, ("fc",))
    assert count.get_total_flops() == tower_work(1, 227, "fc")["flops"]


def test_tower_operations_in_a_trace():
    names = ["void cudnn::conv_kernel", "Memcpy HtoD (Pageable -> Device)",
             "void (anonymous namespace)::fused_exchange_kernel<false>(...)",
             "Memset (Device)", "void at::native::max_pool_forward"]
    trace = SimpleNamespace(dev_s=np.array([0, 10, 20, 30, 40]),
                            dev_e=np.array([5, 12, 23, 31, 47]),
                            dev_n=names)
    assert [is_tower_op(n) for n in names] == [True, False, False, False,
                                               True]
    assert np.allclose(tower_times(trace), [5e-9, 7e-9])
