"""The photo-serving cell on the CPU at a tiny game and a small tower (the
published widths, two blocks, one of them full, on 168x224 photos): the
reference agrees with the port's photo path; a fault planted in the
timed path and the entry's controls come out not correct; the replay of
the sampled requests' features equals the served run; the tower's
operation counts equal PyTorch's own count of the reference's; and the
readers of its metrics take the tower's and attention's operations from
a trace."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gamebench import compare, run
from gamebench.counts_qwen_vision import (attention_times, is_attention_op,
                                          layers, parameters, tower_work)
from gamebench.entries.serve_pixels import make_pixels
from gamebench.entries.serve_photos import tower_state
from gamebench.reference import qwen_vision as ref
from gamebench.tests.conftest import tiny_sizes

CELL = "qwen2_5_vl_vit_adaptive.serve_photos"
CONFIG = "qwen2_5_vl_vit_adaptive"
# Two blocks at the published widths: at narrower widths the seeded
# weights' attention is nearly uniform and the planted faults move the
# pooled features by less than bfloat16's rounding does.
TOWER = {"depth": 2, "fullatt_block_indexes": [1], "out_hidden_size": 48}
SIZES = dict(tiny_sizes(CELL), img_feat_dim=48, feature_shape=[48],
             image_shape=[3, 168, 224], dev_per_class=2)


@pytest.fixture
def small_tower(monkeypatch):
    load = run.load_config

    def patched(name):
        config = load(name)
        if name == CONFIG:
            config["tower"]["vision_config"].update(TOWER)
        return config
    monkeypatch.setattr(run, "load_config", patched)


def result(capsys, trace=0, seed=2 ** 31 + 13):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], device="cpu", sizes=SIZES)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cell_is_correct_on_the_cpu(capsys, small_tower):
    out = result(capsys)
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == {"feature_gap", "token_gap", "bit_gap",
                                    "logprob_gap"}
    assert set(out["metrics"]) == {"serve_p95_ms", "setup_s"}
    assert out["attempted"] > 0


def test_traced_cell_reads_its_metrics(capsys, small_tower):
    out = result(capsys, trace=1)
    assert out["correct"], out["compared"]
    # No device on the CPU: the readers of device operations read
    # nothing; the operation counts read.
    assert set(out["metrics"]) == {"mfu.serve_photos"}


def test_full_attention_everywhere_is_not_correct(capsys, small_tower,
                                                  monkeypatch):
    from multimodalgame_tpu_torch.models import qwen_vision
    attention = qwen_vision.VisionTower._attention
    monkeypatch.setattr(
        qwen_vision.VisionTower, "_attention",
        lambda self, x, blk, layout, full: attention(self, x, blk, layout,
                                                     True))
    out = result(capsys)
    assert not out["correct"], out["compared"]
    assert out["compared"]["feature_gap"][0] > \
        out["compared"]["feature_gap"][1]


def test_smallest_windows_misread_is_not_correct(capsys, small_tower,
                                                 monkeypatch):
    """A fault confined to the smallest windows (the last window size's
    queries, keys and values read one window early) is caught by the
    merged tokens' gap."""
    from multimodalgame_tpu_torch.models import qwen_vision
    init = qwen_vision.Layout.__init__

    def misread(self, *args):
        init(self, *args)
        start, n, s = self.groups[-1]
        self.groups[-1] = (start - s, n, s)
    monkeypatch.setattr(qwen_vision.Layout, "__init__", misread)
    out = result(capsys)
    assert not out["correct"], out["compared"]
    assert out["compared"]["token_gap"][0] > \
        out["compared"]["token_gap"][1]


def test_controls_are_not_correct_and_the_replay_is_the_served_run(
        small_tower, monkeypatch):
    """Each control in the program's place is not correct against the
    cell's committed limits: the tower's controls by the tower's gaps
    alone, the TF32 game by the game's numbers alone (at the cell's own
    game, 32-bit messages over up to 10 turns, whose many bits a TF32
    rounding moves across; the tiny game's few bits it moves across
    none), on one request of 30 small photos. The features replayed
    after the window for the check equal, bit for bit, those the tower
    gave the served requests."""
    from multimodalgame_tpu_torch.models.qwen_vision import VisionTower
    served = []
    call = VisionTower.__call__

    def keep(self, key):
        out = call(self, key)
        served.append(out.clone())
        return out
    monkeypatch.setattr(VisionTower, "__call__", keep)
    entry, sets, made = cell_game_entry()
    entry.setup()
    del served[:]
    for slot in range(len(entry.pool)):
        entry.kept[slot] = entry.predict(slot)
    entry.after_window()
    assert set(entry.program_feats) == set(range(len(entry.pool)))
    assert len(entry.checked) == entry.program_tokens.shape[0] == 30
    for slot, feats in entry.program_feats.items():
        assert torch.equal(feats, served[slot])
    run.free(entry, "cpu")
    limits = compare.limits_for(CELL)
    sides = entry.control_readings(sets, made)
    assert set(sides) == {"control_fp8", "control_tf32_game",
                          "fault_full_attention", "fault_window_attention",
                          "fault_rope_swap", "fault_windows_joined"}
    for side, numbers in sides.items():
        read = ({"bit_gap", "logprob_gap", "answer_gap"}
                if side == "control_tf32_game"
                else {"feature_gap", "token_gap"})
        assert set(numbers) == read, side
        shown = {k: [numbers[k], lim] for k, lim in limits.items()
                 if k in numbers}
        over = {k for k, (v, lim) in shown.items() if v > lim}
        assert over, (side, shown)


def cell_game_entry():
    """The cell's entry at its own game on one request of 30 photos of
    168 x 224 and the small tower, on the CPU."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    spec = run.cell_spec(bench, CELL)
    config = run.load_config(spec["cell"]["config"])
    for key, value in dict(img_feat_dim=48, feature_shape=[48],
                           image_shape=[3, 168, 224],
                           dev_per_class=1).items():
        part = "flags" if key in config["flags"] else "data"
        config[part][key] = value
        config["cfg"][key] = value
    traffic = run.load_json(run.HERE, "traffic",
                            spec["cell"]["traffic"] + ".json")
    return run.build_entry(CELL, config, traffic, 2 ** 31 + 17,
                           torch.device("cpu"))


SMALL = {"depth": 4, "hidden_size": 64, "num_heads": 4,
         "intermediate_size": 96, "fullatt_block_indexes": [1, 3],
         "out_hidden_size": 48}


def test_tower_flops_are_pytorchs_count_of_the_reference():
    from multimodalgame_tpu_torch.models.qwen_vision import QWEN2_5_VL_7B
    vcfg = {**QWEN2_5_VL_7B, **SMALL, "initializer_range": 0.02}
    sd = ref.state(tower_state(vcfg, 1, "cpu"))
    for h, w in ((84, 140), (364, 504)):
        px = make_pixels({"num_classes": 2, "image_shape": [3, h, w],
                          "dev_per_class": 1}, "dev", 1, "cpu")
        with FlopCounterMode(display=False) as count:
            ref.forward(sd, vcfg, px)
        assert count.get_total_flops() == tower_work(2, vcfg, h, w)["flops"]
    assert parameters(vcfg) == sum(v.numel() for v in sd.values())
    # The published widths at 364 x 504, by formula: 1,228.55 GFLOP an
    # image, 676.5 M parameters.
    full = tower_work(1, QWEN2_5_VL_7B, 364, 504)
    assert round(full["flops"] / 1e9, 2) == 1228.55
    assert parameters(QWEN2_5_VL_7B) == 676_550_144
    table = layers(QWEN2_5_VL_7B, 364, 504)
    assert round(table[0]["flops"] / 1e9, 2) == 2.82
    attn = [x["flops"] for x in table if x["name"].endswith("attention")]
    assert round(sum(attn[i] for i in (7, 15, 23, 31)) / 1e9, 1) == 17.9
    assert round((sum(attn) - sum(attn[i] for i in (7, 15, 23, 31)))
                 / 1e9, 1) == 7.6


def test_attention_operations_in_a_trace():
    names = ["void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits"
             "<80, 128, 64, 4> >(Flash_fwd_params)",
             "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(...)",
             "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n",
             "void (anonymous namespace)::fused_exchange_kernel<false>(...)",
             "Memcpy HtoD (Pageable -> Device)"]
    trace = SimpleNamespace(dev_s=np.array([0, 10, 20, 30, 40]),
                            dev_e=np.array([5, 12, 23, 31, 47]),
                            dev_n=names)
    assert [is_attention_op(n) for n in names] == [True, True, False,
                                                   False, False]
    assert np.allclose(attention_times(trace), [5e-9, 2e-9])
