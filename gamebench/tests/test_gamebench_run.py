"""The harness end to end on the CPU at a small size, without its look
for a card: the reference agrees with the port's CPU path, and a run
whose timed path is broken underneath comes out not correct."""

import ast
import json
import os

import pytest
import torch

from gamebench import run
from gamebench.tests.conftest import tiny_sizes

CELLS = ["adaptive.train", "adaptive_attention.train", "adaptive.serve"]


def result(capsys, cell, seed=2 ** 31 + 7, **kw):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(kw.pop("trace", 0))],
                  device="cpu", sizes=kw.pop("sizes", tiny_sizes(cell)))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "adaptive.train", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_cpu_path(capsys, cell):
    out = result(capsys, cell)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"
    assert out["metrics"]
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ["adaptive.train", "adaptive.serve"])
def test_traced_run_reads_its_metrics(capsys, cell):
    out = result(capsys, cell, trace=1)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert "breakdown" in out
    names = set(out["metrics"])
    assert ("mfu.train" in names) or ("mfu.serve" in names)


def _frozen(monkeypatch):
    from multimodalgame_tpu_torch.game import train
    monkeypatch.setattr(train, "apply_flat_updates", lambda *a, **k: None)


def _half(monkeypatch):
    from multimodalgame_tpu_torch.game import fast_train
    orig = fast_train.compute_losses_fast

    def half(modules, data, target, desc, top_k, batch_denom, **kw):
        # The second half's rows replaced by the first half's: the mean
        # is taken over the first half alone.
        rows = torch.arange(data.shape[0]) % (data.shape[0] // 2)
        if kw.get("data_context") is not None:
            kw["data_context"] = kw["data_context"][rows]
        return orig(modules, data[rows], target[rows], desc, top_k,
                    batch_denom, **kw)
    monkeypatch.setattr(fast_train, "compute_losses_fast", half)


def _flip(monkeypatch):
    from multimodalgame_tpu_torch.game import fast_train
    orig = fast_train.sample_conversation

    def flipped(*a, **k):
        s = orig(*a, **k)
        z = s.z_bits.clone()
        z[0, 0, 0] = 1 - z[0, 0, 0]
        return s._replace(z_bits=z)
    monkeypatch.setattr(fast_train, "sample_conversation", flipped)


@pytest.mark.parametrize("cell", ["adaptive.train",
                                  "adaptive_attention.train"])
@pytest.mark.parametrize("fault", [_frozen, _half, _flip])
def test_broken_training_step_is_not_correct(capsys, monkeypatch, cell,
                                             fault):
    fault(monkeypatch)
    out = result(capsys, cell)
    assert not out["correct"], out["compared"]


def _answer(monkeypatch):
    from multimodalgame_tpu_torch.game import train
    orig = train.answer_scores
    monkeypatch.setattr(train, "answer_scores",
                        lambda cfg, ex: orig(cfg, ex).roll(1, dims=-1))


def _message(monkeypatch):
    from multimodalgame_tpu_torch.game import train
    orig = train._kernel_exchange

    def altered(*a, **k):
        ex = orig(*a, **k)
        z = ex.sen_feats.clone()
        z[0, -1, 0] = 1 - z[0, -1, 0]
        return ex._replace(sen_feats=z)
    monkeypatch.setattr(train, "_kernel_exchange", altered)


def _half_batch(monkeypatch):
    from multimodalgame_tpu_torch.game import train
    orig = train._kernel_exchange

    def half(cfg, params, data, desc, mask):
        b = data.shape[0]
        if b < 2:
            return orig(cfg, params, data, desc, mask)
        h = (b + 1) // 2
        rows = torch.arange(b) % h
        return orig(cfg, params, data[rows], desc, mask)
    monkeypatch.setattr(train, "_kernel_exchange", half)


@pytest.mark.parametrize("fault", [_answer, _message, _half_batch])
def test_broken_serving_is_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    out = result(capsys, "adaptive.serve")
    assert not out["correct"], out["compared"]


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    top = os.path.join(run.HERE, sub)
    for dp, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(imports(path)) & {"jax", "jaxlib", "flax",
                                    "multimodalgame_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "multimodalgame_tpu_torch" not in set(imports(path)), path


# Cadences short enough for the CPU: a period of 4 steps, a log window
# every 2 steps, a dev sweep and a checkpoint every 4.
SHORT = {"period": 4, "flags": {"log_interval": 2, "log_dev": 4,
                                "save_after": 2, "save_interval": 4,
                                "exchange_samples": 3}}


def cell_objects(cell, sizes, seed=2 ** 31 + 11, traffic=None):
    """The cell's entry, sets and weights on the CPU at ``sizes``, with
    ``traffic`` replacing the traffic file's values."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    spec = run.cell_spec(bench, cell)
    config = run.load_config(spec["cell"]["config"])
    for key, value in sizes.items():
        part = "flags" if key in config["flags"] else "data"
        config[part][key] = value
        config["cfg"][key] = value
    traffic = {**run.load_json(run.HERE, "traffic",
                               spec["cell"]["traffic"] + ".json"),
               **(traffic or {})}
    return run.build_entry(cell, config, traffic, seed, torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell):
    """The control and each planted fault, in the program's place at a
    CPU size, come out not correct (the cells' widths, few rows; the
    training cells' cadences short)."""
    from gamebench import compare
    train = cell.endswith(".train")
    entry, sets, made = cell_objects(
        cell, {"train_per_class": 12, "dev_per_class": 4} if train else {},
        traffic=SHORT if train else None)
    entry.setup()
    entry.window(0.0 if train else 0.5)
    entry.after_window()
    run.free(entry, "cpu")
    limits = compare.limits_for(cell)
    sides = entry.control_readings(sets, made)
    assert "control_tf32" in sides
    for side, numbers in sides.items():
        ok, shown = compare.verdict(numbers, limits)
        assert not ok, (side, shown)


def test_a_tie_taken_the_other_way_is_followed(monkeypatch):
    """A trainer whose draw fell the other way at one of the reference's
    ties reads no change gap against the reference's branches, and a
    wide one against its own draws alone."""
    from gamebench import compare
    from gamebench.reference import game, train
    monkeypatch.setattr(game, "TIE", 0.05)
    entry, sets, made = cell_objects("adaptive.train",
                                     tiny_sizes("adaptive.train"))
    run.free(entry, "cpu")
    cfg, seed, steps = entry.cfg, 5, 4
    own = train.follow(cfg, sets, made, seed, steps)
    # A message bit of the first turn, which every row talks in.
    later = sorted(t for t in own["ties"]
                   if t[1] > 0 and t[2] == 0 and t[3] == "z")
    assert later
    tie = later[0][1:]
    got = train.follow(cfg, sets, made, seed, steps, flip={tie})
    refs = train.follow_branches(cfg, sets, made, seed, steps,
                                 forced=got["bits"])
    monkeypatch.setattr(train, "BRANCHES", len(refs[0]["ties"]))
    refs = train.follow_branches(cfg, sets, made, seed, steps,
                                 forced=got["bits"])
    assert compare.train_numbers(got, refs)["change_gap"] < 1e-9
    assert compare.train_numbers(got, refs[:1])["change_gap"] > 1e-6
