"""The port's spans (``utils/profiling.py:span``) on the CPU: free of the
profiler when it is off, recorded on the profiler's clock when the
benchmark's tracer runs it, and placed at the training driver's,
checkpoint writer's and predictor's layer boundaries."""

import time

import numpy as np
import pytest
import torch

from gamebench.trace import Trace, Tracer
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.serve import Predictor
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils.profiling import span
from tests.port_runs import port_flags, small_argv


def traced(fn):
    """``fn()`` under the benchmark's tracer, host only: ``(its result,
    the trace)``."""
    tracer = Tracer(on_card=False)
    tracer.start()
    try:
        out = fn()
    finally:
        tracer.stop()
    return out, Trace(tracer.events)


def spans_of(tr, name):
    return sorted((s, e) for s, e, n in zip(tr.cpu_s.tolist(),
                                            tr.cpu_e.tolist(), tr.cpu_n)
                  if n == name)


def inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_span_off_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record function {name!r} with the "
                             "profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    spent = {}
    with span("outer"):
        with span("inner", spent, "inner_s"):
            pass
    assert set(spent) == {"inner_s"}


def test_nested_spans_are_on_the_tracers_clock():
    def work():
        with span("outer"):
            with span("outer.inner"):
                torch.ones(4).sum()
    _, tr = traced(work)
    (outer,) = spans_of(tr, "mmg.outer")
    (inner,) = spans_of(tr, "mmg.outer.inner")
    assert inside(inner, outer)
    assert tr.t0 <= outer[0] and outer[1] <= tr.t1
    assert not [n for n in tr.cpu_n if n in ("outer", "outer.inner")]


@pytest.mark.parametrize("profiled", [False, True])
def test_into_adds_host_seconds(profiled):
    spent = {"s": 1.0}

    def work():
        for _ in range(2):
            with span("sleep", spent, "s"):
                time.sleep(0.01)
        with span("other", spent, "other"):
            pass
    if profiled:
        traced(work)
    else:
        work()
    assert 1.02 <= spent["s"] < 2.0
    assert 0.0 <= spent["other"] < 0.01


def test_driver_spans_one_per_dev_sweep_and_checkpoint(synthetic_dataset,
                                                       tmp_path):
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "spans"))
    summary, tr = traced(lambda: run(flags, max_steps=12, device="cpu"))
    assert set(summary["seconds"]) == {"step_spans", "dev_sweeps",
                                       "checkpoints"}
    lines = open(flags.log_file).read().splitlines()
    sweeps = spans_of(tr, "mmg.driver.dev_sweep")
    saves = spans_of(tr, "mmg.driver.checkpoint")
    assert len(sweeps) == sum(" Development Accuracy: " in m
                              and " Step: " in m for m in lines) == 2
    assert len(saves) == sum("] Checkpointing" in m for m in lines) >= 3
    assert summary["seconds"]["dev_sweeps"] > 0
    assert summary["seconds"]["checkpoints"] > 0
    # The best checkpoint is written outside the sweep's span.
    assert not any(inside(c, s) for c in saves for s in sweeps)
    for child, parents in (("mmg.dev.conversations", sweeps),
                           ("mmg.dev.confusion_matrix", sweeps),
                           ("mmg.checkpoint.snapshot", saves),
                           ("mmg.checkpoint.write", saves)):
        got = spans_of(tr, child)
        assert len(got) == len(parents)
        assert all(inside(c, p) for c, p in zip(got, parents)), child
    steps = spans_of(tr, "mmg.driver.steps")
    windows = spans_of(tr, "mmg.driver.log_window")
    # Log steps 0, 4 and 8, each a step of its own; the chunks between.
    assert len(spans_of(tr, "mmg.driver.log_dump")) == len(windows) == 3
    assert len(steps) >= 6
    assert len(spans_of(tr, "mmg.driver.plan")) >= 2
    assert not any(inside(w, s) for w in windows for s in steps)


def test_predict_spans_nest_in_each_call(synthetic_dataset):
    cfg = GameConfig(img_feat_dim=32, img_h_dim=16, sender_out_dim=8,
                     rec_w_dim=8, rec_hidden=16, wv_dim=16, max_exchange=3)
    pack = load_descriptions(synthetic_dataset["descr"], "fake", 16)
    pred = Predictor(cfg, init_params(AgentModules(cfg)), pack,
                     device="cpu")
    feats = np.random.RandomState(0).randn(5, 32).astype(np.float32)
    outs, tr = traced(lambda: [pred.predict(feats) for _ in range(3)])
    assert [o["prediction"].shape for o in outs] == [(5,)] * 3
    calls = spans_of(tr, "mmg.predict")
    assert len(calls) == 3
    for child in ("input", "replay", "copy_back"):
        got = spans_of(tr, "mmg.predict." + child)
        assert len(got) == 3
        assert all(inside(c, p) for c, p in zip(got, calls)), child
    order = [spans_of(tr, "mmg.predict." + c)[0][0]
             for c in ("input", "replay", "copy_back")]
    assert order == sorted(order)
