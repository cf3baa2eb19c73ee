"""The readers of the program's spans (``gamebench/spans.py`` and the
seven metrics on it): a planted trace reads what its spans and device
intervals give, a CPU traced run of each cell reads every one of its
cell's, and the predictor's split reads nothing when the program's calls
and the harness's request marks differ."""

import json

import pytest
from torch.autograd import DeviceType

from gamebench import run, trace
from gamebench.tests.conftest import tiny_sizes

DRIVER = ("driver_stall.train", "dev_sweep_idle_ms.train",
          "checkpoint_idle_ms.train", "log_window_idle_ms.train")
PREDICT = ("predict_input_ms", "predict_replay_ms", "predict_copyback_ms")


class Event:
    """A profiler event as ``trace.Trace`` reads it; times in us."""

    def __init__(self, name, start, end, card=False):
        self._name, self.s, self.e, self.card = name, start, end, card

    def name(self):
        return self._name

    def start_ns(self):
        return int(self.s * 1000)

    def duration_ns(self):
        return int((self.e - self.s) * 1000)

    def device_type(self):
        return DeviceType.CUDA if self.card else DeviceType.CPU

    def is_user_annotation(self):
        return False


def read(name, kind, events):
    tr = trace.Trace([Event(trace.WINDOW, 0, 1000)] + events)
    return run.metric_reader(name)({"kind": kind, "trace": tr})


# Busy 120-380, 610-700 and 800-850 us of a 1,000 us window: idle 600.
CARD = [Event("k", 120, 300, True), Event("k", 250, 380, True),
        Event("k", 610, 700, True), Event("k", 800, 850, True)]
DRIVER_SPANS = [
    Event("mmg.driver.steps", 100, 200),           # idle 20
    Event("mmg.driver.log_window", 200, 400),      # idle 20
    Event("mmg.driver.steps", 500, 600),           # idle 100
    Event("mmg.driver.dev_sweep", 600, 900),       # idle 160
    Event("mmg.dev.conversations", 600, 880),
    Event("mmg.driver.checkpoint", 900, 950),      # idle 50
    Event("mmg.checkpoint.write", 910, 950),
    Event("mmg.driver.checkpoint", 960, 980),      # idle 20
    Event("mmg.driver.log_window", 990, 1000),     # cut by the stop
]


@pytest.mark.parametrize("name,want", [
    ("driver_stall.train", 100.0 * (600 - 120) / 1000),
    ("dev_sweep_idle_ms.train", 0.160),
    ("checkpoint_idle_ms.train", 0.035),
    ("log_window_idle_ms.train", 0.020),
])
def test_planted_driver_spans(name, want):
    assert read(name, "train", CARD + DRIVER_SPANS) == pytest.approx(want)
    assert read(name, "serve", CARD + DRIVER_SPANS) is None


@pytest.mark.parametrize("name", DRIVER)
def test_driver_readers_need_their_spans(name):
    assert read(name, "train", CARD) is None


def requests(n):
    """``n`` requests 200 us apart, each marked by the harness and
    split by the program into its input (30 us), replay (50 us) and
    copy back (80 us)."""
    out = []
    for i in range(n):
        a = 10 + 200 * i
        out += [Event("gamebench.request", a, a + 190),
                Event("mmg.predict", a + 5, a + 185),
                Event("mmg.predict.input", a + 10, a + 40),
                Event("mmg.predict.replay", a + 40, a + 90),
                Event("mmg.predict.copy_back", a + 95, a + 175)]
    return out


@pytest.mark.parametrize("name,want", zip(PREDICT, (0.030, 0.050, 0.080)))
def test_planted_predict_spans(name, want):
    assert read(name, "serve", requests(4)) == pytest.approx(want)
    assert read(name, "train", requests(4)) is None


@pytest.mark.parametrize("name", PREDICT)
def test_predict_readers_need_one_call_a_request(name):
    extra_mark = requests(3) + [Event("gamebench.request", 700, 750)]
    assert read(name, "serve", extra_mark) is None
    missing_call = [e for e in requests(3)
                    if not (e.name() == "mmg.predict" and e.s > 400)]
    assert read(name, "serve", missing_call) is None
    assert read(name, "serve", []) is None


@pytest.mark.parametrize("cell,names", [("adaptive.train", DRIVER),
                                        ("adaptive.serve", PREDICT)])
def test_cpu_traced_run_reads_the_spans(capsys, cell, names):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                   "--seconds", "0.5", "--trace", "1"], device="cpu",
                  sizes=tiny_sizes(cell))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"]
    spec = run.cell_spec(run.load_json(run.ROOT, "BENCHMARK.json"), cell)
    assert set(names) <= {m["name"] for m in spec["per_layer"]}
    for name in names:
        assert out["metrics"][name]["value"] > 0, name
