"""Every cell and metric of BENCHMARK.json is found by name, and a new
configuration, traffic mix, cell and metric are picked up from added
files alone."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

from gamebench import run

ROOT = run.ROOT


def bench():
    return run.load_json(ROOT, "BENCHMARK.json")


def test_every_cell_and_metric_is_found():
    b = bench()
    assert b["paths"] == ["gamebench"]
    for cell in b["workloads"]:
        spec = run.cell_spec(b, cell["name"])
        config = run.load_config(cell["config"])
        traffic = run.load_json(run.HERE, "traffic",
                                cell["traffic"] + ".json")
        assert callable(run.entry_class(traffic["entry"]))
        assert config["source"] == next(
            c["source"] for c in b["configs"] if c["name"] == cell["config"])
        assert spec["end_to_end"] and spec["per_layer"]
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
        limits = run.load_json(run.HERE, "limits", cell["name"] + ".json")
        assert limits["limits"]
    for m in b["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_configuration_file_is_complete():
    for c in bench()["configs"]:
        cfg = run.load_config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        for key in ("img_h_dim", "sender_out_dim", "rec_hidden",
                    "max_exchange", "batch_size", "num_classes"):
            assert key in cfg["cfg"]


def load_copy(root):
    spec = importlib.util.spec_from_file_location(
        "gamebench_copy_run", os.path.join(root, "gamebench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree(root):
    return {os.path.relpath(os.path.join(dp, f), root):
            open(os.path.join(dp, f), "rb").read()
            for dp, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in dp}


def test_added_files_are_picked_up_without_edits(tmp_path):
    shutil.copytree(os.path.join(ROOT, "gamebench"),
                    tmp_path / "gamebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    before = tree(tmp_path / "gamebench")
    g = tmp_path / "gamebench"
    cfg = json.load(open(g / "configs" / "adaptive.json"))
    cfg["flags"]["max_exchange"] = 5
    json.dump(cfg, open(g / "configs" / "adaptive5.json", "w"))
    json.dump({"entry": "serve", "set": "dev", "batch_size": 1,
               "sample": 2, "warmup_calls": 2, "trace_seconds": 1},
              open(g / "traffic" / "serve_b1.json", "w"))
    json.dump({"limits": {"bit_gap": 1e-4}},
              open(g / "limits" / "adaptive5.serve_b1.json", "w"))
    (g / "metrics" / "requests.serve.py").write_text(
        "def read(ctx):\n    return float(len(ctx['batches']))\n")
    (g / "entries" / "echo.py").write_text("class Entry:\n    pass\n")
    b["configs"].append({"name": "adaptive5", "source": "x",
                         "file": "gamebench/configs/adaptive5.json",
                         "reduced": ["max_exchange"], "why": "x"})
    b["workloads"].append({"name": "adaptive5.serve_b1",
                           "config": "adaptive5", "traffic": "serve_b1",
                           "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "serve_p95_ms":
            m["workloads"].append("adaptive5.serve_b1")
    b["per_layer"].append({"name": "requests.serve", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "predictor", "moves": "serve_p95_ms"})
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    mod = load_copy(str(tmp_path))
    spec = mod.cell_spec(mod.load_json(str(tmp_path), "BENCHMARK.json"),
                         "adaptive5.serve_b1")
    assert [m["name"] for m in spec["end_to_end"]] == ["serve_p95_ms",
                                                      "setup_s"]
    names = [m["name"] for m in spec["per_layer"]]
    assert names == ["requests.serve"]
    assert mod.load_config("adaptive5")["cfg"]["max_exchange"] == 5
    assert mod.metric_reader("requests.serve")({"batches": [1, 1]}) == 2.0
    # A metric without a workloads key reaches every cell that reports
    # what it moves, the old serving cell too.
    old = mod.cell_spec(mod.load_json(str(tmp_path), "BENCHMARK.json"),
                        "adaptive.serve")
    assert "requests.serve" in [m["name"] for m in old["per_layer"]]
    # A new kind of entry is one added module, found by its name.
    found = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from gamebench import run; "
         "print(run.entry_class('echo').__module__)"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120)
    assert found.stdout.strip() == "gamebench.entries.echo", found.stderr
    after = tree(g)
    assert all(after[p] == content for p, content in before.items())
