"""The cells on the card, a short window each (run by the card's test
command: ``python -m pytest gamebench/tests -m cuda``)."""

import json
import os
import subprocess
import sys

import pytest

from gamebench import run

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell,route", [
    ("adaptive.train", "train_kernel_launches"),
    ("adaptive_attention.train", None),
    ("adaptive.serve", "eval_kernel_launches")])
def test_cell_runs_correct_on_the_card(card, cell, route):
    proc = subprocess.run(
        [sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
         cell, "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    line = next(ln for ln in proc.stderr.splitlines()
                if ln.startswith("route: "))
    launches = json.loads(line[len("route: "):])
    kernels = launches["train_kernel_launches"] + \
        launches["eval_kernel_launches"]
    if route is None:
        assert kernels == 0
    else:
        assert launches[route] > 0
