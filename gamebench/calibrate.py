"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size (the benchmark's runs do not run this).

    python3 gamebench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 3,4,5 --seconds 51 [--out chiprun_out/r.jsonl]

For each seed: a run as ``run.py`` makes it (set-up, a window of
``--seconds``, what the program does past it), the program freed, and the
numbers ``correct`` compares, against the reference. For each of
``--control-seeds`` too: the entry's control (the reference itself with
its products in TF32, the nearest precision below the configuration's
float32 with TF32 off) and its planted faults, each in the program's
place (``Entry.control_readings``). One JSON line a reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from gamebench import run  # noqa: E402


def readings(cell, config, traffic, seed, device, seconds, control):
    """``{side: numbers}``: the program's, and with ``control`` the
    control's and each fault's."""
    entry, sets, made = run.build_entry(cell, config, traffic, seed, device)
    entry.setup()
    entry.window(seconds)
    entry.after_window()
    run.free(entry, device)
    out = {"program": {**entry.check(sets, made),
                       **getattr(entry, "info", {})}}
    if control:
        out.update(entry.control_readings(sets, made))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    cell = run.cell_spec(bench, args.workload)["cell"]
    config = run.load_config(cell["config"])
    traffic = run.load_json(run.HERE, "traffic", cell["traffic"] + ".json")
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    controls = {int(s) for s in filter(None, args.control_seeds.split(","))}
    seeds = [int(s) for s in filter(None, args.seeds.split(","))]
    seeds += sorted(controls - set(seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        for side, numbers in readings(args.workload, config, traffic, seed,
                                      device, args.seconds,
                                      seed in controls).items():
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "side": side, "numbers": numbers,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()


if __name__ == "__main__":
    main()
