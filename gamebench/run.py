"""Run one cell of the benchmark of ``multimodalgame_tpu_torch``.

    python3 gamebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
a configuration (``gamebench/configs/<config>.json``) and a traffic mix
(``gamebench/traffic/<traffic>.json``, whose ``entry`` names the
generator ``gamebench/entries/<entry>.py``). The run makes its inputs and the
game's weights on the card from the seed, builds the program's objects
and warms up every shape the cell uses (``setup_s``), measures for
``--seconds`` with tracing off (``--trace 0``: the cell's end-to-end
metrics) or traces a fixed stretch of the same work (``--trace 1``: its
per-layer metrics, each read by ``gamebench/metrics/<metric>.py``), then
frees the program's state and holds what the timed path produced against
the plain reference (``gamebench/reference/``). The last line of standard
output is one JSON object; the compared numbers, each with its limit,
close standard error.

Without a CUDA card it exits with code 2 and prints no result.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

HERE = os.path.join(ROOT, "gamebench")
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodalgame_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    """The cell's configuration, traffic, end-to-end metrics and
    per-layer metrics, found by name in ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"gamebench: no workload {name!r} in "
                         "BENCHMARK.json")
    cell = cells[name]

    def applies(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"cell": cell, "end_to_end": e2e, "per_layer": layer}


def load_config(name: str) -> dict:
    """A configuration file: the program's flags and the sizes of the
    sets, merged into the one dict the reference and the counts read."""
    raw = load_json(HERE, "configs", name + ".json")
    return {**raw, "cfg": {**raw["flags"], **raw["data"]}}


def entry_class(name: str):
    """The generator a traffic file names: ``gamebench/entries/<name>.py``'s
    ``Entry``."""
    return importlib.import_module("gamebench.entries." + name).Entry


def build_entry(cell: str, config: dict, traffic: dict, seed: int, device):
    """The cell's inputs and weights made from the seed, and its entry
    built on them: ``(entry, sets, weights)``."""
    from gamebench import data, weights
    sets = data.make_sets(config["cfg"], seed, device)
    made = weights.make_weights(config["cfg"], seed, device)
    entry = entry_class(traffic["entry"])(
        cell, {**config, "sets": sets, "weights": made}, traffic, seed,
        device, workdir_for(cell))
    return entry, sets, made


def free(entry, device) -> None:
    """The program's state released and its memory returned, before the
    reference runs."""
    import torch
    entry.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gamebench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def workdir_for(cell: str) -> str:
    """The run's logs and checkpoints: under the temporary directory the
    run is given (``TMPDIR``), at a fixed path a cell."""
    import tempfile
    path = os.path.join(tempfile.gettempdir(), "gamebench", cell)
    os.makedirs(path, exist_ok=True)
    return path


def smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, sizes=None) -> int:
    """One run; ``device`` other than None (the tests' CPU runs) skips
    the look for a card, and ``sizes`` replaces configuration values (the
    tests' small games)."""
    args = parse(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    spec = cell_spec(bench, args.workload)
    cell = spec["cell"]
    import torch
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < int(cell["chips"]):
            log(f"gamebench: {args.workload} needs {cell['chips']} CUDA "
                f"card(s); found {found}")
            return 2
        device = torch.device("cuda", 0)
    on_card = torch.device(device).type == "cuda"
    config = load_config(cell["config"])
    for key, value in (sizes or {}).items():
        part = "flags" if key in config["flags"] else "data"
        config[part][key] = value
        config["cfg"][key] = value
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    if on_card:
        log("card: " + smi("name,power.limit"))
    log("TF32 in matmuls allowed: "
        f"{torch.backends.cuda.matmul.allow_tf32}")

    from gamebench import compare, program, trace
    entry, sets, made = build_entry(args.workload, config, traffic,
                                    args.seed, device)
    entry.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _START
    if on_card:
        log("clocks.sm before the window: " + smi("clocks.sm"))
    before = program.counters()

    metrics, breakdown, device_extra = {}, None, {}
    if args.trace:
        tracer = trace.Tracer(on_card)
        done = entry.traced_window(args.seconds, tracer)
        t_read = time.perf_counter()
        tr = trace.Trace(tracer.events)
        tracer.events = None
        ctx = {**entry.metric_context(), "trace": tr, "cfg": config["cfg"]}
        for m in spec["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is None:
                log(f"{m['name']}: nothing to read in this run")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.dev_s)} device operations, "
            f"{len(tr.cpu_s)} host events, read in "
            f"{time.perf_counter() - t_read:.1f} s")
        device_extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
    else:
        done = entry.window(args.seconds)
        done["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": done[m["name"]], "unit": m["unit"]}
    if on_card:
        torch.cuda.synchronize()
        log("clocks.sm after the window: " + smi("clocks.sm"))
    after = program.counters()
    log("route: " + json.dumps({k: after[k] - before[k] for k in after}))
    # What the window left, carried on by the program for the check.
    entry.after_window()
    log("route in all: " + json.dumps(program.counters()))
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # The program's state goes before the reference runs.
    free(entry, device)
    numbers = entry.check(sets, made)
    numbers.update(getattr(entry, "info", {}))
    correct, shown = compare.verdict(numbers,
                                     compare.limits_for(args.workload))
    found = forbidden_modules()
    if found:
        log("gamebench: the run loaded " + ", ".join(found))
        return 3
    for name, value in numbers.items():
        if name not in shown:
            log(f"{name}: {value!r} (shown, not compared)")
    for name, (value, limit) in shown.items():
        log(f"{name}: {value!r} (limit {limit!r})")
    out = {"correct": bool(correct), "attempted": int(done["attempted"]),
           "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if on_card
                               else "cpu"),
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": peak, **device_extra}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = shown
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
