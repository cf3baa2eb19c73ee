#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. probe   — torch/CUDA/nvcc versions and the card's name and power limit;
             exits non-zero when no CUDA device is available;
2. build   — compiles every CUDA source of the port (one nvcc each, all
             started together) and prints ptxas's report;
3. kernels — the fused eval-exchange kernel against its plain PyTorch
             version on the card, at the canonical Adaptive width (feat
             512, sender hidden 256, 32-bit messages, receiver hidden 64,
             wv 100, 30 classes, 10 turns) for batches 1, 7, 64, 100 and
             the variants fixed, prod, ignore_code and corruption "0:3,7";
4. serve   — random canonical-width weights (stop bias STOP_BIAS) saved
             as a reference .pt,
             loaded by ``Predictor.from_checkpoint`` on cuda, four request
             batches (1, 7, 64, 100) answered through the kernel (its
             launch count must grow by exactly 4) and held against a
             plain ``Predictor(use_kernel=False)`` on the same card;
5. timing  — CUDA-event medians of the kernel and its plain version, and
             host-clock medians of ``Predictor.predict`` end to end, at
             batches 1, 64 and 100; at batch 64 also the kernel with one
             turn, which splits its time into the once-per-conversation
             part and the cost of a turn.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Canonical Adaptive model (bench.py:41-48, tools/demo.sh:22-29).
CANON = dict(img_feat_dim=512, img_h_dim=256, sender_out_dim=32,
             rec_w_dim=32, rec_hidden=64, wv_dim=100, max_exchange=10,
             fixed_exchange=False)
NUM_CLASSES = 30
BATCHES = (1, 7, 64, 100)
VARIANTS = {"adaptive": {}, "fixed": {"fixed_exchange": True},
            "prod": {"sender_mix": "prod"}, "ignore_code": {"ignore_code": True},
            "corrupt_0:3,7": {}}
TIMED_BATCHES = (1, 64, 100)
# Random weights stop every conversation after turn 0; this bias on the
# stop unit makes them run 5-7 of the 10 turns, so the served answers
# depend on the stop-mask chain.
STOP_BIAS = 2.5
REPS = 50
# Published H100 SXM peaks: f32 outside the
# tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def probe():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    log({"phase": "probe", "python": sys.version.split()[0],
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})
    from multimodalgame_tpu_torch.ops import cuda_build
    nv = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60, check=True)
    log("nvcc: " + nv.stdout.strip().splitlines()[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    # Full f32 in the plain PyTorch path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build():
    from multimodalgame_tpu_torch.ops import cuda_build
    sources = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    results = cuda_build.build(sources)
    secs = time.perf_counter() - t0
    for path, text in results:
        log(f"built {path.name}\n{text.strip()}")
    log({"phase": "build", "sources": sources, "seconds": secs})


def canonical_cfg(**kw):
    from multimodalgame_tpu_torch.game.config import GameConfig
    return GameConfig(**{**CANON, **kw})


def features(batch: int, seed: int) -> np.ndarray:
    """Class prototypes plus 0.3 noise, as data/synthetic.py writes them."""
    rng = np.random.RandomState(seed)
    proto = np.random.RandomState(1234).randn(NUM_CLASSES, 512)
    cls = rng.randint(0, NUM_CLASSES, size=batch)
    return np.abs(proto[cls] + 0.3 * rng.randn(batch, 512)).astype(np.float32)


def descriptions() -> np.ndarray:
    return np.random.RandomState(7).randn(NUM_CLASSES, 100).astype(np.float32)


def make_agents(cfg, device):
    import torch
    from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
    mods = init_params(AgentModules(cfg), seed=0, device=device)
    with torch.no_grad():
        mods.receiver.s.bias.fill_(STOP_BIAS)
    return mods


def check_kernels(device):
    import torch
    from multimodalgame_tpu_torch.game.masks import build_mask
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        compare_outputs, fused_eval_exchange, fused_eval_exchange_reference,
        kernel_params)
    desc = torch.from_numpy(descriptions()).to(device)
    worst = {"max_abs_err": 0.0, "tie_rows": 0, "cases": 0}
    for name, kw in VARIANTS.items():
        cfg = canonical_cfg(**kw)
        params = kernel_params(make_agents(cfg, device))
        corrupt = (torch.from_numpy(build_mask("0:3,7", cfg.rec_w_dim))
                   .to(device) if name.startswith("corrupt") else None)
        for batch in BATCHES:
            data = torch.from_numpy(features(batch, seed=batch)).to(device)
            with torch.inference_mode():
                got = fused_eval_exchange(cfg, params, data, desc, corrupt)
                want = fused_eval_exchange_reference(cfg, params, data, desc,
                                                     corrupt)
            torch.cuda.synchronize()
            rep = compare_outputs(cfg, got, want)
            log({"phase": "kernels", "kernel": "fused_eval_exchange",
                 "variant": name, "batch": batch, **rep})
            if not rep["ok"]:
                raise SystemExit(f"kernel disagrees with its plain version: "
                                 f"{name} batch {batch}")
            worst["max_abs_err"] = max(worst["max_abs_err"],
                                       rep["max_abs_err"])
            worst["tie_rows"] += rep["tie_rows"]
            worst["cases"] += 1
    return worst


def serve_requests(device, workdir):
    import torch
    from multimodalgame_tpu_torch.config import (finalize_flags, make_flags,
                                                 parse_args)
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        compare_outputs, fused_eval_exchange)
    from multimodalgame_tpu_torch.serve import Predictor
    from multimodalgame_tpu_torch.utils.torch_interop import (
        save_reference_checkpoint)

    cfg = canonical_cfg()
    ckpt = os.path.join(workdir, "canonical.pt")
    save_reference_checkpoint(ckpt, {"step": 0}, make_agents(cfg, "cpu"))
    argv = ["-model_type", "Adaptive", "-experiment_name", "chip_smoke",
            "-log_path", workdir, "-checkpoint", ckpt,
            "-img_h_dim", "256", "-sender_out_dim", "32", "-rec_w_dim", "32",
            "-rec_hidden", "64", "-wv_dim", "100", "-max_exchange", "10"]
    flags = make_flags()
    parse_args(flags, argv)
    finalize_flags(flags, argv)
    desc = descriptions()
    pack = DescriptionPack(desc, desc, [1] * NUM_CLASSES,
                           {i: i for i in range(NUM_CLASSES)},
                           {i: f"class{i}" for i in range(NUM_CLASSES)})
    pred = Predictor.from_checkpoint(flags, pack, device=device)
    plain = Predictor.from_checkpoint(flags, pack, device=device,
                                      use_kernel=False)
    requests = [features(b, seed=100 + b) for b in BATCHES]

    # The main path: four requests through the kernel, counted alone.
    fused_eval_exchange.launches = 0
    outs = [pred.predict(x) for x in requests]
    torch.cuda.synchronize()
    launches = fused_eval_exchange.launches
    log({"phase": "serve", "requests": list(BATCHES),
         "kernel_launches": launches})
    if launches != len(requests):
        raise SystemExit(f"expected {len(requests)} kernel launches, "
                         f"counted {launches}")

    ties = 0
    for x, out in zip(requests, outs):
        ref = plain.predict(x)
        assert out["prediction"].shape == (len(x),)
        assert np.isfinite(out["log_probs"]).all()
        same = (out["n_steps"] == ref["n_steps"]
                and np.array_equal(out["prediction"], ref["prediction"])
                and np.array_equal(out["sender_messages"],
                                   ref["sender_messages"])
                and np.array_equal(out["receiver_messages"],
                                   ref["receiver_messages"])
                and np.array_equal(out["conversation_length"],
                                   ref["conversation_length"]))
        lp_err = (float(np.abs(out["log_probs"] - ref["log_probs"]).max())
                  if same else None)
        if not same:
            # Allowed only where rounding at 0.5 set the two paths apart.
            data = torch.from_numpy(x).to(device)
            with torch.inference_mode():
                rep = compare_outputs(cfg, pred._exchange(data, pred._desc),
                                      plain._exchange(data, plain._desc))
            if not rep["ok"] or rep["tie_rows"] == 0:
                raise SystemExit(f"served batch {len(x)} differs from the "
                                 f"plain predictor: {rep}")
            ties += rep["tie_rows"]
        log({"phase": "serve", "batch": len(x), "n_steps": out["n_steps"],
             "equal_to_plain": same, "max_log_prob_err": lp_err,
             "mean_conversation_length":
                 float(out["conversation_length"].mean())})
    return {"launches": launches, "tie_rows": ties, "pred": pred}


def work(cfg, batch: int):
    """Operations and bytes one call needs at these shapes: every product
    of _kernel's eval mode, each input read once, each output written
    once."""
    from multimodalgame_tpu_torch.ops.cuda_exchange import param_shapes
    F, H, W = cfg.img_feat_dim, cfg.img_h_dim, cfg.rec_w_dim
    R, V, D, T, B = cfg.rec_hidden, cfg.wv_dim, NUM_CLASSES, cfg.max_exchange, batch
    flops = 2 * B * F * H + 2 * D * V * R + 2 * W * H
    per_turn = (2 * B * H * W                     # binary layer
                + 2 * B * (W + R) * 3 * R         # GRU
                + 2 * B * R * (1 + 2 * R)         # s, y1_h, w_h heads
                + 4 * B * D * R                   # add, relu, y2 multiply-add
                + 2 * B * D * V                   # softmax . desc
                + 2 * B * V * R                   # w_d
                + 2 * B * R * W)                  # w
    flops += T * per_turn + (T - 1) * 2 * B * W * H   # code layer, t > 0
    n_in = B * F + D * V + W + sum(int(np.prod(s))
                                   for s in param_shapes(cfg).values())
    n_out = T * B * (3 + 4 * W + D)
    nbytes = 4 * (n_in + n_out)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def event_median_ms(fn) -> float:
    import torch
    for _ in range(10):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_median_ms(fn) -> float:
    for _ in range(10):
        fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def timing(device, pred):
    import torch
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_eval_exchange_reference, kernel_params)
    cfg = pred.cfg
    params = kernel_params(pred.modules)
    rows = {}
    for batch in TIMED_BATCHES:
        x = features(batch, seed=500 + batch)
        data = torch.from_numpy(x).to(device)
        with torch.inference_mode():
            k_ms = event_median_ms(lambda: fused_eval_exchange(
                cfg, params, data, pred._desc))
            p_ms = event_median_ms(lambda: fused_eval_exchange_reference(
                cfg, params, data, pred._desc))
        e2e_ms = host_median_ms(lambda: pred.predict(x))
        row = {"phase": "timing", "batch": batch, "kernel_ms": k_ms,
               "plain_ms": p_ms, "predict_ms": e2e_ms, **work(cfg, batch)}
        log(row)
        rows[batch] = row
    # One turn instead of ten, same weights: (t10 - t1) / 9 is a turn.
    one = dataclasses.replace(cfg, max_exchange=1)
    data = torch.from_numpy(features(64, seed=564)).to(device)
    with torch.inference_mode():
        t1 = event_median_ms(lambda: fused_eval_exchange(
            one, params, data, pred._desc))
    t10 = rows[64]["kernel_ms"]
    log({"phase": "timing", "batch": 64, "kernel_ms_1_turn": t1,
         "kernel_ms_per_turn": (t10 - t1) / (cfg.max_exchange - 1)})
    return rows


def main() -> int:
    import torch
    smi = probe()
    build()
    worst = check_kernels("cuda")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as workdir:
        served = serve_requests("cuda", workdir)
    rows = timing("cuda", served["pred"])
    at = rows[64]
    log({"kernels": [{
        "name": "fused_eval_exchange",
        "route": "cuda",
        "source": "multimodalgame_tpu_torch/csrc/fused_exchange.cu",
        "replaces": "multimodalgame_tpu/ops/pallas_exchange.py:265",
        "launches": served["launches"],
        "max_abs_err": worst["max_abs_err"],
        "tie_rows": worst["tie_rows"],
        "batch": 64,
        "ms": at["kernel_ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "card": smi,
    }]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
