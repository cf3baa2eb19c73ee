"""Population sweep: train N games at once, report each member's dev
accuracy, checkpoint the winner.

The port of ``multimodalgame_tpu/sweep.py``. The reference runs one game
per process (model.py:1001-1592); here the whole population trains as
one batched step (``parallel/population.py``). CLI, the training flags
plus the sweep's own::

    python -m multimodalgame_tpu_torch.sweep -model_type Adaptive \\
        -train_file ... -dev_file ... -descr_train ... -descr_dev ... \\
        -population 16 [-lr_scales 0.5,1,2] [-max_epoch 50]

It prints one JSON line per member (index, learning-rate scale, final and
best dev top-k) and a summary line, and saves the winner's final weights
and optimizer slots as a single-game checkpoint at ``<checkpoint>_best``
in the run's ``-ckpt_format`` (JAX sweep.py:310-312: the JAX package's
msgpack file or Orbax directory, committed before the sweep returns),
which ``-eval_only``, ``serve.py`` and the JAX package read.

A population of one trains through the single-game indexed trainer with
the member's learning-rate scale folded into the learning rate; there
phase A is one launch of the train kernel where
``ops/cuda_exchange.py:train_kernel_supports`` holds, and a dev batch one
launch of the eval kernel. A larger population samples and evaluates on
the plain conversation under ``vmap``, as in the JAX package; on a CUDA
device each of its steps and each dev batch is one replay of a captured
CUDA graph (``parallel/population.py:population_route``), also on a
member-split mesh, as JAX runs one compiled program per chunk and per
dev batch.

Deviation from the JAX package: the randomness. Member ``i``'s initial
weights are ``init_params`` with seed ``random_seed + i``, and its
uniforms are Philox keyed by ``(random_seed + 1, step)`` with the member
in the counter (``ops/philox.py:member_uniforms``), where JAX splits
PRNG keys. It runs on ``cuda`` unless the caller passes ``device``.
``-images cifar`` raises: the sweep stages feature files only.

Several devices: as JAX's sweep does (sweep.py:121-145), with no flag,
the member axis is split over the largest number of the visible cards
(or of the devices in a ``device`` list, where one may repeat) that
divides N, one rank a device (``parallel/distributed.py``; each rank
holds its members, ``parallel/population.py:member_block``), and a
smaller such number than the devices is logged. The members are
independent: the ranks meet only to gather each dev sweep's accuracies
and the timings; the rank that holds the winner writes its ``_best``,
and rank 0 prints the lines. ``-num_processes`` (a multi-host training
job) is not a sweep flag and raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.config import Flags
from multimodalgame_tpu_torch.data.descriptions import load_descriptions
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.driver import (decompose_chunks,
                                                  device_pool)
from multimodalgame_tpu_torch.game.exchange import description_inputs
from multimodalgame_tpu_torch.game.fast_eval import batch_statistics
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_eval_exchange, make_multistep_train_step_indexed)
from multimodalgame_tpu_torch.ops.cuda_exchange import train_kernel_supports
from multimodalgame_tpu_torch.ops.philox import (member_uniforms,
                                                 philox_eval_uniforms)
from multimodalgame_tpu_torch.parallel.distributed import host_view
from multimodalgame_tpu_torch.parallel.population import (
    init_population, init_population_opt_states, make_population_eval,
    make_population_train_step, member_block, member_modules,
    member_opt_states)
from multimodalgame_tpu_torch.utils.checkpoint import (save_checkpoint,
                                                       wait_for_checkpoints)
from multimodalgame_tpu_torch.utils.logging import FileLogger


def parse_lr_scales(spec: Optional[str], n: int) -> Optional[np.ndarray]:
    """``"0.5,1,2"`` -> ``(n,)`` multipliers, cycled over the members."""
    if not spec:
        return None
    vals = [float(v) for v in spec.split(",") if v.strip()]
    return np.asarray([vals[i % len(vals)] for i in range(n)], np.float32)


def run_sweep(flags: Flags, max_steps: Optional[int] = None,
              eval_every: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None,
              inputs=None) -> dict:
    """Train the population; returns the summary dict (per-member dev
    accuracies, the winner, timings). ``inputs`` (``(desc_train,
    desc_dev, train_ds, dev_ds)``) replaces the file reads with sets held
    in memory, as ``train.run``'s does. ``device`` is a device, or a list
    of devices to split the members over (see the module's notes)."""
    if flags.images == "cifar":
        raise NotImplementedError(
            "-images cifar on the sweep is not ported yet (ROADMAP "
            "§1.10.4): the population trains on feature files")
    if int(flags.population) < 1:
        raise ValueError(f"-population must be at least 1, got "
                         f"{flags.population}")
    if int(flags.num_processes or 1) > 1:
        raise ValueError("the sweep splits its members over this host's "
                         "devices; -num_processes is a flag of a "
                         "multi-host training job")
    if int(flags.mesh_model or 0) > 1:
        # JAX's sweep ignores the flag; here it is refused, not dropped.
        raise ValueError("the sweep splits its members over its devices "
                         "only; -mesh_model (tensor parallelism) is a flag "
                         "of the training driver")
    if flags.log_file:
        os.makedirs(os.path.dirname(flags.log_file) or ".", exist_ok=True)
    n = int(flags.population)
    devices = device_pool(device, 1)
    # The largest number of devices that divides the members (JAX
    # sweep.py:124-134).
    n_dev = next((d for d in range(len(devices), 1, -1) if n % d == 0), 1)
    if n > 1 and n_dev < len(devices):
        FileLogger(flags.log_file).Log(
            "Population {} not divisible by {} devices; sharding over a "
            "{}-device mesh instead".format(n, len(devices), n_dev))
    if n_dev == 1:
        return _sweep(flags, max_steps, eval_every, devices[0], inputs)
    from multimodalgame_tpu_torch.parallel.distributed import launch
    if inputs is not None:
        inputs = tuple(x.to("cpu") if isinstance(x, DeviceDataset) else x
                       for x in inputs)
    ranks = launch(_sweep_rank, devices[:n_dev],
                   (flags, max_steps, eval_every, inputs))
    return dict(ranks[0], ranks=ranks)


def _sweep_rank(mesh, flags: Flags, max_steps, eval_every, inputs) -> dict:
    """One rank of a sweep whose members are split over ``mesh``."""
    from multimodalgame_tpu_torch.parallel.distributed import rank_path
    flags.log_file = rank_path(flags.log_file, mesh)
    if inputs is not None:
        inputs = tuple(x.to(mesh.device) if isinstance(x, DeviceDataset)
                       else x for x in inputs)
    out = _sweep(flags, max_steps, eval_every, mesh.device, inputs, mesh)
    out["collectives"] = {"seconds": mesh.seconds, "calls": mesh.calls}
    out["rank"] = mesh.rank
    return out


def _sweep(flags: Flags, max_steps: Optional[int],
           eval_every: Optional[int], device: torch.device, inputs,
           mesh=None) -> dict:
    """:func:`run_sweep` on one device, or as one rank of ``mesh``
    holding its block of the members."""
    flogger = FileLogger(flags.log_file)
    n = int(flags.population)
    lo, hi = member_block(n, mesh)
    single = n == 1
    cfg = GameConfig.from_flags(flags)
    lr_scale = parse_lr_scales(flags.lr_scales, n)
    if single and lr_scale is not None and float(lr_scale[0]) != 1.0:
        # The learning rate is a final linear scale of every rule's
        # updates, so folding the member's scale into it is the
        # population trainer's per-member scaling.
        cfg = dataclasses.replace(
            cfg, learning_rate=cfg.learning_rate * float(lr_scale[0]))

    ctx_key = flags.data_context if flags.attn_extra_context else None
    if inputs is None:
        desc_train, desc_dev = (
            load_descriptions(path, flags.wv_type, flags.wv_dim,
                              glove_path=flags.glove_path)
            for path in (flags.descr_train, flags.descr_dev))
        train_ds = DeviceDataset.from_hdf5(
            flags.train_file, flags.img_feat,
            map_labels=desc_train.map_labels, context_key=ctx_key,
            device=device)
        dev_ds = DeviceDataset.from_hdf5(
            flags.dev_file, flags.img_feat, map_labels=desc_dev.map_labels,
            context_key=ctx_key, device=device)
    else:
        desc_train, desc_dev, train_ds, dev_ds = inputs
    descs = description_inputs(desc_train, cfg, device)
    desc = descs.pop("desc")
    dev_descs = description_inputs(desc_dev, cfg, device)
    desc_dev_t = dev_descs.pop("desc")
    seed = flags.random_seed + 1

    if single:
        modules = init_params(AgentModules(cfg), seed=flags.random_seed,
                              device=device)
        state = {"opts": init_opt_states(cfg, modules)}
        chunk = make_multistep_train_step_indexed(
            modules, flags.top_k_train, flags.batch_size,
            fast=("kernel" if train_kernel_supports(
                cfg, flags.batch_size, desc.shape[0]) else "auto"),
            seed=seed, device=device)
        eval_exchange = make_eval_exchange(modules)
    else:
        modules = AgentModules(cfg).to(device)
        pop = init_population(cfg, flags.random_seed, hi - lo, device,
                              first=lo)
        state = {"pop": pop, "opts": init_population_opt_states(cfg, pop)}
        chunk = make_population_train_step(modules, flags.top_k_train,
                                           flags.batch_size, seed=seed,
                                           member_base=lo)
        batch_eval = make_population_eval(modules, flags.top_k_dev)
        if lr_scale is not None:
            lr_scale = lr_scale[lo:hi]

    def dev_accuracy(step: int) -> np.ndarray:
        """Each member's dev top-k over the dev set, one copy at the end
        (on the mesh, after the ranks' members are gathered); under
        ``-flipout_dev`` batch ``i`` draws from eval slot ``1 + i`` of
        ``(seed, step)``, a population's draws keyed by a device
        counter."""
        if dev_ds.size == 0:
            raise ValueError("dev set is empty — nothing to evaluate")
        idx = dev_ds.epoch_indices(0, False, flags.batch_size_dev,
                                   truncate_final_batch=True)
        correct = torch.zeros((hi - lo,), dtype=torch.int64, device=device)
        key = None if single else torch.tensor([seed, step],
                                               dtype=torch.int64,
                                               device=device)
        total = 0
        with torch.no_grad():
            for i, row in enumerate(idx):
                row = torch.as_tensor(row[row >= 0], device=device)
                data, target = dev_ds.feats[row], dev_ds.targets[row]
                ctx = (None if dev_ds.context is None
                       else dev_ds.context[row])
                if single:
                    ex = eval_exchange(
                        data, desc_dev_t, data_context=ctx,
                        uniforms=philox_eval_uniforms(
                            cfg, len(row), seed, step, 1 + i, device),
                        **dev_descs)
                    correct += batch_statistics(cfg, ex, target,
                                                flags.top_k_dev)["hits"]
                else:
                    correct += batch_eval(
                        state["pop"], data, target, desc_dev_t,
                        uniforms=member_uniforms(cfg, len(row), key[0],
                                                 key[1], hi - lo, device,
                                                 slot=1 + i, member_base=lo),
                        data_context=ctx, **dev_descs)
                total += len(row)
        got = host_view(correct, mesh, sharded=True)
        return got / float(total)

    flogger.Log("Population sweep: {} members, {} steps/epoch, flags: {}"
                .format(n, train_ds.size // flags.batch_size,
                        json.dumps({"population": n,
                                    "lr_scales": flags.lr_scales,
                                    "model_type": flags.model_type})))

    best = np.zeros((n,), np.float64)
    step = 0
    epoch = 0
    t0 = time.perf_counter()
    eval_cadence = eval_every or flags.log_dev
    # Chunks span epoch ends: the epochs' plans are buffered and consumed
    # in order, and a chunk ends only at the dev cadence.
    plan_buf = np.zeros((0, flags.batch_size), dtype=np.int64)

    def refill(buf, needed):
        nonlocal epoch
        while buf.shape[0] < needed and epoch < flags.max_epoch:
            nxt = train_ds.epoch_indices(epoch, flags.shuffle_train,
                                         flags.batch_size)
            if nxt.shape[0] == 0:
                break           # a set smaller than one batch
            buf = np.concatenate([buf, nxt], axis=0)
            epoch += 1
        return buf

    accs = None   # the last dev sweep, while the weights are unchanged
    while True:
        k = eval_cadence - (step % eval_cadence)
        if max_steps is not None:
            k = min(k, max_steps - step)
        plan_buf = refill(plan_buf, k)
        k = min(k, plan_buf.shape[0])
        if k <= 0:
            break       # max_steps reached or epochs exhausted
        for size in decompose_chunks(k):
            rows, plan_buf = plan_buf[:size], plan_buf[size:]
            if single:
                chunk(state["opts"], train_ds.feats, train_ds.targets, rows,
                      desc, step, feats_context=train_ds.context, **descs)
            else:
                state["pop"], state["opts"], _ = chunk(
                    state["pop"], state["opts"], train_ds.feats,
                    train_ds.targets, rows, desc, step, lr_scale=lr_scale,
                    feats_context=train_ds.context, **descs)
            step += size
        accs = None
        if step % eval_cadence == 0 or (max_steps is not None
                                        and step >= max_steps):
            accs = dev_accuracy(step)
            best = np.maximum(best, accs)
            flogger.Log("Step: {} per-member dev acc: {}".format(
                step, np.array2string(accs, precision=3)))
        if max_steps is not None and step >= max_steps:
            break

    # The final sweep, unless training ended on a dev step (the weights
    # have not moved since).
    if accs is None:
        accs = dev_accuracy(step)
        best = np.maximum(best, accs)
    elapsed = time.perf_counter() - t0
    if mesh is not None:
        # The slowest rank's time is the sweep's.
        elapsed = float(host_view(torch.tensor(
            [elapsed], dtype=torch.float64, device=device), mesh,
            sharded=True).max())
    scales = parse_lr_scales(flags.lr_scales, n)
    printer = mesh is None or mesh.writer

    members = []
    for i in range(n):
        members.append({
            "member": i,
            "lr_scale": float(scales[i]) if scales is not None else 1.0,
            "final_dev_acc": float(accs[i]),
            "best_dev_acc": float(best[i]),
        })
        if printer:
            print(json.dumps(members[-1]))
    # The winner has the best dev accuracy over training (the driver's
    # best-checkpoint rule, model.py:1569-1576); its checkpoint holds its
    # final weights and live optimizer slots, and records both accuracies.
    # On the mesh the rank that holds it writes it.
    winner = int(np.argmax(best))
    if single:
        win_mods, win_opts = modules, state["opts"]
    elif lo <= winner < hi:
        win_mods = member_modules(cfg, state["pop"], winner - lo)
        win_opts = member_opt_states(state["opts"], winner - lo)
    if lo <= winner < hi:
        save_checkpoint(flags.checkpoint + "_best",
                        dict(step=step, best_dev_acc=float(best[winner]),
                             final_dev_acc=float(accs[winner])),
                        win_mods, win_opts, fmt=flags.ckpt_format)
    wait_for_checkpoints()   # the winner's Orbax save commits before any
    if mesh is not None:     # rank returns (JAX sweep.py:328)
        mesh.barrier()

    summary = {
        "population": n,
        "steps": step,
        "winner": winner,
        "winner_best_dev_acc": float(best[winner]),
        "winner_final_dev_acc": float(accs[winner]),
        "wall_seconds": round(elapsed, 3),
        "steps_per_sec_total": round(step * n / elapsed, 1),
        "checkpoint": flags.checkpoint + "_best",
    }
    if printer:
        print(json.dumps(summary))
    flogger.Log("Sweep summary: " + json.dumps(summary))
    summary["members"] = members
    return summary


def main(argv=None, device=None, inputs=None) -> dict:
    from multimodalgame_tpu_torch.config import flags_from_argv
    flags = flags_from_argv(sys.argv[1:] if argv is None else argv)
    return run_sweep(flags, device=device, inputs=inputs)


if __name__ == "__main__":
    main()
