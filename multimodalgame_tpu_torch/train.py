"""Training driver: the reference's ``run()`` (model.py:1001-1592).

The port of ``multimodalgame_tpu/train.py``. Flow: flag dump -> the four
agents (with their parameter counts) -> descriptions -> optimizer states
-> resume from the checkpoint when it exists -> ``-eval_only`` /
``-binary_only`` -> training, by the chunked driver (``game/driver.py``)
or, with ``-nofast_driver``, the per-batch loop over the HDF5 file below.
Both print their interval logs through :func:`emit_log_window`.

``run`` trains on ``cuda`` unless the caller passes ``device="cpu"``.
Every preset runs, the attention ones (``layer4_2`` maps with the ``fc``
context) included, and so do ``-desc_attn``, ``-sender_mix mou``,
``-flipout_dev``, ``-compute_dtype bfloat16`` (the conversation in
bfloat16, parameters, optimizers and losses in float32) and ``-images
cifar`` (the CIFAR-10 test split's pixels as features; PIL reads and
resizes them, or the caller stages them through ``inputs``).

Checkpoints (``utils/checkpoint.py``) are the JAX package's msgpack files
or, with ``-ckpt_format orbax``, its Orbax directories, written on a
background thread and committed before ``run`` returns. A resume first
repairs a crash-interrupted Orbax swap at ``-checkpoint`` and its
``_best``, then reads what is at ``-checkpoint`` whatever its format and
adopts that format, as JAX's driver does (train.py:282-316): a directory
is written as Orbax, a msgpack file as msgpack, and a reference ``.pt``
left by an earlier port run keeps being written as a ``.pt``.

``-mesh N`` trains (or, with ``-eval_only``, evaluates) data-parallel,
one process a device (``parallel/distributed.py``), and ``-mesh N
-mesh_model M`` on a ``(N / M data, M model)`` grid of those processes,
the sender's and baselines' widest layers and the class head sharded over
the model axis (``parallel/tensor.py``; an ``-eval_only`` run evaluates
the whole weights on every rank, its data shard's rows): alone, ``run``
spawns N ranks on the visible cards (``device`` a list names them, a
device may repeat; ``cpu`` gives N CPU ranks) and returns rank 0's
summary; with ``-num_processes P -coordinator host:port -process_id i``
each host's ``run`` joins the job with its N / P ranks. The flags are
checked before any process starts, as JAX checks them before joining
(train.py:186-202). ``-binary_only`` extraction and ``-nofast_driver``
run on one device and refuse ``-mesh``, as JAX's do.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.config import Flags
from multimodalgame_tpu_torch.data.descriptions import (DescriptionPack,
                                                        load_descriptions)
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.driver import (SAMPLER_LINE, STEP_LINE,
                                                  mesh_banner, resolve_mesh)
from multimodalgame_tpu_torch.game.train import (init_opt_states,
                                                 make_eval_exchange)
from multimodalgame_tpu_torch.utils.checkpoint import (
    checkpoint_format, load_checkpoint, recover_orbax, save_checkpoint,
    wait_for_checkpoints)
from multimodalgame_tpu_torch.utils.device import resolve_device
from multimodalgame_tpu_torch.utils.logging import FileLogger, VisdomLogger
from multimodalgame_tpu_torch.utils.profiling import StepTimer
from multimodalgame_tpu_torch.utils.sparks import bin_to_alpha, sparks

# (desc_train, desc_dev, train_ds, dev_ds) held in memory.
Inputs = Tuple[DescriptionPack, DescriptionPack, DeviceDataset,
               DeviceDataset]


def format_exchange_log(tag: str, sen_probs, sen_feats, rec_probs, rec_feats,
                        s_probs, s_masks_post, n_steps: int,
                        num_samples: int, use_alpha: bool) -> str:
    """Render sampled conversations as sparkline dumps
    (reference model.py:1411-1518).

    ``s_masks_post`` is the per-step post-step mask array ``(T, B, 1)``
    (the reference's ``s_masks[1:]``).
    """
    log = tag
    for i_sample in range(num_samples):
        prev_sen = np.zeros(sen_feats.shape[-1])
        prev_rec = np.zeros(rec_feats.shape[-1])
        for i_exchange in range(n_steps):
            sen_probs_i = list(np.asarray(sen_probs[i_exchange][i_sample],
                                          dtype=float))
            sen_spark = sparks([1] + sen_probs_i)[1:]
            rec_probs_i = list(np.asarray(rec_probs[i_exchange][i_sample],
                                          dtype=float))
            rec_spark = sparks([1] + rec_probs_i)[1:]
            s_probs_i = list(np.asarray(s_probs[i_exchange][i_sample],
                                        dtype=float))
            s_spark = sparks([1] + s_probs_i)[1:]

            sen_binary = np.asarray(sen_feats[i_exchange][i_sample])
            sen_hamming = float(np.abs(prev_sen - sen_binary).sum())
            prev_sen = sen_binary
            rec_binary = np.asarray(rec_feats[i_exchange][i_sample])
            rec_hamming = float(np.abs(prev_rec - rec_binary).sum())
            prev_rec = rec_binary

            sen_msg = "".join(str(int(b)) for b in sen_binary)
            rec_msg = "".join(str(int(b)) for b in rec_binary)
            if use_alpha:
                sen_msg = bin_to_alpha(sen_msg)
                rec_msg = bin_to_alpha(rec_msg)
            if i_exchange == 0:
                log += "\n{:>3}".format(i_sample)
            else:
                log += "\n   "
            log += "        {}".format(sen_spark)
            log += "           {}    {}".format(s_spark, rec_spark)
            log += "\n    {:>3} S: {} {:4}".format(
                i_exchange, sen_msg, sen_hamming)
            log += "    s={} R: {} {:4}".format(
                int(s_masks_post[i_exchange][i_sample][0]), rec_msg,
                rec_hamming)
    log += "\n"
    return log


def emit_log_window(flags: Flags, flogger, logger, epoch: int, step: int,
                    i_batch: int, avg_batch_acc: float, host: dict) -> None:
    """Emit one interval-log block (reference model.py:1341-1542), the one
    formatter behind both training loops.

    ``host`` holds host-side values: ``loss_sen``, ``nll_loss``,
    ``loss_binary_rec``, ``loss_binary_s``, ``loss_bas_sen``,
    ``loss_bas_rec``, ``target``, ``argmax``, ``n_steps``,
    ``ent_binary_sen``, ``ent_binary_rec``, ``ent_y_rec`` and, when
    ``exchange_samples > 0``, the ``train_*`` / ``eval_*`` conversation
    dump arrays (probs/feats/stop arrays + ``eval_n_steps``), as
    ``game/logpack.py:LogPacker.unpack`` gives them.
    """
    prefix = "Epoch: {} Step: {} Batch: {} ".format(epoch, step, i_batch)
    flogger.Log(prefix + "Training Accuracy: {}".format(avg_batch_acc))
    flogger.Log(prefix + "Loss Sender: {}".format(
        float(host["loss_sen"])))
    flogger.Log(prefix + "Loss Receiver (Y): {}".format(
        float(host["nll_loss"])))
    if flags.use_binary:
        flogger.Log(prefix + "Loss Receiver (Z): {}".format(
            float(host["loss_binary_rec"])))
        if not flags.fixed_exchange:
            flogger.Log(prefix + "Loss Receiver (S): {}".format(
                float(host["loss_binary_s"])))
        flogger.Log(prefix + "Loss Baseline (S): {}".format(
            float(host["loss_bas_sen"])))
        flogger.Log(prefix + "Loss Baseline (R): {}".format(
            float(host["loss_bas_rec"])))

    flogger.Log("Predictions: {}".format(
        np.stack([np.asarray(host["target"]),
                  np.asarray(host["argmax"]).astype(np.int64)], 0)))

    n_train = int(host["n_steps"])
    if flags.use_binary:
        ent_sen = np.asarray(host["ent_binary_sen"])[:n_train]
        if len(ent_sen) > 0:
            log_ent = "Entropy Sender Binary"
            for i, ent in enumerate(ent_sen):
                log_ent += "\n{}. {}".format(i, -float(ent))
            flogger.Log(log_ent + "\n")
        ent_rec = np.asarray(host["ent_binary_rec"])[:max(n_train - 1, 0)]
        if len(ent_rec) > 0:
            log_ent = "Entropy Receiver Binary"
            for i, ent in enumerate(ent_rec):
                log_ent += "\n{}. {}".format(i, -float(ent))
            flogger.Log(log_ent + "\n")
    ent_y = np.asarray(host["ent_y_rec"])[:n_train]
    if len(ent_y) > 0:
        log_ent = "Entropy Receiver Predictions"
        for i, ent in enumerate(ent_y):
            log_ent += "\n{}. {}".format(i, -float(ent))
        flogger.Log(log_ent + "\n")

    # Sampled and inferred conversation dumps (model.py:1411-1518).
    if flags.exchange_samples > 0:
        flogger.Log(format_exchange_log(
            "Train:", host["train_sen_probs"], host["train_sen_feats"],
            host["train_rec_probs"], host["train_rec_feats"],
            host["train_stop_probs"], host["train_stop_masks_post"],
            n_train, flags.exchange_samples, flags.use_alpha))
        flogger.Log(format_exchange_log(
            "Eval:", host["eval_sen_probs"], host["eval_sen_feats"],
            host["eval_rec_probs"], host["eval_rec_feats"],
            host["eval_stop_probs"], host["eval_stop_masks_post"],
            int(host["eval_n_steps"]), flags.exchange_samples,
            flags.use_alpha))

    logger.log(key="Loss Sender", val=float(host["loss_sen"]), step=step)
    logger.log(key="Loss Receiver (Y)", val=float(host["nll_loss"]),
               step=step)
    if flags.use_binary:
        logger.log(key="Loss Receiver (Z)",
                   val=float(host["loss_binary_rec"]), step=step)
        if not flags.fixed_exchange:
            logger.log(key="Loss Receiver (S)",
                       val=float(host["loss_binary_s"]), step=step)
        logger.log(key="Loss Baseline (S)",
                   val=float(host["loss_bas_sen"]), step=step)
        logger.log(key="Loss Baseline (R)",
                   val=float(host["loss_bas_rec"]), step=step)
    logger.log(key="Training Accuracy", val=avg_batch_acc, step=step)


def job_devices(flags: Flags, device=None) -> Optional[list]:
    """This host's rank devices for ``-mesh`` and ``-num_processes``, or
    ``None`` for a single-device run. Raises ``ValueError`` for a
    multi-host job without ``-coordinator`` or ``-mesh`` (before any
    process tries to join it, so a bad flag fails instead of hanging;
    JAX train.py:192-202), for ``-mesh`` outside the chunked driver and
    the device ``-eval_only`` sweep (JAX train.py:249-258), for a batch
    size the mesh does not divide and for too few devices."""
    if int(flags.num_processes or 1) > 1:
        if not flags.coordinator:
            raise ValueError(
                "-num_processes > 1 requires -coordinator host:port")
        if int(flags.mesh or 0) in (0, 1):
            raise ValueError(
                "-num_processes > 1 requires -mesh (e.g. -mesh -1 for "
                "every device in the job)")
    wants_mesh = (int(flags.mesh or 0) not in (0, 1)
                  or int(flags.mesh_model or 0) > 1)
    if wants_mesh and (not flags.fast_driver or flags.binary_only):
        raise ValueError(
            "-mesh/-mesh_model parallelism is implemented for the chunked "
            "training driver (-fast_driver) and the device-sweep "
            "-eval_only path; drop -mesh or use the fast driver")
    # An eval-only run shards only the dev batches (JAX train.py:368).
    fields = (("batch_size_dev",) if flags.eval_only
              else ("batch_size", "batch_size_dev"))
    return resolve_mesh(flags, fields, device)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def run(flags: Flags, max_steps: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
        inputs: Optional[Inputs] = None,
        uniforms: Optional[Callable] = None) -> dict:
    """Train (or evaluate or extract, per flags); returns a summary dict.

    ``inputs`` replaces the description and feature file reads with sets
    held in memory (the staged paths only: the fast driver and the
    device dev sweep); under ``-images cifar`` its training set is the
    uint8 pixel set (a ``DeviceDataset`` of uint8 pixels, as
    ``DeviceDataset.from_cifar`` stages it).
    ``uniforms`` (``step -> {s, z, w[, fz, fw]}``) replaces the Philox
    stream of the training steps.

    With ``-mesh`` (see the module's notes) ``device`` may be a list of
    the ranks' devices; ``inputs`` and ``uniforms`` go to every rank (the
    sets as CPU copies, ``uniforms`` pickled, giving the whole batch's
    numbers). The summary is rank 0's, its modules and tensors on the
    CPU, with every rank's summary under ``ranks``: each with its
    ``launches`` of both kernels and its ``collectives`` (seconds and
    calls, the gradient all-reduces apart; under ``-mesh_model`` the data
    axis's, and the model axis's under ``model``) and, on a card, its
    ``peak_memory_bytes``."""
    if inputs is not None and (flags.binary_only or not flags.fast_driver):
        raise ValueError("in-memory inputs serve the staged paths only; "
                         "-binary_only and -nofast_driver read the files")
    devices = job_devices(flags, device)
    if devices is None:
        return _run(flags, max_steps, resolve_device(device), inputs,
                    uniforms)
    from multimodalgame_tpu_torch.parallel.distributed import launch
    if inputs is not None:
        inputs = tuple(x.to("cpu") if isinstance(x, DeviceDataset) else x
                       for x in inputs)
    multi = int(flags.num_processes or 1) > 1
    ranks = launch(_run_rank, devices, (flags, max_steps, inputs, uniforms),
                   coordinator=flags.coordinator if multi else None,
                   num_processes=int(flags.num_processes or 1),
                   process_id=int(flags.process_id or 0))
    return dict(ranks[0], ranks=ranks)


def _run_rank(mesh, flags: Flags, max_steps, inputs, uniforms) -> dict:
    """One rank of a ``-mesh`` run: its log paths, its copy of the
    in-memory sets on its device, the run, and its counters."""
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.parallel.distributed import rank_path
    # Rank 0 owns the shared files; the others keep their host logs
    # apart (JAX train.py:212-215).
    for attr in ("log_file", "json_file", "eval_csv_file", "conf_mat"):
        setattr(flags, attr, rank_path(getattr(flags, attr), mesh))
    if inputs is not None:
        inputs = tuple(x.to(mesh.device) if isinstance(x, DeviceDataset)
                       else x for x in inputs)
    if int(flags.mesh_model or 0) > 1:
        from multimodalgame_tpu_torch.parallel.tensor import make_mesh_2d
        mesh = make_mesh_2d(mesh, int(flags.mesh_model))
    out = _run(flags, max_steps, mesh.device, inputs, uniforms, mesh)
    out["launches"] = {"train": fused_train_forward.launches,
                       "eval": fused_eval_exchange.launches}
    out["collectives"] = _counters(mesh)
    if mesh.model is not None:
        out["collectives"]["model"] = _counters(mesh.model)
    out["rank"] = mesh.global_rank
    if mesh.device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
            mesh.device)
    return out


def _counters(mesh) -> dict:
    return {"seconds": mesh.seconds, "calls": mesh.calls,
            "grad_seconds": mesh.grad_seconds, "grad_calls": mesh.grad_calls}


def _run(flags: Flags, max_steps: Optional[int], device: torch.device,
         inputs: Optional[Inputs], uniforms: Optional[Callable],
         mesh=None) -> dict:
    """:func:`run` on one device, or as one rank of ``mesh``."""
    # The first Log() appends to flags.log_file: create its directory.
    if flags.log_file:
        os.makedirs(os.path.dirname(flags.log_file) or ".", exist_ok=True)
    flogger = FileLogger(flags.log_file)
    logger = VisdomLogger(env=flags.env,
                          experiment_name=flags.experiment_name,
                          enabled=flags.visdom)

    # Debug mode: the reference arms numpy fp exceptions
    # (model.py:1806-1807, config.py); autograd's anomaly mode is the
    # device-side analog.
    if flags.debug:
        torch.autograd.set_detect_anomaly(True)

    flogger.Log("Flag Values:\n" +
                json.dumps(flags.flag_values_dict(), indent=4,
                           sort_keys=True))
    if not os.path.exists(flags.json_file):
        os.makedirs(os.path.dirname(flags.json_file) or ".", exist_ok=True)
        with open(flags.json_file, "w") as f:
            f.write(json.dumps(flags.flag_values_dict(), indent=4,
                               sort_keys=True))

    cfg = GameConfig.from_flags(flags)
    modules = AgentModules(cfg)

    # Descriptions (model.py:1066-1108).
    if flags.wv_type == "none":
        raise NotImplementedError("wv_type=none has no prediction targets")
    train_ds = dev_ds = None
    if inputs is None:
        desc_train, desc_dev = (
            load_descriptions(path, flags.wv_type, flags.wv_dim,
                              glove_path=flags.glove_path)
            for path in (flags.descr_train, flags.descr_dev))
    else:
        desc_train, desc_dev, train_ds, dev_ds = inputs

    init_params(modules, seed=flags.random_seed, device=device)
    # Architecture and parameter counts in the reference's order
    # (model.py:1025-1064).
    for name in ("sender", "baseline_sen", "receiver", "baseline_rec"):
        flogger.Log("Architecture: {}".format(getattr(modules, name)))
        flogger.Log("Total Parameters: {}".format(
            param_count(getattr(modules, name))))

    opt_states = init_opt_states(cfg, modules)

    epoch = 0
    step = 0
    best_dev_acc = 0.0
    # Finish a crash-interrupted Orbax swap before the resume decision:
    # the mid-swap window leaves nothing at the path (JAX
    # train.py:282-288). One rank repairs; the others wait for it.
    if mesh is None or mesh.writer:
        recover_orbax(flags.checkpoint)
        recover_orbax(flags.checkpoint + "_best")
    if mesh is not None:
        mesh.barrier()
        if mesh.model is not None:
            mesh.model.barrier()
    if os.path.exists(flags.checkpoint):
        # The artifact at the path decides the format this run writes
        # (JAX train.py:304-316).
        found = checkpoint_format(flags.checkpoint)
        if found == "pt":
            flags.ckpt_format = "pt"
            flogger.Log("Checkpoint is a reference .pt file; writing .pt "
                        "checkpoints for this run")
        elif found != flags.ckpt_format:
            flags.ckpt_format = found
            flogger.Log("Checkpoint is {}; using -ckpt_format {} for this "
                        "run".format("an orbax directory" if found ==
                                     "orbax" else "a msgpack file", found))
        flogger.Log("Loading from: " + flags.checkpoint)
        data = load_checkpoint(flags.checkpoint, modules, opt_states)
        step = int(data["step"])
        best_dev_acc = float(data["best_dev_acc"])
        flogger.Log("Loaded at step: {} and best dev acc: {}".format(
            step, best_dev_acc))

    eval_exchange = make_eval_exchange(modules, use_kernel=True)

    # Alternatives to training (model.py:1165-1187).
    if flags.eval_only:
        if not os.path.exists(flags.checkpoint):
            raise Exception("Must provide valid checkpoint.")
        if flags.fast_driver:
            from multimodalgame_tpu_torch.game.fast_eval import (
                run_device_dev_eval)
            if dev_ds is None:
                dev_ds = DeviceDataset.from_hdf5(
                    flags.dev_file, flags.img_feat,
                    map_labels=desc_dev.map_labels,
                    context_key=(flags.data_context
                                 if flags.attn_extra_context else None),
                    device=device)
            if mesh is not None:
                flogger.Log(mesh_banner(mesh, device))
            # Keyed by the checkpoint's step, the -flipout_dev draws are
            # those of the dev sweep that wrote it.
            dev_acc, extra = run_device_dev_eval(
                flags, modules, eval_exchange, desc_dev, dev_ds, epoch,
                step=step, mesh=mesh)
        else:
            from multimodalgame_tpu_torch.eval import eval_dev
            dev_acc, extra = eval_dev(
                flags, modules, eval_exchange, flags.dev_file,
                flags.batch_size_dev, epoch, flags.shuffle_dev,
                flags.top_k_dev, desc_dev, step=step)
        flogger.Log("Dev Accuracy: " + str(dev_acc))
        with open(flags.eval_csv_file, "w") as f:
            f.write("checkpoint,eval_file,topk,step,best_dev_acc,eval_acc,"
                    "convlen_mean,convlen_std\n")
            f.write("{},{},{},{},{},{},{},{}\n".format(
                flags.checkpoint, flags.dev_file, flags.top_k_dev,
                step, best_dev_acc, dev_acc,
                extra["conversation_lengths_mean"],
                extra["conversation_lengths_std"]))
        return dict(dev_acc=dev_acc, extra=extra)
    elif flags.binary_only:
        if not os.path.exists(flags.checkpoint):
            raise Exception("Must provide valid checkpoint.")
        from multimodalgame_tpu_torch.extract import extract_binary
        path = extract_binary(flags, modules, eval_exchange, flags.dev_file,
                              flags.batch_size_dev, epoch, flags.shuffle_dev,
                              desc_dev, step=step)
        return dict(binary_output=path)

    if flags.fast_driver:
        from multimodalgame_tpu_torch.game.driver import run_fast
        tp = None
        if mesh is not None and mesh.model is not None:
            # The sender's and baselines' Megatron leaves and the class
            # head sharded over the model axis, each rank's block taken
            # from the whole (resumed) state (JAX driver.py:239-254).
            from multimodalgame_tpu_torch.parallel.tensor import (
                TensorParallel, place_opt_states_tp)
            tp = TensorParallel(mesh, modules, class_sharded=True,
                                num_classes=len(desc_train.desc))
            opt_states = place_opt_states_tp(opt_states, tp)
        summary = run_fast(flags, modules, opt_states, desc_train, desc_dev,
                           flogger, logger, eval_exchange, step=step,
                           best_dev_acc=best_dev_acc, max_steps=max_steps,
                           train_ds=train_ds, dev_ds=dev_ds,
                           uniforms=uniforms, mesh=mesh, tp=tp)
        flogger.Log("Finished training.")
        return summary
    return _run_per_batch(flags, modules, opt_states, desc_train, desc_dev,
                          flogger, logger, eval_exchange, step,
                          best_dev_acc, max_steps, uniforms)


def _run_per_batch(flags, modules, opt_states, desc_train, desc_dev,
                   flogger, logger, eval_exchange, step, best_dev_acc,
                   max_steps, uniforms) -> dict:
    """The per-batch loop of ``-nofast_driver`` (reference
    model.py:1190-1592): batches read from the HDF5 file (or, under
    ``-images cifar``, streamed from the CIFAR pickle in the working
    directory, ``data/cifar.py:load_cifar``), one training step each, the
    dev evaluation on the host (``eval.py``)."""
    from multimodalgame_tpu_torch.data.hdf5_loader import load_hdf5
    from multimodalgame_tpu_torch.eval import context_of, eval_dev
    from multimodalgame_tpu_torch.game.exchange import description_inputs
    from multimodalgame_tpu_torch.game.logpack import LogPacker
    from multimodalgame_tpu_torch.game.train import (make_train_step,
                                                     step_route)
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        train_kernel_supports)
    from multimodalgame_tpu_torch.ops.philox import (EVAL_DUMP_SLOT,
                                                     philox_eval_uniforms)

    cfg = modules.cfg
    device = next(modules.parameters()).device
    seed = flags.random_seed + 1
    descs = description_inputs(desc_train, cfg, device)
    desc = descs.pop("desc")
    sampler = ("kernel" if train_kernel_supports(cfg, flags.batch_size,
                                                 desc.shape[0]) else "plain")
    flogger.Log(SAMPLER_LINE.format(sampler))
    flogger.Log(STEP_LINE.format(step_route(device)))
    train_step = make_train_step(
        modules, flags.top_k_train, flags.batch_size,
        fast="kernel" if sampler == "kernel" else "auto",
        seed=seed, uniforms=uniforms, device=device)
    packer = LogPacker(cfg, flags.batch_size, flags.exchange_samples)

    epoch = 0
    batch_accuracy = []   # device scalars, then host floats once copied
    dev_accuracy = []
    done = False
    timer = StepTimer()
    steps_in_span = 0
    n_acc_host = 0        # prefix of batch_accuracy already on the host

    def flush_accuracy(extra: Optional[torch.Tensor] = None):
        """One copy of the pending accuracy scalars and of ``extra``."""
        nonlocal n_acc_host
        parts = [a.reshape(1).float() for a in batch_accuracy[n_acc_host:]]
        if extra is not None:
            parts.append(extra)
        if not parts:
            return None
        host = torch.cat(parts).cpu().numpy()
        n = len(batch_accuracy) - n_acc_host
        batch_accuracy[n_acc_host:] = host[:n].astype(np.float64).tolist()
        n_acc_host = len(batch_accuracy)
        return host[n:] if extra is not None else None

    while epoch < flags.max_epoch and not done:
        flogger.Log("Starting epoch: {}".format(epoch))
        if flags.images == "cifar":
            from multimodalgame_tpu_torch.data.cifar import load_cifar
            from multimodalgame_tpu_torch.game import driver
            batches = load_cifar(flags.batch_size, epoch,
                                 image_size=driver.CIFAR_IMAGE_SIZE)
        else:
            batches = load_hdf5(flags.train_file, flags.batch_size, epoch,
                                flags.shuffle_train,
                                map_labels=desc_train.map_labels)
        for i_batch, batch in enumerate(batches):
            data = torch.as_tensor(batch[flags.img_feat], device=device)
            ctx = context_of(flags, batch, device)
            # One span per sync interval: start at the first step after a
            # sync, stop after the log window's copy to the host.
            if not timer.running:
                timer.start()
                steps_in_span = 0
            m = train_step(opt_states, data, batch["target"], desc, step,
                           data_context=ctx, **descs)
            steps_in_span += 1
            batch_accuracy.append(m.accuracy)

            if step % flags.log_interval == 0:
                ex_eval = None
                if flags.exchange_samples > 0:
                    # The eval conversation on the same batch
                    # (model.py:1463-1465).
                    with torch.no_grad():
                        ex_eval = eval_exchange(
                            data, desc, data_context=ctx,
                            uniforms=philox_eval_uniforms(
                                cfg, data.shape[0], seed, step,
                                EVAL_DUMP_SLOT, device), **descs)
                host = packer.unpack(flush_accuracy(packer.pack(m, ex_eval)))
                timer.stop(steps=steps_in_span)
                host["target"] = batch["target"]
                avg_batch_acc = float(np.array(
                    batch_accuracy[-flags.log_interval:]).mean())
                emit_log_window(flags, flogger, logger, epoch, step,
                                i_batch, avg_batch_acc, host)

            # Periodic dev evaluation and best checkpoint
            # (model.py:1544-1576).
            if step % flags.log_dev == 0:
                dev_acc, extra = eval_dev(
                    flags, modules, eval_exchange, flags.dev_file,
                    flags.batch_size_dev, epoch, flags.shuffle_dev,
                    flags.top_k_dev, desc_dev, step=step)
                dev_accuracy.append(dev_acc)
                logger.log(key="Development Accuracy", val=dev_acc,
                           step=step)
                logger.log(key="Conversation Length (avg)",
                           val=extra["conversation_lengths_mean"], step=step)
                logger.log(key="Conversation Length (std)",
                           val=extra["conversation_lengths_std"], step=step)
                logger.log(key="Hamming Receiver (avg)",
                           val=extra["hamming_rec_mean"], step=step)
                logger.log(key="Hamming Sender (avg)",
                           val=extra["hamming_sen_mean"], step=step)
                flogger.Log(
                    "Epoch: {} Step: {} Batch: {} Development Accuracy: {}"
                    .format(epoch, step, i_batch, dev_accuracy[-1]))
                flogger.Log(
                    "Epoch: {} Step: {} Batch: {} Conversation Length "
                    "(avg/std): {}/{}".format(
                        epoch, step, i_batch,
                        extra["conversation_lengths_mean"],
                        extra["conversation_lengths_std"]))
                flogger.Log(
                    "Epoch: {} Step: {} Batch: {} Mean Hamming Distance "
                    "(R/S): {}/{}".format(
                        epoch, step, i_batch, extra["hamming_rec_mean"],
                        extra["hamming_sen_mean"]))
                if step >= flags.save_after and dev_acc > best_dev_acc:
                    best_dev_acc = dev_acc
                    flogger.Log("Checkpointing with best Development "
                                "Accuracy: {}".format(best_dev_acc))
                    save_checkpoint(flags.checkpoint + "_best",
                                    dict(step=step,
                                         best_dev_acc=best_dev_acc),
                                    modules, opt_states,
                                    fmt=flags.ckpt_format)

            # Periodic checkpoint (model.py:1578-1584).
            if step >= flags.save_after and step % flags.save_interval == 0:
                flogger.Log("Checkpointing.")
                save_checkpoint(flags.checkpoint,
                                dict(step=step, best_dev_acc=best_dev_acc),
                                modules, opt_states, fmt=flags.ckpt_format)

            step += 1
            if max_steps is not None and step >= max_steps:
                done = True
                break

        # Close an open span on a real sync (the accuracy copy waits for
        # every launched step).
        if timer.running:
            flush_accuracy()
            timer.stop(steps=steps_in_span)
        if timer.count:
            flogger.Log("Epoch {} step timing: {}".format(
                epoch, timer.summary()))
            timer.reset()
        epoch += 1

    flogger.Log("Finished training.")
    flush_accuracy()
    wait_for_checkpoints()   # commit an Orbax save still in flight
    return dict(step=step, best_dev_acc=best_dev_acc, modules=modules,
                opt_states=opt_states, batch_accuracy=batch_accuracy,
                metrics=logger.history)
