"""The chunked training driver: the main path of ``python -m
multimodalgame_tpu_torch``.

The port of ``multimodalgame_tpu/game/driver.py:run_fast``:

* the training and dev sets are staged on the device once
  (``data/device_dataset.py``); batches are gathered there by a
  host-made ``(K, B)`` index plan;
* steps between host-visible boundaries (the log, dev and checkpoint
  cadences, reference model.py:1341-1584) run as chunks of the indexed
  trainer (``make_indexed_train_steps``: one trainer for the chunks and
  the log-boundary steps), split by the piece planner into
  512-step pieces and one remainder, which bounds the distinct chunk
  lengths a run uses; the randomness of step ``s`` is keyed by the
  global step (Philox ``(seed, s)`` or the caller's ``uniforms(s)``), so
  the partition cannot change the trajectory;
* a log-boundary step runs alone with full metrics, plus one eval
  conversation on the same batch for the "Eval:" dump; everything its
  window prints is packed into one tensor (``game/logpack.py``) and
  copied to the host once, with the accuracies of the steps since the
  last copy, at the next host-visible event (the step-ordered event
  queue keeps every line in the order and with the content of immediate
  printing);
* a dev sweep (``game/fast_eval.py``) and a checkpoint run at their
  step, after the queued log windows print, so the best checkpoint holds
  the parameters of its dev step.

On a GPU every training step's phase A is one launch of the train-mode
kernel (``fast="kernel"`` where
``ops/cuda_exchange.py:train_kernel_supports`` holds for the config, a
rank's rows and the class count; the log names the sampler) and every
eval conversation one launch of the eval-mode kernel. On a card every
step is one replay of a captured CUDA graph and every eval conversation
of the kernel another (``game/train.py:step_route``, the port of the JAX
package's one compiled program per K updates and per sharded step; the
log names the route as ``Step: graph``), a ``-mesh`` or ``-mesh_model``
rank's too when its ranks are on distinct cards (NCCL, whose
collectives run inside the graph); on the CPU and for ranks that share a
card (gloo) the same step body runs uncaptured (``Step: eager``). The
configs it
rejects (attention, ``mou``, ``-flipout_dev`` with flipout) and the sizes
that no launch plan fits (the big game's 1,000 classes) run both on the
plain conversation; a ``-compute_dtype bfloat16`` game samples on the plain
conversation (the train kernel is float32-only) and evaluates in float32
through the eval kernel. Under ``-images cifar`` the training set is the
CIFAR-10 pixels, staged as uint8 and normalized on the device batch by
batch. Under ``attn_extra_context`` the sets
stage the ``-data_context`` column beside the features, and under
description attention the packs' padded word sets go to every step.
Under ``-flipout_dev`` a log window's eval dump draws its flips from
Philox keyed by ``(random_seed + 1, step)`` and ``EVAL_DUMP_SLOT``, a dev
sweep from the same key and one slot a batch.

With ``-mesh N`` every rank of the job (``parallel/distributed.py``)
runs this same loop on the same sets, plans and seeds, so every rank
meets every collective in the same order: each step trains on the rank's
rows of the batch, the log window's metrics come back whole (summed and
gathered), a log window's eval dump runs on the whole batch, a dev
sweep on the rank's rows of each dev batch, and only rank 0 writes the
checkpoints. Each rank prints the same log, rank 0's to ``-log_file``
(the others to ``.p<rank>`` paths), with the one banner ``Data-parallel
mesh: N devices (...)`` that JAX prints too.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from multimodalgame_tpu_torch.data.cifar import normalize
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.game.exchange import description_inputs
from multimodalgame_tpu_torch.game.fast_eval import run_device_dev_eval
from multimodalgame_tpu_torch.game.logpack import LogPacker
from multimodalgame_tpu_torch.game.train import (gather_batch,
                                                  make_indexed_train_steps,
                                                  step_route)
from multimodalgame_tpu_torch.ops.cuda_exchange import train_kernel_supports
from multimodalgame_tpu_torch.ops.philox import (EVAL_DUMP_SLOT,
                                                 philox_eval_uniforms)
from multimodalgame_tpu_torch.utils.checkpoint import (save_checkpoint,
                                                       wait_for_checkpoints)
from multimodalgame_tpu_torch.utils.device import resolve_device
from multimodalgame_tpu_torch.utils.profiling import StepTimer, span

# Chunk sizes are drawn from this fixed set, so the number of distinct
# chunk lengths is bounded by its length, not by the flag values.
_POW2 = (512, 256, 128, 64, 32, 16, 8, 4, 2, 1)

# The reference's Scale(227) of the CIFAR images (model.py:1195-1206).
CIFAR_IMAGE_SIZE = 227

# A recurring sub-512 remainder runs as one exact-length piece from its
# second occurrence on; its first occurrence decomposes into _POW2
# pieces. The cap bounds the distinct exact lengths.
_EXACT_CAP = 16


def decompose_chunks(k: int) -> list:
    """Greedy power-of-two decomposition of a chunk of ``k`` steps."""
    out = []
    for p in _POW2:
        while k >= p:
            out.append(p)
            k -= p
    return out


def make_piece_planner(cap: int = _EXACT_CAP):
    """Returns ``plan(k) -> [piece sizes]``: 512-step pieces plus one
    remainder, exact-length once that length recurs (at most ``cap``
    distinct exact lengths), else decomposed into _POW2 pieces."""
    seen = set()
    admitted = set()

    def plan(k: int) -> list:
        pieces = []
        while k >= 512:
            pieces.append(512)
            k -= 512
        if k:
            if k in admitted or (k in seen and len(admitted) < cap):
                admitted.add(k)
                pieces.append(k)
            else:
                seen.add(k)
                pieces.extend(decompose_chunks(k))
        return pieces

    return plan


# The driver's line naming phase A's sampler: "kernel" where
# ``ops/cuda_exchange.py:train_kernel_supports`` holds for the config, a
# rank's rows and the class count, else "plain". The JAX package prints
# no such line.
SAMPLER_LINE = "Phase A sampler: {}"
# The driver's line naming how the steps run (``game/train.py:
# step_route``): "graph", each update one replay of a captured CUDA graph
# (a CUDA device, alone or a rank of an NCCL mesh or grid), or "eager",
# the same step body uncaptured (the CPU, ranks that share a card over
# gloo). The JAX package prints no such line either.
STEP_LINE = "Step: {}"


def device_pool(device, count: int) -> List[torch.device]:
    """The devices ``-mesh`` may take, in order: a list as given; ``cpu``
    as many CPU ranks as asked (``count``); ``None`` or ``cuda`` every
    visible card; one explicit device alone. ``count`` -1 (``-mesh -1``)
    needs cards or a list."""
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cpu":
        if count < 0:
            raise ValueError("-mesh -1 counts the visible cards; on the "
                             "CPU give -mesh N or a device list")
        return [dev] * count
    if dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def resolve_mesh(flags, batch_fields=("batch_size", "batch_size_dev"),
                 device=None) -> Optional[List[torch.device]]:
    """The devices of this host's ranks for ``-mesh`` (0/1 = one device,
    N > 1 = the first N of the job's devices, -1 = all of them), or
    ``None`` for one device (JAX driver.py:130-165). ``device`` is the
    caller's (:func:`device_pool`); under ``-num_processes P`` each host
    takes its N / P. With ``-mesh_model M`` (M > 1) the N ranks form a
    ``(data = N / M, model = M)`` grid (``parallel/tensor.py:
    make_mesh_2d``, built by each rank): batches split over the data axis
    only, so the ``batch_fields`` must divide N / M. Raises
    ``ValueError`` with JAX's messages: ``-mesh_model`` without a mesh of
    more than one device, M not dividing N, a batch field that does not
    split over the data axis; and for fewer devices than asked."""
    n = int(flags.mesh or 0)
    m = int(flags.mesh_model or 0)
    procs = int(flags.num_processes or 1)
    pool = None
    if n == -1:
        pool = device_pool(device, -1)
        n = len(pool) * procs
    if m > 1 and n <= 1:
        raise ValueError(
            "-mesh_model requires -mesh to resolve to more than one "
            "device (the device set the model axis splits)")
    if n <= 1:
        return None
    if pool is None:
        pool = device_pool(device, max(n // procs, 1))
    n_data = n
    if m > 1:
        if n % m:
            raise ValueError(
                f"-mesh_model {m} does not divide the -mesh size {n}")
        n_data = n // m
    for fname in batch_fields:
        b = getattr(flags, fname)
        if b % n_data:
            raise ValueError(
                f"-{fname} {b} is not divisible by the data-axis size "
                f"{n_data} (-mesh {n}"
                + (f" / -mesh_model {m})" if m > 1 else ")"))
    if n % procs:
        raise ValueError(f"-mesh {n} does not split over -num_processes "
                         f"{procs}")
    local = n // procs
    if len(pool) < local:
        raise ValueError(f"requested a {n}-device mesh but only "
                         f"{len(pool) * procs} devices are available")
    return pool[:local]


def mesh_banner(mesh, device) -> str:
    """The log's one line about the mesh (JAX driver.py:239-256), with
    the process group's backend."""
    if mesh.model is not None:
        return "Mesh: {} devices = {} data x {} model ({}, {})".format(
            mesh.size * mesh.model.size, mesh.size, mesh.model.size,
            device.type, mesh.backend)
    return "Data-parallel mesh: {} devices ({}, {})".format(
        mesh.size, device.type, mesh.backend)


def run_fast(flags, modules, opt_states, desc_train, desc_dev, flogger,
             logger, eval_exchange: Callable, step: int = 0,
             best_dev_acc: float = 0.0, max_steps: Optional[int] = None,
             train_ds: Optional[DeviceDataset] = None,
             dev_ds: Optional[DeviceDataset] = None,
             uniforms: Optional[Callable] = None, mesh=None,
             tp=None) -> dict:
    """Train with the chunked schedule on the modules' device; returns
    the summary dict of the per-batch loop in ``train.py`` plus
    ``seconds``, the wall seconds of the run's step spans
    (``step_spans``, the ``StepTimer``'s), dev sweeps (``dev_sweeps``,
    the dev-sweep spans below) and checkpoint writes (``checkpoints``,
    the checkpoint spans). A span that copies to the host waits for the
    steps queued before it, so its seconds hold that wait too.

    Each part of the loop runs inside a ``utils/profiling.py:span``: the
    steps' launches or replays (``mmg.driver.steps``), a log step's eval
    dump and packing (``mmg.driver.log_dump``), a log window's copy and
    print (``mmg.driver.log_window``), the dev sweeps
    (``mmg.driver.dev_sweep``), the checkpoints
    (``mmg.driver.checkpoint``) and the epochs' shuffle plans
    (``mmg.driver.plan``).

    ``train_ds``/``dev_ds`` replace the sets read from ``-train_file`` /
    ``-dev_file``, and ``uniforms`` (``step -> {s, z, w[, fz, fw]}``)
    replaces the Philox stream; both are seams for callers that hold the
    data in memory or replay another package's draws. ``mesh`` is this
    rank's place in a data-parallel job (``parallel/mesh.py``), or the
    data axis of a ``(data, model)`` grid whose tensor-parallel state is
    ``tp`` (``parallel/tensor.py``: ``modules`` are its whole agents,
    ``opt_states`` its shards' slots)."""
    cfg = modules.cfg
    device = next(modules.parameters()).device
    ctx_key = flags.data_context if flags.attn_extra_context else None
    transform = context_fn = None
    if flags.images == "cifar":
        # The pixels are staged as resized uint8 and normalized on the
        # device, batch by batch; the fc context of attn_extra_context is
        # the same flat pixels, derived from the batch instead of staged
        # twice (JAX driver.py:190-210). The dev set is a feature file.
        if train_ds is None:
            train_ds = DeviceDataset.from_cifar(image_size=CIFAR_IMAGE_SIZE,
                                                device=device)
        if not train_ds.cifar:
            raise ValueError("-images cifar trains on uint8 pixels, got "
                             f"{train_ds.feats.dtype} features")
        flat_feat = flags.img_feat != "layer4_2"

        def transform(x):
            x = normalize(x)
            return x.reshape(x.shape[0], -1) if flat_feat else x

        if flags.attn_extra_context:
            def context_fn(data):
                return data.reshape(data.shape[0], -1)
    elif train_ds is None:
        train_ds = DeviceDataset.from_hdf5(flags.train_file, flags.img_feat,
                                           map_labels=desc_train.map_labels,
                                           context_key=ctx_key,
                                           device=device)
    if dev_ds is None:
        dev_ds = DeviceDataset.from_hdf5(flags.dev_file, flags.img_feat,
                                         map_labels=desc_dev.map_labels,
                                         context_key=ctx_key, device=device)
    descs = description_inputs(desc_train, cfg, device)
    desc = descs.pop("desc")
    seed = flags.random_seed + 1
    if mesh is not None:
        flogger.Log(mesh_banner(mesh, device))

    rows = flags.batch_size // (1 if mesh is None else mesh.size)
    sampler = ("kernel" if train_kernel_supports(cfg, rows, desc.shape[0])
               else "plain")
    flogger.Log(SAMPLER_LINE.format(sampler))
    flogger.Log(STEP_LINE.format(step_route(device, mesh, tp)))
    fast = "kernel" if sampler == "kernel" else "auto"
    full_step, chunk_step = make_indexed_train_steps(
        modules, flags.top_k_train, flags.batch_size, fast=fast, seed=seed,
        uniforms=uniforms, device=device, transform=transform,
        context_fn=context_fn, mesh=mesh, tp=tp)
    packer = LogPacker(cfg, flags.batch_size, flags.exchange_samples)

    L = flags.log_interval
    D = flags.log_dev

    def is_log(t):
        return t % L == 0

    def is_dev(t):
        return t % D == 0

    def is_save(t):
        return t >= flags.save_after and t % flags.save_interval == 0

    plan_pieces = make_piece_planner()
    batch_accuracy = []   # host floats, one per optimizer step, in order
    pending_acc = []      # device accuracy tensors not yet copied
    pending = []          # queued log windows, in step order
    timer = StepTimer()
    state = {"steps_timed": 0}
    # Wall seconds of the run's parts: the timer's spans (each log
    # window's copy and each dev sweep fall inside one, the periodic
    # checkpoints do not), and the dev-sweep and checkpoint spans (an
    # Orbax write's host snapshot and dispatch: it commits on the
    # background writer, as JAX's does).
    spent = {"step_spans": 0.0, "dev_sweeps": 0.0, "checkpoints": 0.0}
    done = False

    def flush_acc(extra: Optional[torch.Tensor] = None):
        """One device-to-host copy of the queued accuracies and, when
        given, of ``extra`` (a log payload); returns ``extra``'s host
        copy."""
        if not pending_acc and extra is None:
            return None
        parts = [a.reshape(-1).float() for a in pending_acc]
        n = sum(p.numel() for p in parts)
        if extra is not None:
            parts.append(extra)
        host = torch.cat(parts).cpu().numpy()
        batch_accuracy.extend(host[:n].astype(np.float64).tolist())
        pending_acc.clear()
        return host[n:] if extra is not None else None

    def queued_acc_count():
        return len(batch_accuracy) + sum(a.numel() for a in pending_acc)

    def restart_timer():
        """Close the running span after a host copy (the sync), then
        reopen it."""
        if state["steps_timed"]:
            timer.stop(steps=state["steps_timed"])
            state["steps_timed"] = 0
            timer.start()

    def flush_payload(ev):
        """Copy and print one queued log window."""
        from multimodalgame_tpu_torch.train import emit_log_window
        payload, t, i_b, ep, tgt, acc_end = ev
        with span("driver.log_window"):
            host = packer.unpack(flush_acc(payload))
            restart_timer()
            host["target"] = tgt
            window = batch_accuracy[max(0, acc_end - flags.log_interval):
                                    acc_end]
            emit_log_window(flags, flogger, logger, ep, t, i_b,
                            float(np.asarray(window).mean()), host)

    def flush_events():
        """Print the queued log windows in step order; called before any
        new host-visible line."""
        while pending:
            flush_payload(pending.pop(0))

    def run_dev(t, i_batch, epoch):
        nonlocal best_dev_acc
        with span("driver.dev_sweep", spent, "dev_sweeps"):
            dev_acc, extra = run_device_dev_eval(
                flags, modules, eval_exchange, desc_dev, dev_ds, epoch,
                step=t, mesh=mesh)
        restart_timer()   # the sweep's copy to the host was the sync
        logger.log(key="Development Accuracy", val=dev_acc, step=t)
        logger.log(key="Conversation Length (avg)",
                   val=extra["conversation_lengths_mean"], step=t)
        logger.log(key="Conversation Length (std)",
                   val=extra["conversation_lengths_std"], step=t)
        logger.log(key="Hamming Receiver (avg)",
                   val=extra["hamming_rec_mean"], step=t)
        logger.log(key="Hamming Sender (avg)",
                   val=extra["hamming_sen_mean"], step=t)
        flogger.Log("Epoch: {} Step: {} Batch: {} Development Accuracy: {}"
                    .format(epoch, t, i_batch, dev_acc))
        flogger.Log("Epoch: {} Step: {} Batch: {} Conversation Length "
                    "(avg/std): {}/{}".format(
                        epoch, t, i_batch,
                        extra["conversation_lengths_mean"],
                        extra["conversation_lengths_std"]))
        flogger.Log("Epoch: {} Step: {} Batch: {} Mean Hamming Distance "
                    "(R/S): {}/{}".format(
                        epoch, t, i_batch, extra["hamming_rec_mean"],
                        extra["hamming_sen_mean"]))
        if t >= flags.save_after and dev_acc > best_dev_acc:
            best_dev_acc = dev_acc
            flogger.Log("Checkpointing with best Development "
                        "Accuracy: {}".format(best_dev_acc))
            with span("driver.checkpoint", spent, "checkpoints"):
                save_checkpoint(flags.checkpoint + "_best",
                                dict(step=t, best_dev_acc=best_dev_acc),
                                modules, opt_states, mesh, tp,
                                fmt=flags.ckpt_format)

    def run_save(t):
        flush_acc()
        if state["steps_timed"]:
            timer.stop(steps=state["steps_timed"])
            state["steps_timed"] = 0
        else:
            timer.cancel()
        flogger.Log("Checkpointing.")
        with span("driver.checkpoint", spent, "checkpoints"):
            save_checkpoint(flags.checkpoint,
                            dict(step=t, best_dev_acc=best_dev_acc),
                            modules, opt_states, mesh, tp,
                            fmt=flags.ckpt_format)
        timer.start()

    # --- Cross-epoch batch stream ----------------------------------------
    # Chunks end at host-visible cadences and max_steps only, not at epoch
    # ends. The per-epoch shuffle plans (seed 11 + epoch) are buffered and
    # consumed in order; a "Starting epoch" line prints when the stream
    # first reaches that epoch's steps. Epochs count 0..max_epoch-1
    # whatever the resumed step, as the reference's run() does
    # (model.py:1190).
    plan_buf = np.zeros((0, flags.batch_size), np.int64)
    tag_epoch = np.zeros((0,), np.int64)   # epoch of each buffered row
    tag_batch = np.zeros((0,), np.int64)   # i_batch within that epoch
    next_epoch = 0        # next epoch to plan
    started_epoch = -1    # highest epoch whose Starting line printed

    def refill(need):
        nonlocal plan_buf, tag_epoch, tag_batch, next_epoch
        while plan_buf.shape[0] < need and next_epoch < flags.max_epoch:
            with span("driver.plan"):
                plan = train_ds.epoch_indices(next_epoch,
                                              flags.shuffle_train,
                                              flags.batch_size)
                if plan.shape[0] == 0:
                    next_epoch = flags.max_epoch  # dataset < one batch
                    break
                plan_buf = np.concatenate([plan_buf, plan], axis=0)
                tag_epoch = np.concatenate(
                    [tag_epoch, np.full(plan.shape[0], next_epoch,
                                        np.int64)])
                tag_batch = np.concatenate(
                    [tag_batch, np.arange(plan.shape[0], dtype=np.int64)])
                next_epoch += 1

    def consume(k):
        nonlocal plan_buf, tag_epoch, tag_batch
        rows, plan_buf = plan_buf[:k], plan_buf[k:]
        eps, tag_epoch = tag_epoch[:k], tag_epoch[k:]
        ibs, tag_batch = tag_batch[:k], tag_batch[k:]
        return rows, eps, ibs

    def enter_epochs(upto):
        """Print the Starting-epoch (and the previous epoch's timing)
        lines of every epoch the stream is about to enter, after the
        queued log windows."""
        nonlocal started_epoch
        while started_epoch < upto:
            started_epoch += 1
            flush_events()
            if started_epoch > 0 and timer.count:
                flogger.Log("Epoch {} step timing: {}".format(
                    started_epoch - 1, timer.summary()))
                spent["step_spans"] += timer.seconds
                timer.reset()
            flogger.Log("Starting epoch: {}".format(started_epoch))
            if not timer.running:
                timer.start()

    while not done:
        t = step
        if max_steps is not None and t >= max_steps:
            break
        refill(1)
        if plan_buf.shape[0] == 0:
            # Epochs exhausted. A dataset smaller than one batch trains no
            # step, but every epoch's Starting line still prints, as in
            # the per-batch loop.
            enter_epochs(flags.max_epoch - 1)
            break
        if is_log(t):
            rows, eps, ibs = consume(1)
            row_np, ev_epoch, ev_batch = rows[0], int(eps[0]), int(ibs[0])
            enter_epochs(ev_epoch)
            # The previous window prints before this one is queued.
            flush_events()
            with span("driver.steps"):
                row = torch.as_tensor(row_np, device=device)
                m = full_step(opt_states, train_ds.feats, train_ds.targets,
                              row, desc, t, feats_context=train_ds.context,
                              **descs)
            with span("driver.log_dump"):
                ex_eval = None
                if flags.exchange_samples > 0:
                    # The eval conversation on the same batch, for the
                    # inferred-conversation dump (model.py:1463-1465).
                    with torch.no_grad():
                        data, ctx = gather_batch(train_ds.feats, row,
                                                 train_ds.context, transform,
                                                 context_fn)
                        ex_eval = eval_exchange(
                            data, desc, data_context=ctx,
                            uniforms=philox_eval_uniforms(
                                cfg, len(row_np), seed, t, EVAL_DUMP_SLOT,
                                device), **descs)
                payload = packer.pack(m, ex_eval)
            pending_acc.append(m.accuracy)
            pending.append((payload, t, ev_batch, ev_epoch,
                            train_ds.targets_host[row_np],
                            queued_acc_count()))
            state["steps_timed"] += 1
            did = 1
        else:
            # Every step up to (not including) the next log boundary, cut
            # at the first dev or checkpoint step so that it runs at its
            # step. Epoch ends do not cut chunks. On the graph route each
            # piece's plan rows go to the trainer's static buffer in one
            # copy, and each step is one replay.
            next_log = (t // L + 1) * L
            limit = next_log - 1
            if max_steps is not None:
                limit = min(limit, max_steps - 1)
            # First dev/save boundary in [t, limit], in closed form.
            chunk_last = limit
            nd = ((t + D - 1) // D) * D                    # is_dev
            if nd <= limit:
                chunk_last = nd
            s0 = max(t, flags.save_after)                  # is_save
            ns = ((s0 + flags.save_interval - 1)
                  // flags.save_interval) * flags.save_interval
            if ns <= limit:
                chunk_last = min(chunk_last, ns)
            k = chunk_last - t + 1
            refill(k)
            k = min(k, plan_buf.shape[0])
            rows, eps, ibs = consume(k)
            ev_epoch, ev_batch = int(eps[-1]), int(ibs[-1])
            enter_epochs(ev_epoch)
            off = 0
            with span("driver.steps"):
                for size in plan_pieces(k):
                    sm = chunk_step(opt_states, train_ds.feats,
                                    train_ds.targets, rows[off:off + size],
                                    desc, t + off,
                                    feats_context=train_ds.context, **descs)
                    pending_acc.append(sm.accuracy)
                    off += size
            state["steps_timed"] += k
            did = k

        t_done = t + did - 1
        if is_dev(t_done):
            flush_events()
            run_dev(t_done, ev_batch, ev_epoch)
        if is_save(t_done):
            flush_events()
            run_save(t_done)
        step = t_done + 1
        if max_steps is not None and step >= max_steps:
            done = True

    flush_events()
    flush_acc()  # the final sync closes the trailing span
    if state["steps_timed"]:
        timer.stop(steps=state["steps_timed"])
        state["steps_timed"] = 0
    if timer.count:
        flogger.Log("Final step timing: {}".format(timer.summary()))
        spent["step_spans"] += timer.seconds
        timer.reset()
    wait_for_checkpoints()   # commit an Orbax save still in flight
    return dict(step=step, best_dev_acc=best_dev_acc, modules=modules,
                opt_states=opt_states, batch_accuracy=batch_accuracy,
                metrics=logger.history, seconds=spent)
