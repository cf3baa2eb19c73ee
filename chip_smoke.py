#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. probe   — torch/CUDA/nvcc versions and the card's name and power limit;
             exits non-zero when no CUDA device is available;
2. build   — compiles every CUDA source of the port, plain and with the
             per-phase clock stamps (one nvcc each, all started
             together), and prints ptxas's report;
3. kernels — the fused eval-exchange kernel against its plain PyTorch
             version on the card, at the canonical Adaptive width (feat
             512, sender hidden 256, 32-bit messages, receiver hidden 64,
             wv 100, 30 classes, 10 turns) for batches 1, 7, 64, 100 and
             the variants fixed, prod, ignore_code and corruption "0:3,7",
             plus two launch-plan shapes (PLAN_CASES: the flags'
             defaults with 100 classes at batch 37, and weights too large
             for the shared memory of 8 CTAs);
4. train_kernels — the train-mode kernel (``fused_train_forward``)
             against its plain version at the canonical width, for
             batches 1, 7, 64, 100 and the variants adaptive, fixed, prod,
             ignore_code, ignore_receiver and flipout (0.1 on both
             channels), in its three random modes: uniforms drawn by
             numpy and handed in, Philox keyed by (seed, step) by value
             with the plain version fed ``ops/philox.py``'s numbers for
             the same key, and Philox keyed by the device tensor [seed,
             step, row_base] that a captured step reads (``key=``; the
             launch must also equal the by-value one bit for bit), and
             the two PLAN_CASES in all three. Tie rows (a probability
             within 1e-5 of its uniform) are counted; any other
             difference is fatal;
5. serve   — random canonical-width weights (stop bias STOP_BIAS) saved
             as a reference .pt, loaded by ``Predictor.from_checkpoint``
             on cuda, four request
             batches (1, 7, 64, 100) answered through the kernel (its
             launch count must grow by exactly 4; a request shape's first
             call runs eagerly, its later ones replay its CUDA graph) and
             held against a plain ``Predictor(use_kernel=False)`` on the
             same card;
6. train   — the bare trainer: ``make_multistep_train_step_indexed
             (fast="kernel")`` on cuda at the canonical width and
             hyper-parameters (RMSprop, lr 1e-4, entropies 0.08 / 0.01 /
             0.01, batch 64), over an in-memory synthetic set of 30
             classes x 100 train and 20 dev examples, for 5 epochs in one
             chunk. The train kernel's launch count must equal the number
             of steps and every loss must be finite; dev top-1 and top-6
             are read through the eval kernel; the four agents are saved
             as a reference .pt and loaded back (every step carries each
             agent flat: its weights, gradient and slots one buffer each);
6a. staged — the staged K-step trainer ``make_multistep_train_step
             (fast="kernel")`` on 2 epochs (92 steps) of (K, 64, 512)
             stacks staged on the card: one train-kernel launch a step,
             finite losses, the run bit for bit the indexed chunk's over
             the same rows staged as a set (``idx = arange``); then the
             step's ms, kernels a step and busy share;
6b. graph  — the graph route (``game/train.py:step_route``: one CUDA
             device, no mesh, no tensor parallelism; the port of the JAX
             package's one compiled program per K updates), which phases
             5-7, 8-10, 12, 13 and 16 take by default (their counts hold
             unchanged: a graph's replays add the launches its capture
             recorded). The bare trainer from seed 0, 2 eager warm-up
             steps then 8 replays, one step a chunk, against 8 + 2 eager
             steps, for RMSprop and Adam: a weights digest after every
             step must be equal (or, if capture rounded otherwise, the
             first differing step and the largest difference are
             reported and the weights held at JAX's mesh tolerance), the
             step's scalars and Adam's count equal, one train launch a
             step on both routes; 92 staged steps in one chunk on the
             graph: 92 train launches, 90 replays, finite losses; the
             host's calls that put work on the card (``cudaGraphLaunch``,
             ``cudaLaunchKernel``/``ExC``, ``cuLaunchKernel``,
             ``cudaMemcpyAsync``, from ``torch.profiler``) a step at one
             step a chunk and an update in a chunk of 8 (at most 4 on the
             graph), with the device's kernels a step, busy share and the
             step's host ms, graph against eager in turns (eager, graph,
             graph, eager); and ``Predictor.predict`` on the graph at
             batches 1, 7, 64 and 100, three times each (eager, capture,
             replay), bit for bit the eager ``Predictor(graph=False)``'s
             answers, one eval launch a request, and both ms;
6c. mesh_graph — a rank of an NCCL mesh on the graph route
             (``game/train.py:step_route``: every collective NCCL's, so
             the step's all-reduces run inside its CUDA graph), in a
             one-rank NCCL group on the card (``parallel/distributed.py:
             launch``; NCCL refuses two ranks on one card, and one rank
             runs the same ``ProcessGroupNCCL`` code): the bare trainer
             from seed 0, 2 eager then 8 replayed steps against 10 eager
             ones, for RMSprop and Adam, a digest of the weights, slots
             and Adam's counts and the step's scalars after every step
             (held bit for bit, or at JAX's mesh tolerance as the graph
             phase holds them), the collective calls a step equal (held);
             host launch calls an update (at most 4 in a chunk of 8) and
             step ms, device kernels and busy share, graph against eager
             in turns; the same on a 1 x 1 grid of that rank
             (``make_mesh_2d``, tensor-parallel), its model axis held to
             TP_MODEL_CALLS calls a step; then ``run_fast`` as that
             rank (``train._run_rank``) with the demo's argv cut to
             MESH_GRAPH_EPOCHS epochs: ``Step: graph`` in its log, the
             cadences' counts and launches, dev top-6 at least 0.5. A
             one-rank all-reduce moves no bytes: NCCL's cost across cards
             is not measured;
7. driver  — the training main path: ``train.run`` (what ``python -m
             multimodalgame_tpu_torch`` calls) with the demo's argv
             (tools/demo.sh:21-31), parsed by the port's config.py, on
             the same in-memory sets and descriptions, for the demo's 30
             epochs = 1,380 steps. Train-kernel launches must equal the
             steps and eval-kernel launches the count the cadences give
             (``cadence_counts``: a log window's eval dump, and every dev
             batch of every dev sweep); the log must hold the predicted
             counts of "Training Accuracy", "Development Accuracy" and
             "Checkpointing." lines, only finite losses, and a last dev
             top-6 of at least 0.5 (chance 0.2); the checkpoint and its
             _best, the JAX package's msgpack files, reload with the
             weights and optimizer slots ``read_checkpoint`` reads from
             them; an ``-eval_only`` run on _best (``-log_load`` of the
             run's JSON) must reproduce _best's ``best_dev_acc``;
7a. ckpt_msgpack — the checkpoint path: ``train.run`` resumed from the
             driver's msgpack _best for CKPT_EPOCHS epochs (230 steps,
             across a second checkpoint step) and again from a reference
             .pt of the same state: each logs ``Step: graph``, launches
             the train kernel once a step and the eval kernel as the
             cadences give from the resumed step, reaches dev top-6 0.5,
             and rewrites its checkpoint in the format it resumed (the
             .pt named in its log); ``Predictor.from_checkpoint`` on the
             resumed msgpack file and on a .pt of the same modules at
             batches 1 and 64 (one eval launch a request, answers equal
             bit for bit); then each format's bytes and write and read ms
             (medians of CKPT_REPS, in turns);
7b. ckpt_orbax — the JAX package's Orbax checkpoint directories, read
             and written by the port's own OCDBT, zarr and zstd codecs:
             ``train.run -ckpt_format orbax`` with the demo's argv for
             CKPT_EPOCHS epochs (230 steps) on ``Step: graph``, its counts
             and launches as the cadences give, no staging left behind,
             both directories reloaded and ``-eval_only`` on _best
             reproducing its ``best_dev_acc``; resumed for
             ORBAX_RESUME_EPOCHS epochs from its periodic directory and
             from a msgpack file of the same state, and the JAX fixture
             (tests/data/orbax_jax_adam, FIXTURE_ARGV's narrow game)
             resumed the same two ways: each pair bit-equal (weights and
             slots); ``Predictor.from_checkpoint`` on a directory against
             one on a msgpack file of its modules (one eval launch a
             request, answers equal bit for bit); a directory whose
             B-tree node is cut short refused with a ``ValueError``
             naming it, no kernel launched and the directory unchanged;
             then the Orbax write's ms to return and to commit and its
             read ms against msgpack's (medians of ORBAX_REPS, in turns)
             and the pure-Python zstd decoder's MB/s (median of 3) on
             the fixture's chunks and tests/data/zstd_weights_level1.zst;
8. driver_attention — ``train.run`` with ``-model_type AdaptiveAttention``
             and the demo's other flags (benchmarks/adaptive_attention_run.py
             :76-96 for the model, the demo's cadences) on in-memory
             ``layer4_2`` maps and ``fc`` contexts made as data/synthetic.py
             makes them (30 classes x 100 train and 20 dev), for 15 epochs =
             690 steps (cut from 30, ATTENTION_ARGV's note): no launch of
             either kernel
             (``supports_config``
             sends attention to the plain conversation), the cadences'
             counts, finite losses, a last dev top-6 of at least 0.5, both
             checkpoints reloaded with their attention entries and slots, and
             ``-eval_only`` on _best reproducing its ``best_dev_acc``; the
             run's steps/s and where its seconds went;
9. serve_attention — ``Predictor`` on that _best with the ``fc`` context at
             batches 1, 64 and 100, held on the card against the same
             Predictor on the CPU (``compare_outputs``: bits equal but for
             counted tie rows, class scores within 1e-4);
10. variants — ``train.run`` for 2 epochs (92 steps) at the canonical
             width with ``-desc_attn`` (word sets of 3-12 words),
             ``-sender_mix mou``, ``-sender_mix mou -ignore_code`` and
             ``-flipout_dev -flipout_sen 0.1 -flipout_rec 0.1``: finite
             losses, the cadences' counts, no kernel launch;
11. kernels_cifar — both kernels at the CIFAR width (flat pixels, F =
             154,587, 10 classes) against their plain versions at batches
             64 and 100, then their times at batch 64 beside the bound;
12. bf16    — ``train.run`` with ``-compute_dtype bfloat16`` for 2 epochs:
             no train-kernel launch (the kernel samples in float32 only),
             the cadences' eval launches, finite losses, float32
             parameters and optimizer slots, steps/s;
13. cifar   — ``train.run`` with ``-images cifar -img_feat_dim 154587`` for
             1 epoch (156 steps) on 10,000 uint8 images of 3 x 227 x 227
             made on the card from a seed (1.55 GB staged), with a dev set
             of the same width in memory: launches and log counts from
             the cadences, finite losses, steps/s;
13a. population_graph — the population's graph route
             (``parallel/population.py:population_route``: any CUDA
             device, with or without a mesh; the port of the JAX
             package's one jitted program per population chunk and per
             dev batch), which phases 14-16 and 20 take by default: 4
             canonical members at learning-rate scales 0.5, 1, 2 and 4
             from seed 0, 2 eager warm-up steps then 8 replays, one step
             a chunk, against 10 eager steps (``graph=False``), for
             RMSprop and Adam: a digest of every member's weights and
             slots after every step must be equal (or, if capture rounded
             otherwise, the first differing step and the largest
             difference are reported and the weights held at
             POPULATION_PARAM_ATOL), Adam's count equal, the first call's
             inputs (not the graph's carry) left as they were and the
             carry, passed back, trained in place; the dev batch's graph
             against the eager ``batch_correct`` at batches 64 and 8 (the
             sweep's truncated last batch), ``-flipout_dev`` off and on
             (uniforms keyed by a device counter, equal to the int
             key's), three calls a shape, equal hit counts; the host's
             launch calls an update from ``torch.profiler`` at one step a
             chunk (graph and eager) and in a chunk of 8 (at most 3 on
             the graph), with the device's kernels a step and busy share;
14. population — one step of a 4-member population (on the graph route:
             its first step is an eager warm-up) against four single-game
             steps with the same weights and uniforms, in float64 (bits
             and accuracies equal, losses within 1e-5, parameters within
             5e-3) and float32 (the same but the losses, which are
             logged);
15. sweep   — ``sweep.run_sweep`` with ``-population 16 -lr_scales
             0.5,1,2,4`` for 5 epochs (230 steps; cut from 10,
             SWEEP_ARGV's note) on the canonical sets, every step after
             the warm-up and every dev batch after its shape's first a
             graph replay (at least 228 replays):
             16 member lines and the summary, no kernel launch, the
             winner's best dev top-6 at least 0.5, ``-eval_only`` on its
             ``_best`` reproducing its final dev accuracy; then the
             population step of 16 on the graph against the eager step in
             turns (eager, graph, graph, eager): ms, game-steps/s, device
             kernels a step, busy share and host launch calls a step,
             beside a single-game step on the same sampler;
16. sweep_one — ``-population 1 -lr_scales 0.5`` for 2 epochs on the
             single game's graph route: 92 train launches, one dev
             sweep's 6 eval launches, ``-eval_only`` agreeing;
17. row_base — the train kernel at batch 64 under Philox as two launches
             of 32 rows (``row_base`` 0 and 32) against one launch of 64:
             bits, masks and the turn count equal, probabilities within
             1e-5, each half held against its plain version, and
             ``philox_uniforms(..., row_base)`` equal to the rows of the
             whole draw;
18. mesh_step — two ranks sharing the card (``parallel/distributed.py:
             launch`` over MESH_DEVICES; gloo on CUDA tensors, after a
             check of which gloo collectives take them) train one epoch
             (46 steps) of the canonical game through the train kernel,
             batch 64 split 32/32, against one device from the same seed
             in this process: the accuracy stream within 1e-6, the train
             kernel launched once a step on each rank, the ranks' weights
             bit-identical, the weights after 8 steps within JAX's mesh
             tolerance of one device's (rtol 5e-3, atol 1e-5,
             ``receiver.y2.bias`` left out; JAX holds them after 8 steps,
             tests/test_mesh_driver.py:73-93) and their share of it after
             46 reported; then a one-rank NCCL group through the same code
             (on the graph route: its all-reduces run inside the step's
             graph, so no gradient all-reduce ms is read there), held the
             same way after 46; steps/s and the gradient
             all-reduce's ms a step. The one device runs twice and must
             repeat itself bit for bit after every step
             (``single_device_first_diff_step`` None), and two threads of
             this process, each a rank on its 32 rows with the gradients
             and batch statistics summed on the card (``thread_meshes``),
             must equal the two ranks bit for bit after every step
             (``split_batch_equals_ranks``): the evidence that what parts
             the mesh from one device is the order of its sums;
19. mesh_driver — ``train.run`` with the demo's argv and ``-mesh 2`` over
             the two ranks on the card, 15 of the demo's 30 epochs
             (MESH_DRIVER_EPOCHS' note): on each rank
             the driver phase's launches, the cadences' log counts, rank
             0's log message for message the ``driver`` phase's (numbers
             aside, the mesh banner left out) but for the best
             checkpoint's lines, which must stand where rank 0's own dev
             sweeps put them, a last dev top-6 of at least 0.5,
             the .pt files reloaded, and ``-eval_only -mesh 2`` on _best
             reproducing its ``best_dev_acc``; steps/s and the collectives'
             ms a step (two ranks on one card: correctness and overhead,
             not scaling);
20. sweep_mesh — ``run_sweep`` at ``-population 4`` for 10 steps (dev
             sweeps at 5 and 10) with its members split over the two
             ranks, each rank's steps and dev batches on the graph route,
             against the unsharded sweep from the same seed: every
             member's dev accuracies equal but for one tie row, and the
             winner equal (cut from 2 epochs: SWEEP_MESH_ARGV's note);
             both runs' game-steps/s (set-up and, on the mesh, the ranks'
             start included);
21. serve_mesh — the serve phase's ``Predictor`` over two blocks on the
             card against the one-device ``Predictor`` at batches 1, 64
             and 100: bits equal but for counted tie rows, class scores
             within 1e-4;
22. timing — CUDA-event medians of both kernels and their plain
             versions around the wrapper call (``ms``: the host's launch
             work included, as every earlier chip_smoke timed it) and, for
             the kernels, of the device's work alone (``device_ms``: the
             card sleeps first while the host enqueues the call) and of
             the host's launch work alone (``kernel_host_ms``), and
             host-clock medians of ``Predictor.predict`` end to end, at
             batches 1, 64 and 100; at batch 64 also both kernels with one
             turn (the once-per-conversation part against the cost of a
             turn), the per-phase cycle split of both instances (stamped
             build), the latency floor; the train kernel in both random
             modes; the whole training step (on the graph route) at batch
             64, with its phase A, forward and backward passes launched
             eagerly beside it, for the Adaptive game (phase A in the
             train kernel, whose device time over the replayed step is
             ``phase_a_share``) and for the AdaptiveAttention game of
             phase 8 (phase A on the plain conversation);
23. tower — (run after phase 11) the served ResNet-34 tower's three
             kernels (``csrc/tower_epilogue.cu``) at the pixel cell's
             shapes (batch 100, 227 x 227: the crops, conv1's 114 x 114
             planes, the stages' 57/29/15/8 planes) against their plain
             versions, normalisation and the stem bit for bit, the block
             epilogue within one unit in the last place with and without
             each shortcut and the ReLU; the captured ``PixelTower``
             replayed with the wrappers' launches counted from 0 (1, 1
             and 32 a run, ``fused_runs`` equal to ``runs``), held against
             the plain forward, its profile free of PyTorch elementwise
             and pooling kernels; each kernel's ms, device ms, plain ms
             and bytes bound, which join the ``kernels`` line.

24. vision — (run after phase 23) the vision tower's rotary kernel
             (``csrc/vision_rotary.cu``) at the photo cell's shapes (batch
             100 of 364 x 504 photos, 16 heads of 80) against its plain
             version in bfloat16 and float32, windowed and full, bit for
             bit (it rounds as PyTorch's passes do); its ms, device ms, plain
             ms and bytes bound; then the captured ``VisionTower`` (the
             cell's seeded weights) on the kernel and, for comparison, on
             the plain version in the kernel's place: each replayed with
             the launches counted (32 rotations a run, each one kernel on
             the kernel route), its device operations and rotary kernels
             in one profiled replay, its replay ms, and its ``token_gap``
             and ``feature_gap`` against the reference tower on 4 images
             within the cell's limits, the two routes' tokens equal; the
             row joins the ``kernels`` line.

``python3 chip_smoke.py --tower`` runs only the probe, the build and
phase 23, and ``--vision`` only the probe, the build and phase 24; each
prints its ``kernels`` line and the result line.
``python3 chip_smoke.py --mesh`` runs only the build, the serve and driver
phases and phases 17-21 (no result line); ``--ckpt`` only the build and
phases 7 and 7a; ``--ckpt-orbax`` only the build and phase 7b;
``--staged`` only the build,
phase 6a and ``mesh_step``; ``--graph`` only the build, phase 4 and
phase 6b; ``--mesh-graph`` only the build and phase 6c;
``--population`` only the build, phases 13a, 14, 15, 16 and 20;
``--mesh-cpu`` ``mesh_step``'s readings with every rank on the CPU (no
card needed, no result line). ``python3
chip_smoke.py --times [OUT [OTHER]]`` runs only the probe, the batch-64
times of both kernels (both rulers) and of ``Predictor.predict``, and one
step of the bare trainer (host ms, kernels a step, busy share), through
entry points that every tree of the port has, so that two trees can be
timed in one call (a tree with the graph route also times its graph
step beside its eager step, and its eager ``Predictor``); with ``OUT`` it
saves there the weights after the trainer's first 8 steps from seed 0,
and with ``OTHER`` (another tree's ``OUT``) reports how far the two part.

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
TRAIN_VARIANTS = {"adaptive": {}, "fixed": {"fixed_exchange": True},
                  "prod": {"sender_mix": "prod"},
                  "ignore_code": {"ignore_code": True},
                  "ignore_receiver": {"ignore_receiver": True},
                  "flipout": {"flipout_sen": 0.1, "flipout_rec": 0.1}}
# Canonical training hyper-parameters (bench.py:40-52, tools/demo.sh:21-29).
TRAIN_HP = dict(entropy_s=0.08, entropy_sen=0.01, entropy_rec=0.01,
                learning_rate=1e-4, optim_type="RMSprop",
                baseline_hid_dim=500)
TRAIN_BATCH, TRAIN_PER_CLASS, DEV_PER_CLASS = 64, 100, 20
EPOCHS = 5                  # the bare trainer's; the driver runs the demo's
MIN_DEV_TOP6 = 0.5
# The ckpt_msgpack phase: each resume trains 5 epochs (230 steps) from the
# driver's _best, so its run crosses a second checkpoint step (every 200);
# each format's write and read is timed CKPT_REPS times, in turns.
CKPT_EPOCHS, CKPT_REPS = 5, 7
# The ckpt_orbax phase: a CKPT_EPOCHS run writing Orbax directories, each
# resume ORBAX_RESUME_EPOCHS epochs (92 steps, across a checkpoint step),
# and the Orbax and msgpack writes and reads timed ORBAX_REPS times, in
# turns.
ORBAX_RESUME_EPOCHS, ORBAX_REPS = 2, 5
# The JAX package's Orbax directory committed for the tests
# (tests/test_torch_orbax.py:write_fixture): an Adam game of these widths
# with 6 classes at step 3, resumed here on in-memory sets of its shapes.
FIXTURE_DIR = os.path.join("tests", "data", "orbax_jax_adam")
FIXTURE_CLASSES, FIXTURE_FEAT, FIXTURE_WV = 6, 24, 16
FIXTURE_ARGV = ["-experiment_name", "fixture", "-model_type", "Adaptive",
                "-img_feat_dim", str(FIXTURE_FEAT), "-img_h_dim", "12",
                "-sender_out_dim", "8", "-rec_w_dim", "8",
                "-rec_hidden", "12", "-baseline_hid_dim", "12",
                "-wv_dim", str(FIXTURE_WV), "-max_exchange", "3",
                "-optim_type", "Adam", "-batch_size", "8",
                "-batch_size_dev", "8", "-top_k_dev", "2",
                "-top_k_train", "2", "-log_interval", "4", "-log_dev", "6",
                "-save_after", "2", "-save_interval", "4",
                "-exchange_samples", "1"]
# The demo's training command (tools/demo.sh:21-31) without its file
# paths: the driver phase hands the sets over in memory.
DEMO_ARGV = ["-experiment_name", "demo", "-model_type", "Adaptive",
             "-max_exchange", "10", "-batch_size", "64",
             "-batch_size_dev", "100", "-rec_w_dim", "32",
             "-sender_out_dim", "32", "-img_h_dim", "256",
             "-rec_hidden", "64", "-learning_rate", "1e-4",
             "-entropy_rec", "0.01", "-entropy_sen", "0.01",
             "-entropy_s", "0.08", "-use_binary", "-max_epoch", "30",
             "-top_k_dev", "6", "-top_k_train", "6", "-wv_dim", "100",
             "-log_interval", "100", "-log_dev", "200", "-save_after", "100",
             "-save_interval", "200", "-exchange_samples", "3"]
# The attention presets' model (benchmarks/adaptive_attention_run.py:76-96)
# at the demo's cadences: the demo's argv with the preset swapped, cut
# from 30 epochs to 15 (690 steps), which keeps the whole script near half
# its time limit with the mesh phases (its dev top-6 was
# 0.7266666666666667 at step 600 on an H100).
ATTENTION_ARGV = [("AdaptiveAttention" if a == "Adaptive" else a)
                  for a in DEMO_ARGV] + ["-max_epoch", "15"]
# Canonical-width variants trained for 2 epochs (92 steps) each.
VARIANT_ARGV = {
    "desc_attn": ["-desc_attn"],
    "mou": ["-sender_mix", "mou"],
    "mou_ignore_code": ["-sender_mix", "mou", "-ignore_code"],
    "flipout_dev": ["-flipout_dev", "-flipout_sen", "0.1",
                    "-flipout_rec", "0.1"],
}
VARIANT_EPOCHS = 2
# CIFAR-10 through -images cifar: the test split's 10,000 images of
# 3 x 227 x 227 pixels (the reference's Scale(227), model.py:1195-1206)
# in 10 classes, flat as -img_feat avgpool_512 carries them.
CIFAR_IMAGES, CIFAR_CLASSES, CIFAR_SIZE = 10_000, 10, 227
CIFAR_FEAT = 3 * CIFAR_SIZE * CIFAR_SIZE
CIFAR_DEV = 500
CIFAR_ARGV = ["-images", "cifar", "-img_feat_dim", str(CIFAR_FEAT),
              "-max_epoch", "1", "-experiment_name", "cifar"]
BF16_ARGV = ["-compute_dtype", "bfloat16", "-max_epoch",
             str(VARIANT_EPOCHS), "-experiment_name", "bf16"]
# The population sweep: 16 members at four learning rates for 5 epochs
# (cut from 10 for the same reason as the attention driver: the best
# member's dev top-6 was 0.792 at step 200 on an H100), and a population
# of one (the single-game trainer) for 2.
SWEEP_ARGV = ["-population", "16", "-lr_scales", "0.5,1,2,4",
              "-max_epoch", "5", "-experiment_name", "sweep"]
SWEEP_ONE_ARGV = ["-population", "1", "-lr_scales", "0.5", "-max_epoch",
                  str(VARIANT_EPOCHS), "-experiment_name", "sweep_one"]
POPULATION_MEMBERS = 4
# The population on the graph route: its members' learning-rate scales,
# and the most host launch calls a replayed update may take in a chunk of
# PROFILED_CHUNK (one counter-and-plan copy, 8 replays, one metrics copy:
# 1.25).
POPULATION_SCALES = [0.5, 1, 2, 4]
POPULATION_HOST_CALLS = 3
# float64: each member's change of weights (new minus start) against its
# single-game step's, and the losses, absolute. One RMSprop step at lr 1e-4
# moves a weight by ~1e-3, so only a limit far below that sees a wrong or
# missing update (tests/test_torch_population.py holds the same 1e-9).
POPULATION_DELTA_ATOL, POPULATION_LOSS_ATOL = 1e-9, 1e-5
# float32: the 5e-3 of JAX tests/test_population.py:78-88 on the weights
# (batched and looped products round differently, and RMSprop's
# g / sqrt(nu) amplifies that in near-zero-gradient directions), and the
# losses relative, a few units in the last place (~8 at a loss of ~80).
POPULATION_PARAM_ATOL, POPULATION_LOSS_RTOL = 5e-3, 1e-6
# The data-parallel phases: two ranks that share the card (gloo on CUDA
# tensors; NCCL refuses two ranks on one card), an epoch of the canonical
# game for the two-rank step, and JAX's mesh tolerance on the weights
# (tests/test_mesh_driver.py:80-93).
MESH_DEVICES = ["cuda:0", "cuda:0"]
MESH_STEP_STEPS = 46
# The mesh driver runs the demo's argv for 10 of its 30 epochs (460
# steps; 15 until the ckpt_orbax phase came, 30 before that, 931 s of
# script on a slow host), which keeps the whole script near 700 s: its
# log is the driver phase's first 460 steps, message for message.
MESH_DRIVER_EPOCHS = 10
# JAX's mesh tolerance holds the weights after 8 steps
# (tests/test_mesh_driver.py:73-93); the two-rank step is held there too,
# and its use after the 46 steps is reported: RMSprop turns the rounding
# of sums taken in another order into steps of up to lr in weights whose
# gradient is near zero, and these add up (PERF.md §6). mesh_step holds
# the evidence instead: one device repeats itself bit for bit, and the
# mesh's arithmetic run on one device (two threads, each a rank) equals
# the two ranks bit for bit after every step.
MESH_PARAM_STEPS = 8
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 5e-3, 1e-5
# The staged K-step trainer: 2 epochs (92 steps) of stacks staged on the
# card.
STAGED_EPOCHS = 2
# The split sweep is held member for member where no sampled decision of
# a member has yet parted from the unsplit sweep's (10 steps, dev sweeps
# at 5 and 10): `vmap`'s batched kernels over 2 and over 4 members round
# differently on the card, so over the 2 epochs of 92 steps two of four
# members' trajectories parted, and at 10 steps one dev row of one member
# fell the other way (the CPU's unsplit sweep agreed with the split one
# there): a row that sits at a threshold, as the tie rows that
# ops/cuda_exchange.py:compare_outputs counts. Each member's count of
# correct dev rows may differ by SWEEP_MESH_TIE_ROWS (PERF.md §6);
# on the CPU the two agree exactly (tests/test_torch_mesh_sweep.py).
SWEEP_MESH_ARGV = ["-population", "4", "-experiment_name", "sweep_mesh"]
SWEEP_MESH_STEPS, SWEEP_MESH_EVERY, SWEEP_MESH_TIE_ROWS = 10, 5, 1
# Tensor parallelism on ranks that share the card: a (1 data x 2
# model) grid for the step, the driver (5 epochs = 230 steps, so that a
# dev sweep at step 200 writes _best) and the big game, and a (2 x 2)
# grid for TP_GRID_STEPS steps. A fast-path step makes TP_MODEL_CALLS
# collectives on the model axis at the canonical width
# (tests/tp_cases.py counts them).
TP_ARGV = ["-mesh", "2", "-mesh_model", "2"]
TP_EPOCHS, TP_GRID_STEPS, TP_MODEL_CALLS = 5, 10, 10
# The big game (bench.py:511-520): 128-bit messages, sender hidden 1024,
# receiver hidden 256, GloVe-300, 1,000 classes, batch 256, float32; no
# launch plan of the kernel fits it. 6 examples a class (23 steps an
# epoch), 20 steps.
BIG_ARGV = ["-sender_out_dim", "128", "-rec_w_dim", "128", "-img_h_dim",
            "1024", "-rec_hidden", "256", "-wv_dim", "300", "-batch_size",
            "256", "-experiment_name", "big"]
BIG_CLASSES, BIG_BATCH, BIG_TRAIN_PER_CLASS, BIG_STEPS = 1000, 256, 6, 20
EXTRACT_IMAGES = 64
# The tower phase: the pixel cell's requests (BENCHMARK.json,
# resnet34_adaptive.serve_pixels), batch 100 of 227 x 227 crops served to
# avgpool_512, replayed TOWER_REPLAYS times with the launches counted.
TOWER_BATCH, TOWER_SIZE, TOWER_TAP, TOWER_REPLAYS = 100, 227, "avgpool_512", 3
# The captured tower against the plain forward (each float32 within 1e-5
# of float64 in the tests, so 2e-5 apart at most), norm-wise.
TOWER_TOL = 2e-5
# The vision phase: the photo cell's requests (BENCHMARK.json,
# qwen2_5_vl_vit_adaptive.serve_photos), batch 100 of 364 x 504 photos,
# the captured tower replayed VISION_REPLAYS times with the launches
# counted, and the cell's limits of `correct` on the tower
# (gamebench/limits/).
VISION_BATCH, VISION_HW, VISION_REPLAYS = 100, (364, 504), 3
VISION_FEATURE_GAP, VISION_TOKEN_GAP = 0.007, 0.06
WORDS = (3, 12)             # words in a class's set, least and most
# Random weights stop every conversation after turn 0; this bias on the
# stop unit makes them run 5-7 of the 10 turns, so the served answers
# depend on the stop-mask chain.
STOP_BIAS = 2.5
REPS = 50
# About 1 ms of device sleep before each call device_median_ms times.
SLEEP_CYCLES = 2_000_000
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
    """Every source, plain and with the per-phase clock stamps: one nvcc
    process each, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from multimodalgame_tpu_torch.ops import cuda_build
    from multimodalgame_tpu_torch.ops.cuda_exchange import PHASE_CLOCK_FLAGS
    sources = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(cuda_build.build, sources, flags)
                for flags in ((), PHASE_CLOCK_FLAGS)]
        results = [r for job in jobs for r in job.result()]
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


def synthetic_set(per_class: int, seed: int):
    """``per_class`` examples of each class, features made as
    ``features`` makes them: ``(feats (N, 512) float32, labels (N,))``."""
    rng = np.random.RandomState(seed)
    proto = np.random.RandomState(1234).randn(NUM_CLASSES, 512)
    labels = np.repeat(np.arange(NUM_CLASSES), per_class)
    feats = np.abs(proto[labels] + 0.3 * rng.randn(len(labels), 512))
    return feats.astype(np.float32), labels


def descriptions() -> np.ndarray:
    return np.random.RandomState(7).randn(NUM_CLASSES, 100).astype(np.float32)


def description_pack():
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    desc = descriptions()
    return DescriptionPack(desc, desc, [1] * NUM_CLASSES,
                           {i: i for i in range(NUM_CLASSES)},
                           {i: f"class{i}" for i in range(NUM_CLASSES)})


def word_pack():
    """Descriptions of 3-12 random words a class, each class's CBOW row
    the mean of its words (data/descriptions.py's layout)."""
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    rng = np.random.RandomState(8)
    lens = rng.randint(WORDS[0], WORDS[1] + 1, size=NUM_CLASSES)
    words = rng.randn(int(lens.sum()), 100).astype(np.float32)
    ends = np.cumsum(lens)
    desc = np.stack([words[e - n:e].mean(0) for n, e in zip(lens, ends)])
    return DescriptionPack(desc, words, lens.tolist(),
                           {i: i for i in range(NUM_CLASSES)},
                           {i: f"class{i}" for i in range(NUM_CLASSES)})


def attention_set(per_class: int, seed: int):
    """``per_class`` examples of each class as data/synthetic.py:117-143
    makes them: prototypes (pool, fc, map, drawn in that order from
    ``RandomState(1234)``) plus 0.3 noise, the noise drawn in the order
    avgpool, fc, map. Returns ``(maps (N, 512, 8, 8), fc (N, 1000),
    labels (N,))``, float32."""
    proto = np.random.RandomState(1234)
    proto.randn(NUM_CLASSES, 512)                       # pool, unused
    proto_fc = proto.randn(NUM_CLASSES, 1000).astype(np.float32)
    proto_map = proto.randn(NUM_CLASSES, 512, 8, 8).astype(np.float32)
    labels = np.repeat(np.arange(NUM_CLASSES), per_class)
    rng = np.random.RandomState(seed)
    rng.randn(len(labels), 512)                         # avgpool, unused
    fc = proto_fc[labels] + np.float32(0.3) * rng.randn(
        len(labels), 1000).astype(np.float32)
    maps = proto_map[labels] + np.float32(0.3) * rng.randn(
        len(labels), 512, 8, 8).astype(np.float32)
    return maps, fc, labels


def make_agents(cfg, device):
    import torch
    from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
    mods = init_params(AgentModules(cfg), seed=0, device=device)
    with torch.no_grad():
        mods.receiver.s.bias.fill_(STOP_BIAS)
    return mods


# Shapes that exercise the launch plan (as tests/test_torch_kernels.py):
# the flags' defaults with 100 classes at batch 37 (a cluster of 4, a
# ragged tile, widths 50/100/128), and weights too large for the shared
# memory of 8 CTAs (some read from device memory).
PLAN_CASES = {
    "defaults_100_classes": (dict(
        img_feat_dim=4096, img_h_dim=100, sender_out_dim=50, rec_w_dim=50,
        rec_hidden=128, wv_dim=100, max_exchange=3), 37, 100),
    "too_large_for_8": (dict(
        img_feat_dim=512, img_h_dim=512, sender_out_dim=128, rec_w_dim=128,
        rec_hidden=512, wv_dim=100, max_exchange=4), 37, 30),
}


def plan_case(name, device, **kw):
    """Config, kernel weights, data and descriptions of a PLAN_CASES
    entry, made from seed 5; its launch plan is logged."""
    import torch
    from multimodalgame_tpu_torch.game.config import GameConfig
    from multimodalgame_tpu_torch.ops.cuda_exchange import (ROWS,
                                                            kernel_params,
                                                            plan_for)
    dims, batch, num_desc = PLAN_CASES[name]
    cfg = GameConfig(fixed_exchange=False, **dims, **kw)
    rng = np.random.RandomState(5)
    data = torch.from_numpy(rng.randn(batch, cfg.img_feat_dim)
                            .astype(np.float32)).to(device)
    desc = torch.from_numpy(rng.randn(num_desc, cfg.wv_dim)
                            .astype(np.float32)).to(device)
    plan = plan_for(cfg, batch, num_desc)
    return cfg, kernel_params(make_agents(cfg, device)), data, desc, {
        "cluster": plan.cluster, "rows_per_tile": ROWS,
        "in_device_memory": list(plan.in_device_memory)}


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
    for name in PLAN_CASES:
        cfg, params, data, desc, plan = plan_case(name, device)
        with torch.inference_mode():
            got = fused_eval_exchange(cfg, params, data, desc)
            want = fused_eval_exchange_reference(cfg, params, data, desc)
        torch.cuda.synchronize()
        rep = compare_outputs(cfg, got, want)
        log({"phase": "kernels", "kernel": "fused_eval_exchange",
             "variant": name, "batch": data.shape[0], **plan, **rep})
        if not rep["ok"]:
            raise SystemExit(f"kernel disagrees with its plain version: "
                             f"{name}")
        worst["max_abs_err"] = max(worst["max_abs_err"], rep["max_abs_err"])
        worst["tie_rows"] += rep["tie_rows"]
        worst["cases"] += 1
    log({"phase": "kernels", "cases": worst["cases"],
         "tie_rows": worst["tie_rows"], "max_abs_err": worst["max_abs_err"]})
    return worst


def numpy_uniforms(cfg, batch: int, seed: int, device):
    import torch
    from multimodalgame_tpu_torch.ops.sampling import uniform_widths
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.rand(cfg.max_exchange, batch, n)
                                .astype(np.float32)).to(device)
            for k, n in uniform_widths(cfg, train=True).items()}


# The train kernel's random modes: uniforms handed in, Philox keyed by
# value, and Philox keyed by the device tensor [seed, step, row_base] that
# a captured step reads (the same launch must give the by-value numbers).
TRAIN_RNG_MODES = ("uniforms", "philox", "key")


def train_case(cfg, params, data, desc, mode: str, device):
    """One launch of the train kernel in ``mode`` against its plain
    version fed the same numbers: ``(got, want, uniforms, report)``; in
    ``key`` mode the report also says whether the launch equals the
    by-value launch of the same key bit for bit."""
    import torch
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        compare_outputs, fused_train_forward, fused_train_forward_reference)
    from multimodalgame_tpu_torch.ops.philox import philox_uniforms
    batch = data.shape[0]
    extra = {}
    with torch.inference_mode():
        if mode == "uniforms":
            u = numpy_uniforms(cfg, batch, 300 + batch, device)
            got = fused_train_forward(cfg, params, data, desc, uniforms=u)
        else:
            u = philox_uniforms(cfg, batch, seed=batch, step=7,
                                device=device)
            by_value = fused_train_forward(cfg, params, data, desc,
                                           seed=batch, step=7)
            got = by_value
            if mode == "key":
                got = fused_train_forward(cfg, params, data, desc,
                                          key=torch.tensor(
                                              [batch, 7, 0], device=device))
                extra["equals_by_value"] = all(
                    torch.equal(a, b) for a, b in zip(got, by_value))
        want = fused_train_forward_reference(cfg, params, data, desc, u)
    torch.cuda.synchronize()
    rep = compare_outputs(cfg, got, want, uniforms=u)
    rep.update(extra)
    rep["ok"] = rep["ok"] and extra.get("equals_by_value", True)
    return got, want, u, rep


def check_train_kernels(device):
    import torch
    from multimodalgame_tpu_torch.ops.cuda_exchange import kernel_params
    desc = torch.from_numpy(descriptions()).to(device)
    worst = {"max_abs_err": 0.0, "tie_rows": 0, "cases": 0, "largest": []}
    for name, kw in TRAIN_VARIANTS.items():
        cfg = canonical_cfg(**TRAIN_HP, **kw)
        params = kernel_params(make_agents(cfg, device))
        for batch in BATCHES:
            data = torch.from_numpy(features(batch, seed=batch)).to(device)
            for mode in TRAIN_RNG_MODES:
                got, want, u, rep = train_case(cfg, params, data, desc,
                                               mode, device)
                log({"phase": "train_kernels",
                     "kernel": "fused_train_forward", "variant": name,
                     "batch": batch, "rng": mode, **rep})
                if not rep["ok"]:
                    raise SystemExit(
                        f"train kernel disagrees with its plain version: "
                        f"{name} batch {batch} {mode}")
                worst["max_abs_err"] = max(worst["max_abs_err"],
                                           rep["max_abs_err"])
                worst["tie_rows"] += rep["tie_rows"]
                worst["cases"] += 1
                worst["largest"].append((rep["max_abs_err"], name, batch,
                                         mode))
    for name in PLAN_CASES:
        cfg, params, data, desc, plan = plan_case(name, device, **TRAIN_HP)
        batch = data.shape[0]
        for mode in TRAIN_RNG_MODES:
            got, want, u, rep = train_case(cfg, params, data, desc, mode,
                                           device)
            log({"phase": "train_kernels", "kernel": "fused_train_forward",
                 "variant": name, "batch": batch, "rng": mode, **plan,
                 **rep})
            if not rep["ok"]:
                raise SystemExit(f"train kernel disagrees with its plain "
                                 f"version: {name} {mode}")
            worst["max_abs_err"] = max(worst["max_abs_err"],
                                       rep["max_abs_err"])
            worst["tie_rows"] += rep["tie_rows"]
            worst["cases"] += 1
            worst["largest"].append((rep["max_abs_err"], name, batch, mode))
    worst["largest"] = sorted(worst["largest"], reverse=True)[:3]
    log({"phase": "train_kernels", "cases": worst["cases"],
         "tie_rows": worst["tie_rows"], "max_abs_err": worst["max_abs_err"],
         "largest_differences": worst["largest"]})
    return worst


def dev_accuracy(mods, feats: np.ndarray, labels: np.ndarray, desc,
                 device):
    """Dev top-1 and top-6 through the eval kernel, in batches of 100:
    the y-mask selection (Adaptive), log-softmax, rank-counted top-k."""
    import torch
    from multimodalgame_tpu_torch.game.losses import (get_rec_outp,
                                                      topk_accuracy)
    from multimodalgame_tpu_torch.game.masks import assemble_loss_masks
    from multimodalgame_tpu_torch.game.train import make_eval_exchange
    run = make_eval_exchange(mods)
    hits = {1: 0.0, 6: 0.0}
    with torch.inference_mode():
        for s in range(0, len(labels), 100):
            ex = run(torch.from_numpy(feats[s:s + 100]).to(device), desc)
            y_masks = (None if mods.cfg.fixed_exchange
                       else assemble_loss_masks(ex.stop_masks).y)
            outp, _ = get_rec_outp(ex.y, y_masks)
            dist = torch.log_softmax(outp, dim=-1)
            target = torch.from_numpy(labels[s:s + 100]).to(device)
            for k in hits:
                hits[k] += float(topk_accuracy(dist, target, k, 1))
    return hits[1] / len(labels), hits[6] / len(labels)


def train_game(device, workdir):
    """The training main path; returns the trained agents, their
    optimizer states, the staged set and the counts."""
    import torch
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES,
                                                      AgentModules,
                                                      init_params)
    from multimodalgame_tpu_torch.game.train import (
        init_opt_states, make_multistep_train_step_indexed)
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.utils.torch_interop import (
        load_reference_checkpoint, save_reference_checkpoint)

    cfg = canonical_cfg(**TRAIN_HP)
    mods = init_params(AgentModules(cfg), seed=0, device=device)
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    dev_feats, dev_labels = synthetic_set(DEV_PER_CLASS, seed=2)
    desc = torch.from_numpy(descriptions()).to(device)
    chunk = make_multistep_train_step_indexed(
        mods, top_k=6, batch_denom=TRAIN_BATCH, fast="kernel", seed=0,
        device=device)
    opts = init_opt_states(cfg, mods)
    steps_per_epoch = train.size // TRAIN_BATCH

    # The bare trainer, counted alone.
    fused_train_forward.launches = 0
    t0 = time.perf_counter()
    plan = np.concatenate([train.epoch_indices(e, True, TRAIN_BATCH)
                           for e in range(EPOCHS)])
    m = chunk(opts, train.feats, train.targets, plan, desc, 0)
    step0 = len(plan)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log({"phase": "train", "steps": step0, "epoch": EPOCHS,
         "loss_rec": float(m.loss_rec.mean()),
         "loss_sen": float(m.loss_sen.mean()),
         "nll_loss": float(m.nll_loss.mean()),
         "train_top6": float(m.accuracy.mean())})
    launches = fused_train_forward.launches
    if launches != step0:
        raise SystemExit(f"expected {step0} train-kernel launches, counted "
                         f"{launches}")
    if not torch.isfinite(torch.stack(list(m))).all():
        raise SystemExit("a training loss is not finite")

    fused_eval_exchange.launches = 0
    top1, top6 = dev_accuracy(mods, dev_feats, dev_labels, desc, device)
    log({"phase": "train", "steps": step0, "epochs": EPOCHS,
         "steps_per_epoch": steps_per_epoch, "seconds": secs,
         "steps_per_s": step0 / secs, "train_kernel_launches": launches,
         "dev_top1": top1, "dev_top6": top6, "chance_top6": 6 / NUM_CLASSES,
         "dev_eval_kernel_launches": fused_eval_exchange.launches})

    ckpt = os.path.join(workdir, "trained.pt")
    save_reference_checkpoint(ckpt, {"step": step0}, mods)
    _, back = load_reference_checkpoint(ckpt, cfg, device=device)
    for agent in AGENT_NAMES:
        a, b = getattr(mods, agent).state_dict(), \
            getattr(back, agent).state_dict()
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise SystemExit(f"{agent} did not survive the .pt round trip")
    log({"phase": "train", "checkpoint": "four agents saved and loaded"})
    return {"launches": launches, "steps": step0, "mods": mods,
            "opts": opts, "train": train, "desc": desc, "chunk": chunk,
            "top1": top1, "top6": top6, "steps_per_s": step0 / secs}


def serve_requests(device, workdir):
    import torch
    from multimodalgame_tpu_torch.config import (finalize_flags, make_flags,
                                                 parse_args)
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
    pack = description_pack()
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


def cadence_counts(flags, train_size: int, dev_size: int,
                   start: int = 0) -> dict:
    """What the driver's cadences predict for a run from step ``start``
    (a resumed run trains ``max_epoch`` epochs from its step): the last
    step, log windows, dev sweeps, periodic checkpoints, and the launches
    of each kernel (one train launch a step; one eval launch for each log
    window's dump and for each batch of each dev sweep)."""
    steps = flags.max_epoch * (train_size // flags.batch_size)
    span = range(start, start + steps)
    logs = sum(1 for t in span if t % flags.log_interval == 0)
    devs = sum(1 for t in span if t % flags.log_dev == 0)
    saves = sum(1 for t in span if t >= flags.save_after
                and t % flags.save_interval == 0)
    dev_batches = -(-dev_size // flags.batch_size_dev)
    return {"steps": start + steps, "log_windows": logs, "dev_sweeps": devs,
            "checkpoints": saves,
            "train_launches": steps,
            "eval_launches": logs * (flags.exchange_samples > 0)
            + devs * dev_batches}


def run_counted(flags, inputs, device):
    """``train.run`` with both kernels' launch counts set to 0 just
    before it; returns its summary, wall seconds and the counts read just
    after it."""
    import torch
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.train import run
    fused_train_forward.launches = 0
    fused_eval_exchange.launches = 0
    t0 = time.perf_counter()
    summary = run(flags, device=device, inputs=inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return summary, secs, {"train_launches": fused_train_forward.launches,
                           "eval_launches": fused_eval_exchange.launches}


def read_log(flags, summary):
    """The run's counts as its log shows them, its logged losses, the
    last dev accuracy and the "Final step timing" line."""
    import ast
    import re
    with open(flags.log_file) as f:
        text = f.read()
    lines = re.split(r"^\d\d-\d\d-\d\d \d\d:\d\d:\d\d \[\d\] ", text,
                     flags=re.M)
    dev_lines = [m for m in lines if m.startswith("Epoch: ")
                 and "Development Accuracy: " in m]
    got = {"steps": summary["step"],
           "log_windows": sum("Training Accuracy: " in m for m in lines),
           "dev_sweeps": len(dev_lines),
           "checkpoints": sum(m.strip() == "Checkpointing." for m in lines)}
    losses = [float(v) for v in re.findall(r"Loss [^:]*: (\S+)", text)]
    last_dev = float(dev_lines[-1].split(": ")[-1]) if dev_lines else 0.0
    timing = ast.literal_eval(
        text.split("Final step timing: ")[1].splitlines()[0])
    return got, losses, last_dev, timing


def check_counts(phase, got, want, losses):
    for k, v in got.items():
        if v != want[k]:
            raise SystemExit(f"{phase}: {k} {v}, expected {want[k]}")
    if not losses or not all(np.isfinite(losses)):
        raise SystemExit(f"{phase}: a logged loss is not finite")


def check_reloads(phase, flags, device, fmt="msgpack"):
    """The checkpoint and its _best, the JAX package's checkpoints in
    ``fmt``, reload with weights and optimizer slots equal to what
    ``read_checkpoint`` reads from them; returns _best's data."""
    import torch
    from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES,
                                                      AgentModules)
    from multimodalgame_tpu_torch.game.config import GameConfig
    from multimodalgame_tpu_torch.game.train import init_opt_states
    from multimodalgame_tpu_torch.utils.checkpoint import (
        checkpoint_format, load_checkpoint, read_checkpoint)
    from multimodalgame_tpu_torch.utils.torch_interop import (
        opt_states_to_torch)
    cfg = GameConfig.from_flags(flags)
    for path in (flags.checkpoint, flags.checkpoint + "_best"):
        if checkpoint_format(path) != fmt:
            raise SystemExit(f"{phase}: {path} is not {fmt}")
        payload = read_checkpoint(path)
        mods = AgentModules(cfg).to(device)
        opts = init_opt_states(cfg, mods)
        data = load_checkpoint(path, mods, opts)
        slots = opt_states_to_torch(mods, opts, cfg.optim_type,
                                    data["step"])
        for agent in AGENT_NAMES:
            sd = getattr(mods, agent).state_dict()
            ok = all(torch.equal(sd[k].cpu(), v)
                     for k, v in payload["models"][agent].items())
            st = payload["optimizers"][agent]["state"]
            n_params = len(list(getattr(mods, agent).parameters()))
            ok = ok and len(st) == n_params and all(
                torch.equal(slots[agent]["state"][i][k], v)
                for i, s in st.items() for k, v in s.items()
                if isinstance(v, torch.Tensor))
            if not ok:
                raise SystemExit(f"{phase}: {path}: {agent} did not reload")
    best = read_checkpoint(flags.checkpoint + "_best")["data"]
    log({"phase": phase, "checkpoints_reloaded": 2, "format": fmt,
         "best": best,
         "sender_entries": sorted(payload["models"]["sender"])})
    return best


def check_eval_only(phase, flags, inputs, device, best):
    """``-eval_only`` on _best, configured from the run's JSON, must
    reproduce _best's ``best_dev_acc``."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    eval_flags = flags_from_argv(["-log_load", flags.json_file,
                                  "-eval_only", "-checkpoint",
                                  flags.checkpoint + "_best"])
    out, _, counts = run_counted(eval_flags, inputs, device)
    with open(eval_flags.eval_csv_file) as f:
        header, csv_row = f.read().splitlines()[:2]
    fields = dict(zip(header.split(","), csv_row.split(",")))
    log({"phase": phase, "eval_only": fields,
         "eval_kernel_launches": counts["eval_launches"]})
    if (float(fields["best_dev_acc"]) != best["best_dev_acc"]
            or out["dev_acc"] != best["best_dev_acc"]):
        raise SystemExit(f"{phase}: -eval_only gave {out['dev_acc']} on "
                         f"_best, which recorded {best['best_dev_acc']}")


def log_time_split(phase, steps, secs, spent, smi):
    """Where the run's wall time went, as the run itself measured it:
    ``step_spans`` are the driver's timer spans (the steps, each log
    window's copy and each dev sweep; not the periodic checkpoints), and
    what lies outside them is set-up, checkpoints and log lines."""
    log({"phase": phase, "seconds": secs, "run_steps_per_s": steps / secs,
         "spent_s": spent,
         "outside_step_spans_s": secs - spent["step_spans"],
         "share": {"step_spans": spent["step_spans"] / secs,
                   "dev_sweeps": spent["dev_sweeps"] / secs,
                   "checkpoints": spent["checkpoints"] / secs,
                   "outside_step_spans":
                       (secs - spent["step_spans"]) / secs},
         "card": smi})


def drive(device, workdir, smi):
    """The training main path through ``train.run`` with the demo's argv
    and in-memory sets, then ``-eval_only`` on its best checkpoint."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset

    flags = flags_from_argv(DEMO_ARGV + ["-log_path", workdir])
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    dev = DeviceDataset(*synthetic_set(DEV_PER_CLASS, seed=2), device=device)
    pack = description_pack()
    inputs = (pack, pack, train, dev)
    want = cadence_counts(flags, train.size, dev.size)

    # The main path, counted alone.
    summary, secs, counts = run_counted(flags, inputs, device)
    got, losses, last_dev, timing = read_log(flags, summary)
    got.update(counts)
    log({"phase": "driver", **got, "expected": want,
         "finite_losses": len(losses), "last_dev_top6": last_dev,
         "best_dev_acc": summary["best_dev_acc"], "seconds": secs,
         "last_epoch_steps_per_s": timing["steps_per_sec"],
         "last_epoch_timing": timing, "card": smi})
    check_counts("driver", got, want, losses)
    if last_dev < MIN_DEV_TOP6:
        raise SystemExit(f"driver: dev top-6 {last_dev} is below "
                         f"{MIN_DEV_TOP6}")
    best = check_reloads("driver", flags, device)
    check_eval_only("driver", flags, inputs, device, best)
    log_time_split("driver", want["steps"], secs, summary["seconds"], smi)
    return {"train_launches": got["train_launches"],
            "eval_launches": got["eval_launches"],
            "last_epoch_steps_per_s": timing["steps_per_sec"],
            "run_steps_per_s": want["steps"] / secs,
            "last_dev_top6": last_dev, "log_file": flags.log_file,
            "batch_accuracy": summary["batch_accuracy"], "flags": flags,
            "checkpoint_s": summary["seconds"]["checkpoints"]}


ADOPTED = {"pt": "Checkpoint is a reference .pt file",
           "orbax": "Checkpoint is an orbax directory; using -ckpt_format "
                    "orbax for this run"}


def resume_counted(name, source, root, inputs, device, smi, start,
                   phase="ckpt_msgpack", argv=DEMO_ARGV, epochs=CKPT_EPOCHS,
                   min_top6=MIN_DEV_TOP6):
    """``train.run`` resumed from a copy of ``source`` (a file or an
    Orbax directory) at ``root/name`` for ``epochs`` epochs of ``argv``:
    the cadences' counts from ``start``, ``Step: graph``, finite losses,
    the log naming the format it adopts, a last dev top-6 of at least
    ``min_top6`` (where given), and the checkpoint at the path rewritten
    in ``source``'s format at the last checkpoint step. Returns its
    row."""
    import shutil
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                           read_checkpoint)
    path = os.path.join(root, name)
    if os.path.isdir(source):
        shutil.copytree(source, path)
    else:
        shutil.copyfile(source, path)
    fmt = checkpoint_format(path)
    flags = flags_from_argv(argv + [
        "-log_path", root, "-experiment_name", name, "-checkpoint", path,
        "-max_epoch", str(epochs)])
    want = cadence_counts(flags, inputs[2].size, inputs[3].size, start)
    summary, secs, counts = run_counted(flags, inputs, device)
    got, losses, last_dev, _ = read_log(flags, summary)
    got.update(counts)
    with open(flags.log_file) as f:
        text = f.read()
    last_save = max(t for t in range(start, want["steps"])
                    if t >= flags.save_after
                    and t % flags.save_interval == 0)
    row = {"phase": phase, "resumed_from": fmt, **got,
           "expected": want, "step_graph": "Step: graph" in text,
           "adopted_lines": [line for line in ADOPTED.values()
                             if line in text],
           "written_format": checkpoint_format(path),
           "written_step": read_checkpoint(path)["data"]["step"],
           "last_dev_top6": last_dev, "seconds": secs,
           "checkpoint_s": summary["seconds"]["checkpoints"], "card": smi}
    log(row)
    check_counts(phase, got, want, losses)
    adopted = [ADOPTED[fmt]] if fmt in ADOPTED else []
    if not row["step_graph"] or row["adopted_lines"] != adopted:
        raise SystemExit(f"{phase}: the {fmt} resume's log lacks "
                         "Step: graph or names the wrong format")
    if row["written_format"] != fmt or row["written_step"] != last_save:
        raise SystemExit(f"{phase}: the {fmt} resume wrote "
                         f"{row['written_format']} at step "
                         f"{row['written_step']}, not {fmt} at {last_save}")
    if min_top6 is not None and last_dev < min_top6:
        raise SystemExit(f"{phase}: the {fmt} resume's dev top-6 "
                         f"{last_dev} is below {min_top6}")
    return dict(row, flags=flags, summary=summary)


def tree_digest(root) -> str:
    """A digest of every file under ``root``, names and bytes."""
    import hashlib
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            h.update(os.path.relpath(os.path.join(d, name), root).encode())
            with open(os.path.join(d, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def fixture_inputs(device):
    """In-memory sets of the fixture game's shapes: 6 classes, 8 train
    and 4 dev examples a class of 24 features, 16-wide descriptions."""
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    rng = np.random.RandomState(11)
    proto = rng.randn(FIXTURE_CLASSES, FIXTURE_FEAT)
    sets = []
    for per_class in (8, 4):
        labels = np.repeat(np.arange(FIXTURE_CLASSES), per_class)
        feats = np.abs(proto[labels] + 0.3 * rng.randn(len(labels),
                                                       FIXTURE_FEAT))
        sets.append(DeviceDataset(feats.astype(np.float32), labels,
                                  device=device))
    desc = rng.randn(FIXTURE_CLASSES, FIXTURE_WV).astype(np.float32)
    pack = DescriptionPack(desc, desc, [1] * FIXTURE_CLASSES,
                           {i: i for i in range(FIXTURE_CLASSES)},
                           {i: f"class{i}" for i in range(FIXTURE_CLASSES)})
    return pack, pack, sets[0], sets[1]


def same_state(a, b) -> bool:
    """Two resumed runs' weights and optimizer slots, bit for bit."""
    import torch
    sa, sb = a["modules"].state_dict(), b["modules"].state_dict()
    if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k])
                                         for k in sa):
        return False
    for agent, slots in a["opt_states"].items():
        for k, v in slots.items():
            w = b["opt_states"][agent][k]
            if isinstance(v, list):
                if not all(torch.equal(x, y) for x, y in zip(v, w)):
                    return False
            elif int(v) != int(w):
                return False
    return True


def ckpt_orbax(device, workdir, smi):
    """The JAX package's Orbax checkpoint directories on the card, read
    and written by the port's own OCDBT, zarr and zstd codecs:
    ``train.run -ckpt_format orbax`` at the canonical width on the graph
    route; resumes from its directory and from the JAX fixture, each
    bit-equal to a resume from the msgpack file of the same state;
    ``-eval_only`` on its ``_best``; ``Predictor.from_checkpoint`` on a
    directory; a malformed directory refused; and the write (to return,
    to commit) and read ms against msgpack."""
    import shutil
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.game.config import GameConfig
    from multimodalgame_tpu_torch.game.train import init_opt_states
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.serve import Predictor
    from multimodalgame_tpu_torch.train import run
    from multimodalgame_tpu_torch.utils import ocdbt, zstd
    from multimodalgame_tpu_torch.utils.checkpoint import (
        checkpoint_tree, load_agents, load_checkpoint, save_checkpoint,
        wait_for_checkpoints)

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else [v]

    root = os.path.join(workdir, "ckpt_orbax")
    os.makedirs(root)
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    dev = DeviceDataset(*synthetic_set(DEV_PER_CLASS, seed=2), device=device)
    pack = description_pack()
    inputs = (pack, pack, train, dev)
    launches = {"train": 0, "eval": 0}

    def count(row):
        launches["train"] += row["train_launches"]
        launches["eval"] += row["eval_launches"]

    # 1: the canonical game trained with -ckpt_format orbax, counted.
    flags = flags_from_argv(DEMO_ARGV + [
        "-log_path", root, "-experiment_name", "orbax", "-ckpt_format",
        "orbax", "-max_epoch", str(CKPT_EPOCHS)])
    want = cadence_counts(flags, train.size, dev.size)
    summary, secs, counts = run_counted(flags, inputs, device)
    got, losses, last_dev, _ = read_log(flags, summary)
    got.update(counts)
    count(got)
    with open(flags.log_file) as f:
        step_graph = "Step: graph" in f.read()
    leftovers = [p for p in os.listdir(root)
                 if p.endswith((".staging", ".old")) or ".orbax-" in p]
    log({"phase": "ckpt_orbax", **got, "expected": want,
         "step_graph": step_graph, "last_dev_top6": last_dev,
         "seconds": secs, "checkpoint_s": summary["seconds"]["checkpoints"],
         "leftovers": leftovers, "card": smi})
    check_counts("ckpt_orbax", got, want, losses)
    if not step_graph or leftovers:
        raise SystemExit(f"ckpt_orbax: Step: graph {step_graph}, "
                         f"leftovers {leftovers}")
    # 2: both directories reload; -eval_only on _best reproduces it.
    best = check_reloads("ckpt_orbax", flags, device, fmt="orbax")
    check_eval_only("ckpt_orbax", flags, inputs, device, best)

    # 3: resumed from its periodic directory and from a msgpack file of
    # the same state: the same weights and slots, bit for bit.
    cfg = GameConfig.from_flags(flags)
    mods = AgentModules(cfg).to(device)
    opts = init_opt_states(cfg, mods)
    data = load_checkpoint(flags.checkpoint, mods, opts)
    as_msgpack = os.path.join(root, "periodic.msgpack")
    save_checkpoint(as_msgpack, data, mods, opts)
    rows = {fmt: resume_counted(f"own_{fmt}", src, root, inputs, device,
                                smi, data["step"], phase="ckpt_orbax",
                                epochs=ORBAX_RESUME_EPOCHS, min_top6=None)
            for fmt, src in (("orbax", flags.checkpoint),
                             ("msgpack", as_msgpack))}
    own_equal = same_state(rows["orbax"]["summary"],
                           rows["msgpack"]["summary"])
    for r in rows.values():
        count(r)

    # 4: the JAX fixture resumed, and a msgpack file of its state.
    small = fixture_inputs(device)
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           FIXTURE_DIR)
    fcfg = GameConfig.from_flags(flags_from_argv(FIXTURE_ARGV))
    fmods = AgentModules(fcfg).to(device)
    fopts = init_opt_states(fcfg, fmods)
    fdata = load_checkpoint(fixture, fmods, fopts)
    fixture_msgpack = os.path.join(root, "fixture.msgpack")
    save_checkpoint(fixture_msgpack, fdata, fmods, fopts)
    frows = {fmt: resume_counted(f"fixture_{fmt}", src, root, small,
                                 device, smi, fdata["step"],
                                 phase="ckpt_orbax", argv=FIXTURE_ARGV,
                                 epochs=ORBAX_RESUME_EPOCHS, min_top6=None)
             for fmt, src in (("orbax", fixture), ("msgpack",
                                                   fixture_msgpack))}
    fixture_equal = same_state(frows["orbax"]["summary"],
                               frows["msgpack"]["summary"])
    for r in frows.values():
        count(r)
    log({"phase": "ckpt_orbax", "fixture_step": fdata["step"],
         "own_resumes_bit_equal": own_equal,
         "fixture_resumes_bit_equal": fixture_equal})
    if not (own_equal and fixture_equal):
        raise SystemExit("ckpt_orbax: a resume from an Orbax directory "
                         "differs from the msgpack resume of its state")

    # 5: Predictor on a directory and on a msgpack file of its modules.
    served = rows["orbax"]["flags"].checkpoint
    sdata, smods = load_agents(served, cfg)
    served_msgpack = os.path.join(root, "served.msgpack")
    save_checkpoint(served_msgpack, sdata, smods,
                    init_opt_states(cfg, smods))
    preds = {}
    for fmt, path in (("orbax", served), ("msgpack", served_msgpack)):
        pflags = flags_from_argv(DEMO_ARGV + ["-log_path", root,
                                              "-checkpoint", path])
        preds[fmt] = Predictor.from_checkpoint(pflags, pack, device=device)
    requests = [features(b, seed=400 + b) for b in (1, 64)]
    fused_eval_exchange.launches = 0
    outs = {fmt: [p.predict(x) for x in requests]
            for fmt, p in preds.items()}
    torch.cuda.synchronize()
    serve_launches = fused_eval_exchange.launches
    launches["eval"] += serve_launches
    keys = ("prediction", "log_probs", "sender_messages",
            "receiver_messages", "conversation_length")
    served_equal = all(
        m["n_steps"] == p["n_steps"]
        and all(np.array_equal(m[k], p[k]) for k in keys)
        for m, p in zip(outs["orbax"], outs["msgpack"]))
    log({"phase": "ckpt_orbax", "served_step": sdata["step"],
         "requests": [len(x) for x in requests],
         "eval_kernel_launches": serve_launches,
         "orbax_and_msgpack_predictors_bit_equal": served_equal})
    if serve_launches != 2 * len(requests) or not served_equal:
        raise SystemExit("ckpt_orbax: the two Predictors differ or "
                         f"launched {serve_launches} times")

    # 6: a malformed directory (its B-tree node cut short) is refused,
    # naming it, with no kernel launched and the directory unchanged.
    bad = os.path.join(root, "malformed")
    shutil.copytree(flags.checkpoint + "_best", bad)
    node_dir = os.path.join(bad, "d")
    node = os.path.join(node_dir, os.listdir(node_dir)[0])
    with open(node, "rb") as f:
        blob = f.read()
    with open(node, "wb") as f:
        f.write(blob[:-5])
    before = tree_digest(bad)
    bflags = flags_from_argv(DEMO_ARGV + [
        "-log_path", os.path.join(root, "malformed_run"), "-checkpoint",
        bad])
    fused_train_forward.launches = fused_eval_exchange.launches = 0
    try:
        run(bflags, device=device, inputs=inputs)
    except ValueError as e:
        refusal = str(e)
    else:
        raise SystemExit("ckpt_orbax: a malformed directory was accepted")
    untouched = (fused_train_forward.launches == 0
                 and fused_eval_exchange.launches == 0
                 and tree_digest(bad) == before)
    log({"phase": "ckpt_orbax", "malformed_refused": refusal,
         "no_launch_and_directory_unchanged": untouched})
    if not untouched or bad not in refusal:
        raise SystemExit("ckpt_orbax: the malformed directory's refusal "
                         "launched a kernel, changed it or did not name it")

    # 7: write (to return, to commit) and read ms, Orbax and msgpack in
    # turns; the pure-Python zstd decoder's rate on the fixture's chunks
    # and on a weight matrix's frame of one compressed block.
    ms = {"orbax": {"return": [], "commit": [], "read": []},
          "msgpack": {"write": [], "read": []}}
    back = AgentModules(cfg).to(device)
    back_opts = init_opt_states(cfg, back)
    for rep in range(ORBAX_REPS):
        for fmt in (("orbax", "msgpack") if rep % 2 == 0
                    else ("msgpack", "orbax")):
            path = os.path.join(root, "timed." + fmt)
            t0 = time.perf_counter()
            save_checkpoint(path, data, mods, opts, fmt=fmt)
            t1 = time.perf_counter()
            wait_for_checkpoints()
            t2 = time.perf_counter()
            load_checkpoint(path, back, back_opts)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if fmt == "orbax":
                ms[fmt]["return"].append((t1 - t0) * 1e3)
                ms[fmt]["commit"].append((t2 - t0) * 1e3)
            else:
                ms[fmt]["write"].append((t1 - t0) * 1e3)
            ms[fmt]["read"].append((t3 - t2) * 1e3)
    sizes = {fmt: sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(os.path.join(root, "timed."
                                                           + fmt))
                      for f in fs)
             if fmt == "orbax" else
             os.path.getsize(os.path.join(root, "timed." + fmt))
             for fmt in ms}
    timing = {fmt: dict({f"{k}_ms": statistics.median(v)
                         for k, v in rows_.items()},
                        bytes=sizes[fmt],
                        **{f"{k}_ms_all": v for k, v in rows_.items()})
              for fmt, rows_ in ms.items()}
    frames = [v for k, v in ocdbt.read_store(fixture).items()
              if not k.endswith(b".zarray")]
    with open(os.path.join(os.path.dirname(fixture),
                           "zstd_weights_level1.zst"), "rb") as f:
        frames.append(f.read())
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        decoded = sum(len(zstd.decompress(f)) for f in frames)
        rates.append(decoded / (time.perf_counter() - t0) / 1e6)
    rate = statistics.median(rates)
    array_bytes = sum(leaf.nbytes for leaf in leaves(checkpoint_tree(
        data, mods, opts)))
    log({"phase": "ckpt_orbax", "timing": timing, "reps": ORBAX_REPS,
         "zstd_decode": {"frames": len(frames),
                         "compressed_bytes": sum(map(len, frames)),
                         "decoded_bytes": decoded,
                         "decoded_mb_per_s": rate,
                         "decoded_mb_per_s_all": rates},
         "canonical_array_bytes": array_bytes,
         "canonical_decode_s_at_that_rate": array_bytes / 1e6 / rate,
         "driver_checkpoint_s": summary["seconds"]["checkpoints"],
         "card": smi})
    return {"train_launches": launches["train"],
            "eval_launches": launches["eval"], "timing": timing,
            "decoded_mb_per_s": rate,
            "resumes_bit_equal": own_equal and fixture_equal}


def ckpt_msgpack(device, workdir, smi, driven):
    """The JAX package's msgpack checkpoint on the card: the driver
    resumed from the ``driver`` phase's msgpack ``_best`` and from a
    ``.pt`` of the same state (each keeps its format), ``Predictor`` on a
    msgpack file against one on a ``.pt`` of the same modules, and each
    format's bytes and write and read ms. (The Orbax directory, refused
    here before it was ported, is ``ckpt_orbax``'s.)"""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.game.config import GameConfig
    from multimodalgame_tpu_torch.game.train import init_opt_states
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange)
    from multimodalgame_tpu_torch.serve import Predictor
    from multimodalgame_tpu_torch.utils.checkpoint import (
        checkpoint_format, load_agents, load_checkpoint, save_checkpoint)
    from multimodalgame_tpu_torch.utils.torch_interop import (
        save_reference_checkpoint)

    best = driven["flags"].checkpoint + "_best"
    if checkpoint_format(best) != "msgpack":
        raise SystemExit(f"ckpt_msgpack: {best} is not a msgpack file")
    root = os.path.join(workdir, "ckpt")
    os.makedirs(root)
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    dev = DeviceDataset(*synthetic_set(DEV_PER_CLASS, seed=2), device=device)
    pack = description_pack()
    inputs = (pack, pack, train, dev)
    cfg = GameConfig.from_flags(driven["flags"])
    mods = AgentModules(cfg).to(device)
    opts = init_opt_states(cfg, mods)
    data = load_checkpoint(best, mods, opts)
    as_pt = os.path.join(root, "best.pt")
    save_checkpoint(as_pt, data, mods, opts, fmt="pt")

    # 1 and 3: resumed from the msgpack _best, then from its .pt.
    rows = {fmt: resume_counted("from_" + fmt, src, root, inputs, device,
                                smi, data["step"])
            for fmt, src in (("msgpack", best), ("pt", as_pt))}
    a, b = (r["summary"]["modules"].state_dict() for r in rows.values())
    same_weights = all(torch.equal(a[k], b[k]) for k in a)

    # 2: Predictor on the resumed msgpack file and on a .pt of its modules.
    served = rows["msgpack"]["flags"].checkpoint
    sdata, smods = load_agents(served, cfg)
    served_pt = os.path.join(root, "served.pt")
    save_reference_checkpoint(served_pt, sdata, smods)
    preds = {}
    for fmt, path in (("msgpack", served), ("pt", served_pt)):
        flags = flags_from_argv(DEMO_ARGV + ["-log_path", root,
                                             "-checkpoint", path])
        preds[fmt] = Predictor.from_checkpoint(flags, pack, device=device)
    requests = [features(b, seed=300 + b) for b in (1, 64)]
    fused_eval_exchange.launches = 0
    outs = {fmt: [p.predict(x) for x in requests]
            for fmt, p in preds.items()}
    torch.cuda.synchronize()
    serve_launches = fused_eval_exchange.launches
    keys = ("prediction", "log_probs", "sender_messages",
            "receiver_messages", "conversation_length")
    served_equal = all(
        m["n_steps"] == p["n_steps"]
        and all(np.array_equal(m[k], p[k]) for k in keys)
        for m, p in zip(outs["msgpack"], outs["pt"]))
    log({"phase": "ckpt_msgpack", "served_step": sdata["step"],
         "requests": [len(x) for x in requests],
         "eval_kernel_launches": serve_launches,
         "msgpack_and_pt_predictors_bit_equal": served_equal,
         "card": smi})
    if serve_launches != 2 * len(requests) or not served_equal:
        raise SystemExit("ckpt_msgpack: the two Predictors differ or "
                         f"launched {serve_launches} times")

    # 4: bytes and write/read ms of each format, in turns.
    ms = {fmt: {"write": [], "read": []} for fmt in ("msgpack", "pt")}
    back = AgentModules(cfg).to(device)
    back_opts = init_opt_states(cfg, back)
    for rep in range(CKPT_REPS):
        for fmt in (("msgpack", "pt") if rep % 2 == 0 else ("pt", "msgpack")):
            path = os.path.join(root, "timed." + fmt)
            t0 = time.perf_counter()
            save_checkpoint(path, data, mods, opts, fmt=fmt)
            t1 = time.perf_counter()
            load_checkpoint(path, back, back_opts)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ms[fmt]["write"].append((t1 - t0) * 1e3)
            ms[fmt]["read"].append((t2 - t1) * 1e3)
    sizes = {fmt: os.path.getsize(os.path.join(root, "timed." + fmt))
             for fmt in ms}
    timing = {fmt: {"bytes": sizes[fmt],
                    "write_ms": statistics.median(v["write"]),
                    "read_ms": statistics.median(v["read"]),
                    "write_ms_all": v["write"], "read_ms_all": v["read"]}
              for fmt, v in ms.items()}
    log({"phase": "ckpt_msgpack", "timing": timing,
         "msgpack_over_pt_bytes": sizes["msgpack"] / sizes["pt"],
         "reps": CKPT_REPS, "driver_checkpoint_s": driven["checkpoint_s"],
         "pt_and_msgpack_resumes_bit_equal": same_weights, "card": smi})
    return {"train_launches": sum(r["train_launches"]
                                  for r in rows.values()),
            "eval_launches": sum(r["eval_launches"] for r in rows.values())
            + serve_launches,
            "timing": timing, "resumes_bit_equal": same_weights}


def drive_attention(device, workdir, smi):
    """AdaptiveAttention through ``train.run`` at full width on in-memory
    ``layer4_2`` maps and ``fc`` contexts; neither kernel may launch."""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset

    flags = flags_from_argv(ATTENTION_ARGV + [
        "-log_path", os.path.join(workdir, "attention")])
    t0 = time.perf_counter()
    maps, fc, labels = attention_set(TRAIN_PER_CLASS, seed=1)
    train = DeviceDataset(maps, labels, fc, device=device)
    maps, fc, labels = attention_set(DEV_PER_CLASS, seed=2)
    dev = DeviceDataset(maps, labels, fc, device=device)
    del maps, fc
    set_up = time.perf_counter() - t0
    pack = description_pack()
    inputs = (pack, pack, train, dev)
    want = dict(cadence_counts(flags, train.size, dev.size),
                train_launches=0, eval_launches=0)

    summary, secs, counts = run_counted(flags, inputs, device)
    got, losses, last_dev, timing = read_log(flags, summary)
    got.update(counts)
    log({"phase": "driver_attention", **got, "expected": want,
         "feats": list(train.feats.shape), "context": list(
             train.context.shape), "data_set_up_s": set_up,
         "finite_losses": len(losses), "last_dev_top6": last_dev,
         "best_dev_acc": summary["best_dev_acc"],
         "dev_curve": summary["metrics"].get("Development Accuracy"),
         "conversation_length_curve": summary["metrics"].get(
             "Conversation Length (avg)"),
         "seconds": secs, "last_epoch_steps_per_s": timing["steps_per_sec"],
         "card": smi})
    check_counts("driver_attention", got, want, losses)
    if last_dev < MIN_DEV_TOP6:
        raise SystemExit(f"driver_attention: dev top-6 {last_dev} is below "
                         f"{MIN_DEV_TOP6}")
    best = check_reloads("driver_attention", flags, device)
    check_eval_only("driver_attention", flags, inputs, device, best)
    log_time_split("driver_attention", want["steps"], secs,
                   summary["seconds"], smi)
    return {"flags": flags, "train": train, "dev": dev, "counts": counts,
            "desc": torch.from_numpy(descriptions()).to(device),
            "summary": summary, "run_steps_per_s": want["steps"] / secs,
            "last_dev_top6": last_dev}


def serve_attention(device, attention):
    """The attention game's _best served on the card and on the CPU."""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        compare_outputs, fused_eval_exchange)
    from multimodalgame_tpu_torch.serve import Predictor
    flags = flags_from_argv(["-log_load", attention["flags"].json_file,
                             "-checkpoint",
                             attention["flags"].checkpoint + "_best"])
    pack = description_pack()
    pred = Predictor.from_checkpoint(flags, pack, device=device)
    plain = Predictor.from_checkpoint(flags, pack, device="cpu")
    dev = attention["dev"]
    ties, worst, launches = 0, 0.0, 0
    for batch in TIMED_BATCHES:
        rows = torch.arange(batch, device=device) * (dev.size // batch)
        x = dev.feats[rows].cpu().numpy()
        ctx = dev.context[rows].cpu().numpy()
        fused_eval_exchange.launches = 0
        out = pred.predict(x, data_context=ctx)
        torch.cuda.synchronize()
        launches += fused_eval_exchange.launches
        ref = plain.predict(x, data_context=ctx)
        with torch.inference_mode():
            got = pred._exchange(
                torch.from_numpy(x).to(device), pred._desc,
                data_context=torch.from_numpy(ctx).to(device))
            want = plain._exchange(torch.from_numpy(x), plain._desc,
                                   data_context=torch.from_numpy(ctx))
        rep = compare_outputs(pred.cfg, got, want)
        log({"phase": "serve_attention", "batch": batch,
             "n_steps": out["n_steps"],
             "equal_predictions": bool(np.array_equal(out["prediction"],
                                                      ref["prediction"])),
             "mean_conversation_length":
                 float(out["conversation_length"].mean()),
             "attn_scores": list(got.attn_scores.shape), **rep})
        if not rep["ok"] or not np.isfinite(out["log_probs"]).all():
            raise SystemExit(f"serve_attention: batch {batch} on the card "
                             f"differs from the CPU: {rep}")
        ties += rep["tie_rows"]
        worst = max(worst, rep["max_abs_err"])
    if launches:
        raise SystemExit(f"serve_attention: {launches} kernel launches")
    return {"launches": launches, "tie_rows": ties, "max_abs_err": worst}


def drive_variants(device, workdir, smi):
    """-desc_attn, mou, mou + ignore_code and -flipout_dev through
    ``train.run`` for 2 epochs each at the canonical width."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    dev = DeviceDataset(*synthetic_set(DEV_PER_CLASS, seed=2), device=device)
    totals = {"train_launches": 0, "eval_launches": 0}
    rows = {}
    for name, extra in VARIANT_ARGV.items():
        flags = flags_from_argv(DEMO_ARGV + extra + [
            "-max_epoch", str(VARIANT_EPOCHS), "-experiment_name", name,
            "-log_path", os.path.join(workdir, "variants")])
        pack = word_pack() if flags.desc_attn else description_pack()
        want = dict(cadence_counts(flags, train.size, dev.size),
                    train_launches=0, eval_launches=0)
        summary, secs, counts = run_counted(flags, (pack, pack, train, dev),
                                            device)
        got, losses, last_dev, _ = read_log(flags, summary)
        got.update(counts)
        for k in totals:
            totals[k] += counts[k]
        rows[name] = {"steps_per_s": got["steps"] / secs,
                      "last_dev_top6": last_dev}
        log({"phase": "variants", "variant": name, **got, "expected": want,
             "finite_losses": len(losses), "last_dev_top6": last_dev,
             "seconds": secs, "steps_per_s": got["steps"] / secs,
             "word_set_sizes": ([min(pack.desc_set_lens),
                                 max(pack.desc_set_lens)]
                                if flags.desc_attn else None),
             "card": smi})
        check_counts(f"variants {name}", got, want, losses)
    return {**totals, "rows": rows}


def cifar_pixels(n: int, seed: int, device):
    """``n`` class-conditional uint8 images ``(3, 227, 227)`` made on the
    card: a prototype per class (``Generator(1234)``) plus uniform noise
    in [-48, 48] from ``Generator(seed)``, clamped; labels cycle over the
    10 classes. Returns ``(pixels (n, 3, 227, 227) uint8, labels (n,))``."""
    import torch
    shape = (3, CIFAR_SIZE, CIFAR_SIZE)
    proto = torch.randint(0, 256, (CIFAR_CLASSES,) + shape, device=device,
                          dtype=torch.int16, generator=torch.Generator(
                              device=device).manual_seed(1234))
    gen = torch.Generator(device=device).manual_seed(seed)
    labels = np.arange(n) % CIFAR_CLASSES
    lab = torch.from_numpy(labels).to(device)
    out = torch.empty((n,) + shape, dtype=torch.uint8, device=device)
    for s0 in range(0, n, 1000):
        m = min(1000, n - s0)
        noise = torch.randint(-48, 49, (m,) + shape, device=device,
                              dtype=torch.int16, generator=gen)
        out[s0:s0 + m] = (proto[lab[s0:s0 + m]] + noise).clamp_(
            0, 255).to(torch.uint8)
    return out, labels


def cifar_pack():
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    desc = np.random.RandomState(9).randn(CIFAR_CLASSES, 100).astype(
        np.float32)
    return DescriptionPack(desc, desc, [1] * CIFAR_CLASSES,
                           {i: i for i in range(CIFAR_CLASSES)},
                           {i: f"class{i}" for i in range(CIFAR_CLASSES)})


def check_cifar_kernels(device, smi):
    """Both kernels at the CIFAR width (F = 154,587 flat pixels), at the
    driver's batch and the dev batch, against their plain versions; then
    their times at batch 64 beside the bound."""
    import torch
    from multimodalgame_tpu_torch.data.cifar import normalize
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        compare_outputs, fused_eval_exchange, fused_eval_exchange_reference,
        fused_train_forward, fused_train_forward_reference, kernel_params)
    from multimodalgame_tpu_torch.ops.philox import philox_uniforms
    cfg = canonical_cfg(**TRAIN_HP, img_feat_dim=CIFAR_FEAT)
    params = kernel_params(make_agents(cfg, device))
    desc = torch.from_numpy(cifar_pack().desc).to(device)
    worst = {"max_abs_err": 0.0, "tie_rows": 0, "cases": 0}
    for batch in (TRAIN_BATCH, 100):
        pixels, _ = cifar_pixels(batch, seed=40 + batch, device=device)
        data = normalize(pixels).reshape(batch, -1).contiguous()
        u = philox_uniforms(cfg, batch, seed=batch, step=3, device=device)
        with torch.inference_mode():
            runs = {
                "fused_eval_exchange": (
                    fused_eval_exchange(cfg, params, data, desc),
                    fused_eval_exchange_reference(cfg, params, data, desc),
                    None),
                "fused_train_forward": (
                    fused_train_forward(cfg, params, data, desc, seed=batch,
                                        step=3),
                    fused_train_forward_reference(cfg, params, data, desc,
                                                  u), u)}
        torch.cuda.synchronize()
        for name, (got, want, uu) in runs.items():
            rep = compare_outputs(cfg, got, want, uniforms=uu)
            log({"phase": "kernels_cifar", "kernel": name, "batch": batch,
                 "feat": CIFAR_FEAT, "classes": CIFAR_CLASSES, **rep})
            if not rep["ok"]:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at F = {CIFAR_FEAT}, batch {batch}")
            worst["max_abs_err"] = max(worst["max_abs_err"],
                                       rep["max_abs_err"])
            worst["tie_rows"] += rep["tie_rows"]
            worst["cases"] += 1
    pixels, _ = cifar_pixels(TRAIN_BATCH, seed=564, device=device)
    data = normalize(pixels).reshape(TRAIN_BATCH, -1).contiguous()
    u = philox_uniforms(cfg, TRAIN_BATCH, 0, 1, device=device)
    rows = {}
    with torch.inference_mode():
        for name, fn, ref in (
                ("fused_eval_exchange",
                 lambda: fused_eval_exchange(cfg, params, data, desc),
                 lambda: fused_eval_exchange_reference(cfg, params, data,
                                                       desc)),
                ("fused_train_forward",
                 lambda: fused_train_forward(cfg, params, data, desc,
                                             seed=0, step=1),
                 lambda: fused_train_forward_reference(cfg, params, data,
                                                       desc, u))):
            rows[name] = {"feat": CIFAR_FEAT, "batch": TRAIN_BATCH,
                          "ms": event_median_ms(fn),
                          "device_ms": device_median_ms(fn),
                          "plain_ms": event_median_ms(ref),
                          **work(cfg, TRAIN_BATCH,
                                 num_desc=CIFAR_CLASSES)}
            rows[name]["device_over_bound"] = (rows[name]["device_ms"]
                                               / rows[name]["bound_ms"])
            log({"phase": "timing", "kernel": name, **rows[name],
                 "card": smi})
    log({"phase": "kernels_cifar", **worst})
    return {"worst": worst, "rows": rows}


def canonical_inputs(device, pack=None):
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    dev = DeviceDataset(*synthetic_set(DEV_PER_CLASS, seed=2), device=device)
    pack = pack or description_pack()
    return (pack, pack, train, dev)


def drive_bf16(device, workdir, smi):
    """``-compute_dtype bfloat16`` through ``train.run`` for 2 epochs: the
    plain sampler (no train launch), the eval kernel at the cadences, and
    float32 parameters and optimizer slots afterwards."""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    flags = flags_from_argv(DEMO_ARGV + BF16_ARGV + [
        "-log_path", os.path.join(workdir, "bf16")])
    inputs = canonical_inputs(device)
    want = dict(cadence_counts(flags, inputs[2].size, inputs[3].size),
                train_launches=0)
    summary, secs, counts = run_counted(flags, inputs, device)
    got, losses, last_dev, _ = read_log(flags, summary)
    got.update(counts)
    dtypes = {str(p.dtype) for p in summary["modules"].parameters()}
    dtypes |= {str(t.dtype) for st in summary["opt_states"].values()
               for v in st.values() if isinstance(v, list) for t in v}
    log({"phase": "bf16", **got, "expected": want,
         "finite_losses": len(losses), "last_dev_top6": last_dev,
         "parameter_and_slot_dtypes": sorted(dtypes), "seconds": secs,
         "run_steps_per_s": got["steps"] / secs, "card": smi})
    check_counts("bf16", got, want, losses)
    if dtypes != {str(torch.float32)}:
        raise SystemExit(f"bf16: parameters or slots are {dtypes}")
    return {**counts, "run_steps_per_s": got["steps"] / secs}


def drive_cifar(device, workdir, smi):
    """``-images cifar`` through ``train.run`` for 1 epoch on 10,000 staged
    uint8 images of 3 x 227 x 227 (flat features, F = 154,587) in 10
    classes, with a dev set of the same width in memory."""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.cifar import normalize
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    t0 = time.perf_counter()
    pixels, labels = cifar_pixels(CIFAR_IMAGES, seed=1, device=device)
    train = DeviceDataset(pixels, labels, device=device)
    dev_px, dev_labels = cifar_pixels(CIFAR_DEV, seed=2, device=device)
    dev = DeviceDataset(normalize(dev_px).reshape(CIFAR_DEV, -1),
                        dev_labels, device=device)
    del pixels, dev_px
    torch.cuda.synchronize()
    set_up = time.perf_counter() - t0
    flags = flags_from_argv(DEMO_ARGV + CIFAR_ARGV + [
        "-log_path", os.path.join(workdir, "cifar")])
    pack = cifar_pack()
    want = cadence_counts(flags, train.size, dev.size)
    summary, secs, counts = run_counted(flags, (pack, pack, train, dev),
                                        device)
    got, losses, last_dev, timing = read_log(flags, summary)
    got.update(counts)
    log({"phase": "cifar", **got, "expected": want,
         "feats": list(train.feats.shape), "feats_dtype": str(
             train.feats.dtype), "staged_bytes": train.feats.numel(),
         "dev_feats": list(dev.feats.shape), "data_set_up_s": set_up,
         "finite_losses": len(losses), "last_dev_top6": last_dev,
         "seconds": secs, "run_steps_per_s": got["steps"] / secs,
         "last_epoch_steps_per_s": timing["steps_per_sec"], "card": smi})
    check_counts("cifar", got, want, losses)
    del train, dev, summary
    torch.cuda.empty_cache()
    return {**counts, "run_steps_per_s": got["steps"] / secs}


def check_population(device, smi, dtype_name: str):
    """One population step of four canonical members on the card against
    four single-game steps with the same weights and uniforms (the plain
    sampler): phase A's bits and the accuracies equal; in float64 each
    member's change of weights within 1e-9 of its single step's and the
    losses within 1e-5; in float32 the weights within 5e-3 and the losses
    within a relative 1e-6 (batched and looped products round
    differently)."""
    import torch
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.game.fast_train import sample_conversation
    from multimodalgame_tpu_torch.game.train import (init_opt_states,
                                                     make_train_step_indexed)
    from multimodalgame_tpu_torch.ops.philox import member_uniforms
    from multimodalgame_tpu_torch.parallel.population import (
        init_population, init_population_opt_states,
        make_population_train_step, member_modules, member_params)
    dtype = getattr(torch, dtype_name)
    cfg = canonical_cfg(**TRAIN_HP)
    n = POPULATION_MEMBERS
    _, _, train, _ = canonical_inputs(device)
    feats = train.feats.to(dtype)
    desc = torch.from_numpy(descriptions()).to(device, dtype)
    pop = {k: v.to(dtype) for k, v in
           init_population(cfg, 0, n, device).items()}
    start = {k: v.clone() for k, v in pop.items()}
    modules = AgentModules(cfg).to(device, dtype)
    idx = train.epoch_indices(0, True, TRAIN_BATCH)[:1]
    u = member_uniforms(cfg, TRAIN_BATCH, 1, 0, n, device)
    data = feats[torch.as_tensor(idx[0], device=device)]

    def member_bits(params, uu):
        return torch.func.functional_call(
            modules, params, (sample_conversation, data, desc, "plain",
                              uu))[:3]

    bits = torch.func.vmap(member_bits)(pop, u)
    chunk = make_population_train_step(modules, 6, TRAIN_BATCH,
                                       uniforms=lambda step: u)
    new_pop, _, pm = chunk(pop, init_population_opt_states(cfg, pop),
                           feats, train.targets, idx, desc, 0)
    f64 = dtype == torch.float64
    worst = {"loss": 0.0, "loss_rel": 0.0, "param": 0.0, "delta": 0.0}
    for i in range(n):
        mods = member_modules(cfg, pop, i)
        step = make_train_step_indexed(
            mods, 6, TRAIN_BATCH, fast=True, device=device,
            uniforms=lambda s, i=i: {k: v[i] for k, v in u.items()})
        m = step(init_opt_states(cfg, mods), feats, train.targets, idx[0],
                 desc, 0)
        ex = m.exchange
        same_bits = all(torch.equal(a[i], b) for a, b in zip(
            bits, (ex.sen_feats, ex.rec_feats, ex.stop_feats)))
        same_acc = float(m.accuracy) == float(pm.accuracy[0, i])
        losses = {k: (float(getattr(m, k)), float(getattr(pm, k)[0, i]))
                  for k in ("loss_rec", "loss_sen", "nll_loss",
                            "loss_bas_rec", "loss_bas_sen")}
        loss_err = max(abs(a - b) for a, b in losses.values())
        loss_rel = max(abs(a - b) / max(abs(a), abs(b))
                       for a, b in losses.values() if a != b) \
            if loss_err else 0.0
        got, was = member_params(new_pop, i), member_params(start, i)
        param_err = max(float((p.detach() - got[k]).abs().max())
                        for k, p in mods.named_parameters())
        delta_err = max(float(((got[k] - was[k])
                               - (p.detach() - was[k])).abs().max())
                        for k, p in mods.named_parameters())
        moved = max(float((got[k] - was[k]).abs().max())
                    for k, _ in mods.named_parameters())
        for key, val in (("loss", loss_err), ("loss_rel", loss_rel),
                         ("param", param_err), ("delta", delta_err)):
            worst[key] = max(worst[key], val)
        log({"phase": "population", "dtype": dtype_name, "member": i,
             "bits_equal": same_bits, "accuracy_equal": same_acc,
             "max_loss_err": loss_err, "max_loss_rel_err": loss_rel,
             "max_param_err": param_err, "max_delta_err": delta_err,
             "max_change": moved,
             "losses_single_population": losses})
        close = (loss_err <= POPULATION_LOSS_ATOL
                 and delta_err <= POPULATION_DELTA_ATOL) if f64 else (
            loss_rel <= POPULATION_LOSS_RTOL
            and param_err <= POPULATION_PARAM_ATOL)
        if not (same_bits and same_acc and close and moved > 0):
            raise SystemExit(f"population: member {i} differs from its "
                             f"single-game step in {dtype_name}")
    log({"phase": "population", "dtype": dtype_name, "members": n,
         "max_loss_err": worst["loss"], "max_loss_rel_err": worst["loss_rel"],
         "max_param_err": worst["param"], "max_delta_err": worst["delta"],
         "card": smi})
    return worst


def population_timing(device, smi, n: int = 16):
    """The canonical population step of ``n`` members at batch 64, one
    step a chunk, on the graph route against the eager step in turns
    (eager, graph, graph, eager): host-clock median ms (steps that each
    end in a synchronize), game-steps/s, and the device's kernels a step,
    busy share and the host's launch calls a step over a few profiled
    steps; beside it one single-game step on the same plain sampler."""
    import torch
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.game.train import (
        init_opt_states, make_multistep_train_step_indexed)
    from multimodalgame_tpu_torch.parallel.population import (
        init_population, init_population_opt_states,
        make_population_train_step, member_modules)
    cfg = canonical_cfg(**TRAIN_HP)
    _, _, train, _ = canonical_inputs(device)
    desc = torch.from_numpy(descriptions()).to(device)
    plan = train.epoch_indices(0, True, TRAIN_BATCH)
    scale = np.asarray(POPULATION_SCALES * (n // 4), np.float32)
    turns = {}
    for graph in (False, True, True, False):
        state = {"pop": init_population(cfg, 0, n, device), "step": 0}
        state["opts"] = init_population_opt_states(cfg, state["pop"])
        chunk = make_population_train_step(AgentModules(cfg).to(device), 6,
                                           TRAIN_BATCH, seed=1, graph=graph)

        def pop_step():
            i = state["step"]
            state["pop"], state["opts"], _ = chunk(
                state["pop"], state["opts"], train.feats, train.targets,
                plan[i % len(plan)][None], desc, i, lr_scale=scale)
            state["step"] += 1
            torch.cuda.synchronize()

        ms = host_median_ms(pop_step)
        prof = profile_steps(pop_step, 3)
        turns.setdefault("graph" if graph else "eager", []).append({
            "population_step_ms": ms, "game_steps_per_s": 1e3 * n / ms,
            **{k: prof[k] for k in (
                "device_kernels_per_step", "device_busy_share",
                "host_launch_calls_per_step", "host_calls_per_step",
                "top_device_kernels_us_per_step")}})
        del state, chunk
        torch.cuda.empty_cache()

    mods = member_modules(cfg, init_population(cfg, 0, 1, device), 0)
    single = make_multistep_train_step_indexed(mods, 6, TRAIN_BATCH,
                                               fast=True, seed=1,
                                               device=device)
    opts = init_opt_states(cfg, mods)
    done = [0]

    def one_step():
        i = done[0]
        single(opts, train.feats, train.targets, plan[i % len(plan)][None],
               desc, i)
        done[0] += 1
        torch.cuda.synchronize()

    one_ms = host_median_ms(one_step)
    graph_ms = statistics.median(r["population_step_ms"]
                                 for r in turns["graph"])
    eager_ms = statistics.median(r["population_step_ms"]
                                 for r in turns["eager"])
    row = {"phase": "timing", "population": n, "batch": TRAIN_BATCH,
           "turns": turns,
           "population_step_ms": graph_ms,
           "eager_population_step_ms": eager_ms,
           "game_steps_per_s": 1e3 * n / graph_ms,
           "eager_game_steps_per_s": 1e3 * n / eager_ms,
           "graph_over_eager": graph_ms / eager_ms,
           "single_plain_step_ms": one_ms,
           "single_plain_steps_per_s": 1e3 / one_ms,
           "population_over_single": graph_ms / one_ms,
           "device_kernels_per_step":
               turns["graph"][0]["device_kernels_per_step"],
           "device_busy_share": turns["graph"][0]["device_busy_share"],
           "card": smi}
    log(row)
    return row


def population_digest(pop, opts) -> str:
    """A SHA-256 of every member's weights and optimizer slots (Adam's
    count included): equal digests, equal carries."""
    import hashlib
    import torch
    leaves = list(pop.values()) + [
        t for st in opts.values() for v in st.values()
        for t in (v if isinstance(v, list) else [v])]
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def population_replays(cfg, train, desc, device) -> dict:
    """POPULATION_MEMBERS canonical members from seed 0 at
    POPULATION_SCALES: GRAPH_WARMUP eager steps then GRAPH_REPLAYS
    replays on the graph route, one step a chunk, against as many eager
    steps (``graph=False``), with a digest of every member's weights and
    slots after every step. Bit-equal, or (if capture rounded otherwise)
    the first differing step and the largest difference, held at the
    population phase's float32 tolerance. The first call is made on
    tensors that are not the carry, which must be left as they were; the
    later calls pass the carry back, which must be trained in place."""
    import torch
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.game.train import GRAPH_WARMUP
    from multimodalgame_tpu_torch.parallel.population import (
        init_population, init_population_opt_states,
        make_population_train_step)
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    steps = GRAPH_WARMUP + GRAPH_REPLAYS
    plan = train.epoch_indices(0, True, TRAIN_BATCH)
    scale = np.asarray(POPULATION_SCALES, np.float32)
    runs = {}
    for graph in (False, True):
        pop = init_population(cfg, 0, POPULATION_MEMBERS, device)
        opts = init_population_opt_states(cfg, pop)
        given = {k: v.clone() for k, v in pop.items()}
        chunk = make_population_train_step(AgentModules(cfg).to(device), 6,
                                           TRAIN_BATCH, seed=1, graph=graph)
        replays = Captured.replays
        digests, scalars, in_place = [], [], True
        caller = pop
        for i in range(steps):
            out, opts, sm = chunk(pop, opts, train.feats, train.targets,
                                  plan[i:i + 1], desc, i, lr_scale=scale)
            if graph and i > 0:
                in_place &= all(out[k] is pop[k] for k in pop)
            pop = out
            scalars.append(torch.stack(list(sm)).cpu())
            digests.append(population_digest(pop, opts))
        runs[graph] = {
            "digests": digests, "scalars": scalars,
            "replays": Captured.replays - replays,
            "inputs_unchanged": all(torch.equal(caller[k], v)
                                    for k, v in given.items()),
            "carry_in_place": in_place,
            "params": {k: v.cpu() for k, v in pop.items()},
            "count": {a: int(o["count"]) for a, o in opts.items()
                      if "count" in o}}
    eager, graph = runs[False], runs[True]
    first = first_difference(eager["digests"], graph["digests"])
    row = {"optim": cfg.optim_type, "members": POPULATION_MEMBERS,
           "lr_scale": POPULATION_SCALES, "steps": steps,
           "eager_warmup_steps": GRAPH_WARMUP,
           "replayed_steps": graph["replays"],
           "bit_equal_after_every_step": first is None,
           "scalars_equal": all(torch.equal(a, b) for a, b in zip(
               eager["scalars"], graph["scalars"])),
           "first_differing_step": first, "adam_count": graph["count"],
           "caller_inputs_unchanged": graph["inputs_unchanged"],
           "carry_trained_in_place": graph["carry_in_place"]}
    if first is not None:
        row["max_abs_diff"] = max(
            float((graph["params"][k] - v).abs().max())
            for k, v in eager["params"].items())
    row["ok"] = (graph["replays"] == GRAPH_REPLAYS
                 and (first is None
                      or row["max_abs_diff"] <= POPULATION_PARAM_ATOL)
                 and graph["count"] == eager["count"]
                 and graph["inputs_unchanged"] and graph["carry_in_place"])
    return row


def population_eval_graphs(device) -> dict:
    """The population's dev batch on the graph route against the eager
    ``batch_correct`` at dev batches 64 and 8 (the sweep's truncated last
    batch), ``-flipout_dev`` off and on (its uniforms keyed by a device
    counter, as the sweep draws them, and equal to the int key's): each
    shape three times (eager warm-up, capture and replay, replay), the
    hit counts equal every time."""
    import torch
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.ops.philox import member_uniforms
    from multimodalgame_tpu_torch.parallel.population import (
        init_population, make_population_eval)
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    _, _, _, dev = canonical_inputs(device)
    desc = torch.from_numpy(descriptions()).to(device)
    n, out = POPULATION_MEMBERS, {}
    for flip in (False, True):
        cfg = canonical_cfg(**TRAIN_HP, **(
            dict(flipout_dev=True, flipout_sen=0.1, flipout_rec=0.1)
            if flip else {}))
        pop = init_population(cfg, 0, n, device)
        # Random weights stop every conversation after turn 0 (STOP_BIAS).
        pop["receiver.s.bias"] = torch.full_like(pop["receiver.s.bias"],
                                                 STOP_BIAS)
        runs = {g: make_population_eval(AgentModules(cfg).to(device), 6,
                                        graph=g) for g in (False, True)}
        key = torch.tensor([1, 46], dtype=torch.int64, device=device)
        replays = Captured.replays
        for batch in (64, 8):
            rows = torch.arange(batch, device=device) + 64 * (batch == 8)
            data, target = dev.feats[rows], dev.targets[rows]
            u = member_uniforms(cfg, batch, key[0], key[1], n, device,
                                slot=1)
            same_u = u is None or all(torch.equal(v, w) for v, w in zip(
                u.values(), member_uniforms(cfg, batch, 1, 46, n, device,
                                            slot=1).values()))
            want = runs[False](pop, data, target, desc, uniforms=u)
            got = [runs[True](pop, data, target, desc, uniforms=u)
                   for _ in range(3)]
            out[f"flipout_dev={flip},batch={batch}"] = {
                "hits": want.tolist(),
                "equal": all(torch.equal(g, want) for g in got),
                "tensor_key_uniforms_equal": same_u}
        out[f"flipout_dev={flip},replays"] = Captured.replays - replays
    return out


def check_population_graph(device, smi):
    """The population on the graph route (``parallel/population.py:
    population_route``): replayed steps against eager ones for RMSprop
    and Adam, the caller's inputs left as they were, the dev batch's
    graph against eager, and the host's launch calls an update at one
    step a chunk and in a chunk of PROFILED_CHUNK, graph against eager;
    all fatal."""
    import torch
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.parallel.population import (
        init_population, init_population_opt_states,
        make_population_train_step)
    t_start = t0 = time.perf_counter()
    _, _, train, _ = canonical_inputs(device)
    desc = torch.from_numpy(descriptions()).to(device)
    out = {"seconds": {}}
    for optim in ("RMSprop", "Adam"):
        row = population_replays(canonical_cfg(**{**TRAIN_HP,
                                                  "optim_type": optim}),
                                 train, desc, device)
        log({"phase": "population_graph", "check": "replay_against_eager",
             **row, "card": smi})
        if not row["ok"]:
            raise SystemExit(f"population_graph: replays part from eager: "
                             f"{row}")
        out[optim] = row
    out["seconds"]["replays"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    evals = population_eval_graphs(device)
    log({"phase": "population_graph", "check": "eval", **evals,
         "card": smi})
    if not all(v["equal"] and v["tensor_key_uniforms_equal"]
               for v in evals.values() if isinstance(v, dict)) or not all(
                   v == 4 for k, v in evals.items() if k.endswith("replays")):
        raise SystemExit(f"population_graph: the eval graph differs: "
                         f"{evals}")
    out["eval"] = evals
    out["seconds"]["eval"] = time.perf_counter() - t0

    # Host calls an update: one step a chunk, then PROFILED_CHUNK steps
    # in one chunk, graph against eager.
    t0 = time.perf_counter()
    cfg = canonical_cfg(**TRAIN_HP)
    plan = train.epoch_indices(1, True, TRAIN_BATCH)
    scale = np.asarray(POPULATION_SCALES, np.float32)
    calls = {}
    for graph in (False, True):
        state = {"pop": init_population(cfg, 0, POPULATION_MEMBERS, device),
                 "step": 0}
        state["opts"] = init_population_opt_states(cfg, state["pop"])
        chunk = make_population_train_step(AgentModules(cfg).to(device), 6,
                                           TRAIN_BATCH, seed=1, graph=graph)

        def run(k):
            i = state["step"]
            state["pop"], state["opts"], _ = chunk(
                state["pop"], state["opts"], train.feats, train.targets,
                plan[:k], desc, i, lr_scale=scale)
            state["step"] += k
            torch.cuda.synchronize()

        for _ in range(3):
            run(1)
        per = {"one_step_a_chunk": (profile_steps(lambda: run(1), 2), 1)}
        # An eager chunk makes the same calls a step as one step does.
        if graph:
            per["chunk_of_8_per_update"] = (profile_steps(
                lambda: run(PROFILED_CHUNK), 1), PROFILED_CHUNK)
        calls["graph" if graph else "eager"] = {
            k: {"host_launch_calls": p["host_launch_calls_per_step"] / d,
                "host_calls": {c: v / d for c, v in
                               p["host_calls_per_step"].items()},
                "device_kernels": p["device_kernels_per_step"] / d,
                "device_busy_share": p["device_busy_share"]}
            for k, (p, d) in per.items()}
    log({"phase": "population_graph", "check": "host_calls",
         "members": POPULATION_MEMBERS, "batch": TRAIN_BATCH, **calls,
         "card": smi})
    seen = calls["eager"]["one_step_a_chunk"]["host_launch_calls"] > 0
    per_update = calls["graph"]["chunk_of_8_per_update"]["host_launch_calls"]
    out["seconds"]["host_calls"] = time.perf_counter() - t0
    if seen and per_update > POPULATION_HOST_CALLS:
        raise SystemExit(f"population_graph: {per_update} host launch "
                         f"calls an update on the graph route")
    out["calls"] = calls
    out["seconds"]["all"] = time.perf_counter() - t_start
    log({"phase": "population_graph", "seconds": out["seconds"]})
    return out


def drive_sweep(device, workdir, smi, argv, phase, min_top6=None):
    """``sweep.run_sweep`` (what ``python -m multimodalgame_tpu_torch.sweep``
    calls) on the canonical in-memory sets with both kernels' counts set
    to 0 just before; then ``-eval_only`` on the winner's ``_best``."""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.game.train import GRAPH_WARMUP
    from multimodalgame_tpu_torch.sweep import run_sweep
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    log_path = os.path.join(workdir, phase)
    flags = flags_from_argv(DEMO_ARGV + argv + ["-log_path", log_path])
    inputs = canonical_inputs(device)
    train, dev = inputs[2], inputs[3]
    n = flags.population
    steps = flags.max_epoch * (train.size // flags.batch_size)
    sweeps = len(range(flags.log_dev, steps + 1, flags.log_dev)) + (
        steps % flags.log_dev != 0)
    dev_batches = -(-dev.size // flags.batch_size_dev)
    want = {"steps": steps, "members": n,
            "train_launches": steps if n == 1 else 0,
            "eval_launches": sweeps * dev_batches if n == 1 else 0}
    fused_train_forward.launches = 0
    fused_eval_exchange.launches = 0
    replays, captures = Captured.replays, Captured.captures
    t0 = time.perf_counter()
    summary = run_sweep(flags, device=device, inputs=inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {"steps": summary["steps"], "members": len(summary["members"]),
           "train_launches": fused_train_forward.launches,
           "eval_launches": fused_eval_exchange.launches}
    # The graph route: every step after the warm-up is a replay, and so
    # is every dev batch after its shape's first.
    graph = {"replays": Captured.replays - replays,
             "captures": Captured.captures - captures}
    log({"phase": phase, **got, **graph, "expected": want,
         "winner": summary["winner"],
         "winner_best_dev_acc": summary["winner_best_dev_acc"],
         "winner_final_dev_acc": summary["winner_final_dev_acc"],
         "members": summary["members"], "seconds": secs,
         "steps_per_sec_total": summary["steps_per_sec_total"],
         "game_steps_per_s": n * steps / secs, "card": smi})
    for k, v in want.items():
        if got[k] != v:
            raise SystemExit(f"{phase}: {k} {got[k]}, expected {v}")
    if graph["replays"] < steps - GRAPH_WARMUP:
        raise SystemExit(f"{phase}: {graph['replays']} graph replays over "
                         f"{steps} steps")
    accs = [m[k] for m in summary["members"]
            for k in ("final_dev_acc", "best_dev_acc")]
    if not all(np.isfinite(accs)):
        raise SystemExit(f"{phase}: a member's dev accuracy is not finite")
    if min_top6 is not None and summary["winner_best_dev_acc"] < min_top6:
        raise SystemExit(f"{phase}: the winner's dev top-6 "
                         f"{summary['winner_best_dev_acc']} is below "
                         f"{min_top6}")
    eval_flags = flags_from_argv(DEMO_ARGV + [
        "-eval_only", "-checkpoint", summary["checkpoint"], "-log_path",
        log_path, "-experiment_name", phase + "_eval"])
    out, _, counts = run_counted(eval_flags, inputs, device)
    log({"phase": phase, "eval_only_dev_acc": out["dev_acc"],
         "winner_final_dev_acc": summary["winner_final_dev_acc"],
         "eval_kernel_launches": counts["eval_launches"]})
    if out["dev_acc"] != summary["winner_final_dev_acc"]:
        raise SystemExit(f"{phase}: -eval_only gave {out['dev_acc']} on "
                         f"_best, the sweep {summary['winner_final_dev_acc']}")
    return {"train_launches": got["train_launches"],
            "eval_launches": got["eval_launches"], **graph,
            "game_steps_per_s": n * steps / secs,
            "steps_per_sec_total": summary["steps_per_sec_total"],
            "winner_best_dev_acc": summary["winner_best_dev_acc"]}


# ---------------------------------------------------------------- the mesh

def check_row_base(device):
    """The train kernel at batch 64 under Philox, launched as two launches
    of 32 rows with ``row_base`` 0 and 32, against one launch of 64: bits,
    masks and the turn count equal, probabilities within 1e-5; the
    halves also against their plain version (``philox_uniforms`` with the
    same ``row_base``), and that draw equal to the rows of the whole."""
    import torch
    from multimodalgame_tpu_torch.game.exchange import (finalize_stop_masks,
                                                        turns_run)
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        compare_outputs, fused_train_forward, fused_train_forward_reference,
        kernel_params)
    from multimodalgame_tpu_torch.ops.philox import philox_uniforms
    cfg = canonical_cfg(**TRAIN_HP)
    params = kernel_params(make_agents(cfg, device))
    desc = torch.from_numpy(descriptions()).to(device)
    data = torch.from_numpy(features(TRAIN_BATCH, seed=64)).to(device)
    half = TRAIN_BATCH // 2
    seed, step = 5, 7
    whole_u = philox_uniforms(cfg, TRAIN_BATCH, seed, step, device)
    out = {"max_prob_err": 0.0}
    with torch.inference_mode():
        whole = fused_train_forward(cfg, params, data, desc, seed=seed,
                                    step=step)
        halves = []
        for base in (0, half):
            part = fused_train_forward(cfg, params, data[base:base + half],
                                       desc, seed=seed, step=step,
                                       row_base=base)
            u = philox_uniforms(cfg, half, seed, step, device, row_base=base)
            if not all(torch.equal(u[k], whole_u[k][:, base:base + half])
                       for k in u):
                raise SystemExit(f"row_base: philox_uniforms at row_base "
                                 f"{base} is not the whole draw's rows")
            plain = fused_train_forward_reference(
                cfg, params, data[base:base + half], desc, u)
            rep = compare_outputs(cfg, part, plain, uniforms=u)
            if not rep["ok"]:
                raise SystemExit(f"row_base: the kernel at row_base {base} "
                                 f"disagrees with its plain version: {rep}")
            out[f"plain_row_base_{base}"] = rep
            halves.append(part)
    torch.cuda.synchronize()
    for k in ("sen_feats", "rec_feats", "stop_feats", "masks"):
        got = torch.cat([getattr(h, k) for h in halves], dim=1)
        if not torch.equal(got, getattr(whole, k)):
            raise SystemExit(f"row_base: the split launches' {k} differ "
                             f"from the whole launch's")
    for k in ("sen_probs", "rec_probs", "stop_probs", "y"):
        got = torch.cat([getattr(h, k) for h in halves], dim=1)
        out["max_prob_err"] = max(out["max_prob_err"], float(
            (got - getattr(whole, k)).abs().max()))
    n_whole = int(finalize_stop_masks(whole.masks, False)[1])
    stop = torch.cat([finalize_stop_masks(h.masks, False)[0]
                      for h in halves], dim=1)
    n_split = int(turns_run(stop, False))
    if n_whole != n_split or out["max_prob_err"] > 1e-5:
        raise SystemExit(f"row_base: turns {n_split} against {n_whole}, "
                         f"largest difference {out['max_prob_err']}")
    log({"phase": "row_base", "batch": TRAIN_BATCH, "split": [half, half],
         "n_steps": n_whole, "bits_masks_equal": True, **out})
    return out


def gloo_cuda_collectives(mesh) -> dict:
    """Which collectives gloo takes on CUDA tensors here: each one tried
    on a small tensor of this rank's card, its answer checked."""
    import torch
    import torch.distributed as dist
    dev, r, n = mesh.device, mesh.rank, mesh.size
    trials = {
        "all_reduce": lambda: dist.all_reduce(
            torch.full((4,), r + 1.0, device=dev)),
        "broadcast": lambda: dist.broadcast(
            torch.full((4,), r + 1.0, device=dev), src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(n)],
            torch.full((4,), r + 1.0, device=dev)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n, device=dev),
            torch.full((4,), r + 1.0, device=dev)),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev),
            torch.full((4 * n,), r + 1.0, device=dev)),
        "reduce": lambda: dist.reduce(
            torch.full((4,), r + 1.0, device=dev), dst=0),
    }
    out = {}
    for name, fn in trials.items():
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = type(e).__name__ + ": " + str(e).splitlines()[0][:120]
        # Keep the ranks in step whatever the trial did.
        mesh.barrier()
    x = torch.full((4,), r + 1.0, device=dev)
    mesh.all_reduce_(x)
    if not torch.equal(x.cpu(), torch.full((4,), n * (n + 1) / 2)):
        raise RuntimeError(f"gloo all_reduce on CUDA gave {x}")
    return out


def drive_staged(device, smi):
    """The staged K-step trainer (``make_multistep_train_step``) on the
    canonical game: STAGED_EPOCHS epochs of (K, 64, 512) stacks staged on
    the card, phase A in the train kernel. Held: one train-kernel launch
    a step, finite losses and the run bit for bit the indexed chunk's
    over the same rows staged as a set (``idx = arange``). Then the
    step's ms, kernels and busy share."""
    import torch
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES,
                                                      AgentModules,
                                                      init_params)
    from multimodalgame_tpu_torch.game.train import (
        init_opt_states, make_multistep_train_step,
        make_multistep_train_step_indexed)
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    cfg = canonical_cfg(**TRAIN_HP)
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    desc = torch.from_numpy(descriptions()).to(device)
    plan = torch.from_numpy(np.concatenate([
        train.epoch_indices(e, True, TRAIN_BATCH)
        for e in range(STAGED_EPOCHS)])).to(device)
    data, target = train.feats[plan], train.targets[plan]
    steps = len(plan)

    def trainer(factory):
        mods = init_params(AgentModules(cfg), seed=0, device=device)
        return mods, factory(mods, top_k=6, batch_denom=TRAIN_BATCH,
                             fast="kernel", seed=0, device=device
                             ), init_opt_states(cfg, mods)

    # The main path, counted alone.
    mods, chunk, opts = trainer(make_multistep_train_step)
    fused_train_forward.launches = fused_eval_exchange.launches = 0
    t0 = time.perf_counter()
    sm = chunk(opts, data, target, desc, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fused_train_forward.launches
    eval_launches = fused_eval_exchange.launches
    finite = bool(torch.isfinite(torch.stack(list(sm))).all())

    # The indexed chunk over the same rows, staged as a set.
    imods, ichunk, iopts = trainer(make_multistep_train_step_indexed)
    im = ichunk(iopts, data.reshape(steps * TRAIN_BATCH, -1),
                target.reshape(-1), np.arange(steps * TRAIN_BATCH).reshape(
                    steps, TRAIN_BATCH), desc, 0)
    bit_equal = (all(torch.equal(a, b) for a, b in zip(sm, im))
                 and torch_equal(dict(mods.named_parameters()),
                                 dict(imods.named_parameters()))
                 and all(torch.equal(x, y) for a in AGENT_NAMES
                         for x, y in zip(opts[a]["nu"], iopts[a]["nu"])))
    del imods, ichunk, iopts

    # The step on the trained agents: host-clock median, then profiled.
    counter = {"step": steps}

    def one_step():
        i = counter["step"]
        chunk(opts, data[i % steps][None], target[i % steps][None], desc, i)
        counter["step"] += 1
        torch.cuda.synchronize()
    step_ms = host_median_ms(one_step)
    row = {"phase": "staged", "steps": steps, "epochs": STAGED_EPOCHS,
           "stacks": list(data.shape), "seconds": secs,
           "steps_per_s": steps / secs, "train_kernel_launches": launches,
           "eval_kernel_launches": eval_launches, "losses_finite": finite,
           "train_top6": float(sm.accuracy.mean()),
           "indexed_chunk_bit_equal": bit_equal,
           "train_step_ms": step_ms, **profile_steps(one_step),
           "card": smi}
    log(row)
    if launches != steps or not finite or not bit_equal or eval_launches:
        raise SystemExit(f"staged: {row}")
    return {"train_launches": launches, "eval_launches": eval_launches,
            **row}


# The mesh_graph phase's driver run: the demo's argv for 5 of its 30
# epochs (230 steps, two dev sweeps), as tp_driver runs it.
MESH_GRAPH_EPOCHS = 5
# The graph phase: GRAPH_REPLAYS replayed steps of the bare trainer after
# its eager warm-up, held against as many eager steps after every step;
# PROFILED_CHUNK steps in one chunk for the host calls an update.
GRAPH_REPLAYS, PROFILED_CHUNK = 8, 8
# The CUDA runtime and driver calls that put work on the card, as the
# profiler names them.
HOST_LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel",
                     "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaMemcpyAsync")


def bare_trainer(cfg, train, desc, graph: bool, device, mesh=None,
                 grid: bool = False):
    """The bare trainer (``make_multistep_train_step_indexed``, phase A
    in the train kernel) from seed 0 on ``graph``'s route; with ``mesh``
    as a rank of it, and with ``grid`` tensor-parallel over its model
    axis (``mesh`` from ``make_mesh_2d``)."""
    from multimodalgame_tpu_torch.game.agents import (AgentModules,
                                                      init_params)
    from multimodalgame_tpu_torch.game.train import (
        init_opt_states, make_multistep_train_step_indexed)
    from multimodalgame_tpu_torch.parallel.tensor import (
        TensorParallel, init_tp_opt_states)
    mods = init_params(AgentModules(cfg), seed=0, device=device)
    tp = (TensorParallel(mesh, mods, num_classes=NUM_CLASSES) if grid
          else None)
    chunk = make_multistep_train_step_indexed(
        mods, top_k=6, batch_denom=TRAIN_BATCH, fast="kernel", seed=0,
        device=device, graph=graph, mesh=mesh, tp=tp)
    opts = (init_opt_states(cfg, mods) if tp is None
            else init_tp_opt_states(cfg, tp))
    return mods, chunk, opts


def collective_calls(mesh) -> dict:
    """A mesh's collective calls so far, on each axis."""
    if mesh is None:
        return {}
    out = {"data": mesh.calls}
    if mesh.model is not None:
        out["model"] = mesh.model.calls
    return out


def replay_against_eager(cfg, train, desc, device, mesh=None,
                         grid: bool = False) -> dict:
    """GRAPH_WARMUP eager steps, then GRAPH_REPLAYS replays, one step a
    chunk, against as many eager steps from the same seed (with ``mesh``
    and ``grid``, :func:`bare_trainer`'s): a digest of the weights and
    optimizer slots and the step's scalars after every step, and the
    collective calls a step. Bit-equal, or (if capture rounded
    otherwise) the first differing step, the largest difference and the
    share of JAX's mesh tolerance it takes."""
    import torch
    from multimodalgame_tpu_torch.game.train import GRAPH_WARMUP
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_train_forward)
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    steps = GRAPH_WARMUP + GRAPH_REPLAYS
    plan = train.epoch_indices(0, True, TRAIN_BATCH)
    runs = {}
    for graph in (False, True):
        mods, chunk, opts = bare_trainer(cfg, train, desc, graph, device,
                                         mesh, grid)
        fused_train_forward.launches = 0
        replays = Captured.replays
        calls = collective_calls(mesh)
        digests, scalars = [], []
        for i in range(steps):
            sm = chunk(opts, train.feats, train.targets, plan[i:i + 1], desc,
                       i)
            scalars.append(torch.stack(list(sm)).cpu())
            digests.append(state_digest(mods, opts))
        runs[graph] = {"digests": digests, "scalars": scalars,
                       "launches": fused_train_forward.launches,
                       "replays": Captured.replays - replays,
                       "calls_per_step": {
                           k: (v - calls[k]) / steps
                           for k, v in collective_calls(mesh).items()},
                       "params": {n: p.detach().cpu().clone()
                                  for n, p in mods.named_parameters()},
                       "count": {a: int(o["count"]) for a, o in opts.items()
                                 if "count" in o}}
    eager, graph = runs[False], runs[True]
    first = first_difference(eager["digests"], graph["digests"])
    row = {"optim": cfg.optim_type, "steps": steps,
           "eager_warmup_steps": GRAPH_WARMUP,
           "replayed_steps": graph["replays"],
           "train_launches": {"eager": eager["launches"],
                              "graph": graph["launches"]},
           "bit_equal_after_every_step": first is None,
           "scalars_equal": all(torch.equal(a, b) for a, b in zip(
               eager["scalars"], graph["scalars"])),
           "first_differing_step": first, "adam_count": graph["count"],
           "collective_calls_per_step": {"eager": eager["calls_per_step"],
                                         "graph": graph["calls_per_step"]}}
    if first is not None:
        row["max_abs_diff"] = max(
            float((graph["params"][k] - v).abs().max())
            for k, v in eager["params"].items())
        row["param_tolerance_use"], row["param_worst"] = params_close(
            graph["params"], eager["params"])
    ok = (graph["replays"] == GRAPH_REPLAYS
          and eager["launches"] == graph["launches"] == steps
          and (first is None or row["param_tolerance_use"] <= 1.0)
          and graph["count"] == eager["count"]
          and graph["calls_per_step"] == eager["calls_per_step"])
    row["ok"] = ok
    return row


def time_routes(make, train, desc) -> dict:
    """The host's calls that put work on the card, the device's kernels
    and busy share (``profile_steps``) and the step's host ms, graph
    against eager in turns on the same card (eager, graph, graph, eager),
    at one step a chunk and in a chunk of PROFILED_CHUNK steps;
    ``make(graph)`` builds a fresh ``(mods, chunk, opts)`` of a route."""
    import torch
    plan_np = train.epoch_indices(1, True, TRAIN_BATCH)
    timing = {}
    for graph in (False, True, True, False):
        mods, chunk, opts = make(graph)
        done = [0]

        def one_step():
            i = done[0]
            chunk(opts, train.feats, train.targets,
                  plan_np[i % len(plan_np)][None], desc, i)
            done[0] += 1
            torch.cuda.synchronize()

        def one_chunk():
            i = done[0]
            chunk(opts, train.feats, train.targets,
                  plan_np[:PROFILED_CHUNK], desc, i)
            done[0] += PROFILED_CHUNK
            torch.cuda.synchronize()

        for _ in range(3):
            one_step()

        def calls(prof, per):
            return {"host_calls": {k: v / per for k, v in
                                   prof["host_calls_per_step"].items()},
                    "host_launch_calls":
                        prof["host_launch_calls_per_step"] / per,
                    "device_kernels": prof["device_kernels_per_step"] / per,
                    "device_busy_share": prof["device_busy_share"]}

        row = {"step_ms": host_median_ms(one_step),
               "one_step_a_chunk": calls(profile_steps(one_step, 3), 1)}
        if graph:
            # An eager chunk makes the same calls a step as one step does.
            one_chunk()
            row["chunk_of_8_per_update"] = calls(profile_steps(one_chunk, 1),
                                                 PROFILED_CHUNK)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            one_chunk()
            times.append(1e3 * (time.perf_counter() - t0))
        row["chunk_ms_per_update"] = statistics.median(times) / PROFILED_CHUNK
        timing.setdefault("graph" if graph else "eager", []).append(row)
    return {k: {"step_ms": [r["step_ms"] for r in rows],
                "chunk_ms_per_update": [r["chunk_ms_per_update"]
                                        for r in rows],
                "one_step_a_chunk": rows[0]["one_step_a_chunk"],
                "chunk_of_8_per_update": rows[0].get(
                    "chunk_of_8_per_update", rows[0]["one_step_a_chunk"])}
            for k, rows in timing.items()}


def graph_calls_held(calls) -> bool:
    """At most 4 host launch calls an update on the graph route in a
    chunk of 8, where the profiler saw the eager route's calls at all."""
    seen = calls["eager"]["one_step_a_chunk"]["host_launch_calls"] > 0
    per_update = calls["graph"]["chunk_of_8_per_update"]["host_launch_calls"]
    return not seen or per_update <= 4


def check_graph(device, smi):
    """The graph route (``game/train.py:step_route``): replayed steps
    against eager ones (RMSprop and Adam), 92 staged steps learning on the
    graph, the host's calls an update graph against eager, and the
    served answers of graph-captured eval conversations against eager
    ones; all fatal."""
    import torch
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.agents import (AgentModules,
                                                      init_params)
    from multimodalgame_tpu_torch.game.train import (
        init_opt_states, make_multistep_train_step)
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.serve import Predictor
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    t_start = time.perf_counter()
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=device)
    desc = torch.from_numpy(descriptions()).to(device)
    out = {}

    # Replayed against eager, from seed 0, after every step.
    for optim in ("RMSprop", "Adam"):
        row = replay_against_eager(canonical_cfg(**{**TRAIN_HP,
                                                    "optim_type": optim}),
                                   train, desc, device)
        log({"phase": "graph", "check": "replay_against_eager", **row,
             "card": smi})
        if not row["ok"]:
            raise SystemExit(f"graph: replayed steps part from eager: {row}")
        out[optim] = row

    # Learning on the graph: STAGED_EPOCHS epochs of stacks in one chunk.
    cfg = canonical_cfg(**TRAIN_HP)
    plan = torch.from_numpy(np.concatenate([
        train.epoch_indices(e, True, TRAIN_BATCH)
        for e in range(STAGED_EPOCHS)])).to(device)
    mods = init_params(AgentModules(cfg), seed=0, device=device)
    chunk = make_multistep_train_step(mods, top_k=6, batch_denom=TRAIN_BATCH,
                                      fast="kernel", seed=0, device=device)
    opts = init_opt_states(cfg, mods)
    fused_train_forward.launches = 0
    replays = Captured.replays
    sm = chunk(opts, train.feats[plan], train.targets[plan], desc, 0)
    torch.cuda.synchronize()
    acc = sm.accuracy.cpu().numpy()
    learn = {"steps": len(plan), "train_launches":
             fused_train_forward.launches,
             "replays": Captured.replays - replays,
             "losses_finite": bool(torch.isfinite(torch.stack(list(sm)))
                                   .all()),
             "train_top6_first_10": float(acc[:10].mean()),
             "train_top6_last_10": float(acc[-10:].mean())}
    log({"phase": "graph", "check": "staged_learning", **learn})
    if (learn["train_launches"] != len(plan) or not learn["losses_finite"]
            or learn["replays"] != len(plan) - 2):
        raise SystemExit(f"graph: staged steps on the graph: {learn}")
    out["staged"] = learn

    # Host calls an update and the step's time, graph against eager, in
    # turns on the same card.
    calls = time_routes(lambda graph: bare_trainer(cfg, train, desc, graph,
                                                   device), train, desc)
    log({"phase": "graph", "check": "host_calls", "batch": TRAIN_BATCH,
         **calls, "card": smi})
    if not graph_calls_held(calls):
        raise SystemExit(f"graph: more than 4 host launch calls an "
                         f"update on the graph route: {calls['graph']}")
    out["calls"] = calls

    # Serving: the graph-captured eval conversation against the eager
    # one, each request shape three times (eager warm-up, capture and
    # replay, replay), one eval launch a request.
    eager_pred = Predictor(canonical_cfg(), make_agents(canonical_cfg(),
                                                        device),
                           description_pack(), device=device, graph=False)
    pred = Predictor(canonical_cfg(), make_agents(canonical_cfg(), device),
                     description_pack(), device=device)
    served = {}
    for batch in BATCHES:
        x = features(batch, seed=200 + batch)
        want = eager_pred.predict(x)
        fused_eval_exchange.launches = 0
        same = []
        for _ in range(3):
            got = pred.predict(x)
            same.append(all(np.array_equal(got[k], want[k]) for k in want))
        launches = fused_eval_exchange.launches
        served[batch] = {
            "bit_equal": all(same), "eval_launches": launches,
            "graph_ms": host_median_ms(lambda: pred.predict(x)),
            "eager_ms": host_median_ms(lambda: eager_pred.predict(x))}
        if not all(same) or launches != 3:
            raise SystemExit(f"graph: served batch {batch}: "
                             f"{served[batch]}")
    log({"phase": "graph", "check": "serve", "batches": served,
         "captures": Captured.captures, "card": smi})
    out["serve"] = served
    out["seconds"] = time.perf_counter() - t_start
    log({"phase": "graph", "seconds": out["seconds"]})
    return out


def mesh_graph_drive(mesh, workdir) -> dict:
    """``run_fast`` as one rank of ``mesh`` (``train._run_rank``, what
    each rank of a ``-mesh`` run calls) with the demo's argv cut to
    MESH_GRAPH_EPOCHS epochs on the in-memory sets: its counts, log and
    seconds."""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.train import _run_rank
    flags = flags_from_argv(DEMO_ARGV + [
        "-max_epoch", str(MESH_GRAPH_EPOCHS), "-log_path",
        os.path.join(workdir, "mesh_graph"), "-experiment_name",
        "mesh_graph"])
    inputs = canonical_inputs(mesh.device)
    want = cadence_counts(flags, inputs[2].size, inputs[3].size)
    fused_train_forward.launches = 0
    fused_eval_exchange.launches = 0
    t0 = time.perf_counter()
    summary = _run_rank(mesh, flags, None, inputs, None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, losses, last_dev, timing = read_log(flags, summary)
    text = open(flags.log_file).read()
    got.update(train_launches=summary["launches"]["train"],
               eval_launches=summary["launches"]["eval"])
    return {"counts": got, "expected": want, "losses": losses,
            "last_dev_top6": last_dev, "seconds": secs,
            "run_steps_per_s": want["steps"] / secs,
            "last_epoch_steps_per_s": timing["steps_per_sec"],
            "step_graph": "Step: graph" in text,
            "step_eager": "Step: eager" in text,
            "collective_calls_per_step":
                summary["collectives"]["calls"] / want["steps"]}


def mesh_graph_rank(mesh, workdir) -> dict:
    """The ``mesh_graph`` phase inside one rank of an NCCL group: the
    route; on ``mesh`` and on a 1 x 1 grid of it (``make_mesh_2d``), the
    bare trainer's replays against eager steps (RMSprop, Adam) and its
    host calls, kernels, busy share and step ms graph against eager in
    turns; then the driver on ``mesh``."""
    import torch
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.train import step_route
    from multimodalgame_tpu_torch.parallel.tensor import make_mesh_2d
    dev = mesh.device
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=dev)
    desc = torch.from_numpy(descriptions()).to(dev)
    grid = make_mesh_2d(mesh, 1)
    out = {"backend": mesh.backend,
           "route": {"mesh": step_route(dev, mesh),
                     "grid": step_route(dev, grid)}}
    for name, axis, is_grid in (("mesh", mesh, False), ("grid", grid, True)):
        replays = [replay_against_eager(
            canonical_cfg(**{**TRAIN_HP, "optim_type": optim}), train, desc,
            dev, axis, is_grid) for optim in ("RMSprop", "Adam")]
        cfg = canonical_cfg(**TRAIN_HP)
        calls = time_routes(lambda graph: bare_trainer(
            cfg, train, desc, graph, dev, axis, is_grid), train, desc)
        out[name] = {"replays": replays, "calls": calls}
    out["driver"] = mesh_graph_drive(mesh, workdir)
    return out


def mesh_graph(workdir, smi) -> dict:
    """A rank of an NCCL mesh on the graph route (``game/train.py:
    step_route``: its collectives inside the step's CUDA graph), in a
    one-rank NCCL group on the card (two ranks on one card are refused by
    NCCL, and a one-rank group runs the same ``ProcessGroupNCCL`` code):
    replays bit-equal to eager steps after every step and the collective
    calls a step equal, on the mesh and on a 1 x 1 grid (its model axis
    TP_MODEL_CALLS a step), host launch calls an update and step ms graph
    against eager, and ``run_fast`` on the mesh logging ``Step: graph``
    with the driver's counts and a dev top-6 of at least MIN_DEV_TOP6; all
    fatal. A one-rank all-reduce moves no bytes: nothing here measures
    NCCL's cost across cards."""
    from multimodalgame_tpu_torch.parallel.distributed import launch
    t0 = time.perf_counter()
    got, = launch(mesh_graph_rank, ["cuda:0"], (workdir,), backend="nccl")
    seconds = time.perf_counter() - t0
    failed = []
    if got["backend"] != "nccl" or set(got["route"].values()) != {"graph"}:
        failed.append(f"route {got['route']} on {got['backend']}")
    for name in ("mesh", "grid"):
        for row in got[name]["replays"]:
            log({"phase": "mesh_graph", "on": name,
                 "check": "replay_against_eager", **row, "card": smi})
            if not row["ok"]:
                failed.append(f"{name} {row['optim']} replays part from "
                              f"eager steps")
            model = row["collective_calls_per_step"]["graph"].get("model")
            if name == "grid" and model != TP_MODEL_CALLS:
                failed.append(f"grid: {model} model-axis calls a step, "
                              f"expected {TP_MODEL_CALLS}")
        calls = got[name]["calls"]
        log({"phase": "mesh_graph", "on": name, "check": "host_calls",
             "batch": TRAIN_BATCH, **calls, "card": smi})
        if not graph_calls_held(calls):
            failed.append(f"{name}: more than 4 host launch calls an "
                          f"update on the graph route")
    drv = got["driver"]
    log({"phase": "mesh_graph", "check": "driver", **drv["counts"],
         "expected": drv["expected"], "finite_losses": len(drv["losses"]),
         **{k: v for k, v in drv.items()
            if k not in ("counts", "expected", "losses")}, "card": smi})
    check_counts("mesh_graph", drv["counts"], drv["expected"],
                 drv["losses"])
    if not drv["step_graph"] or drv["step_eager"]:
        failed.append("the driver's log does not say Step: graph")
    if drv["last_dev_top6"] < MIN_DEV_TOP6:
        failed.append(f"dev top-6 {drv['last_dev_top6']} is below "
                      f"{MIN_DEV_TOP6}")
    log({"phase": "mesh_graph", "seconds": seconds})
    if failed:
        raise SystemExit(f"mesh_graph: {failed}")
    rows = [r for n in ("mesh", "grid") for r in got[n]["replays"]]
    return {"train_launches": drv["counts"]["train_launches"] + sum(
                sum(r["train_launches"].values()) for r in rows),
            "eval_launches": drv["counts"]["eval_launches"],
            "calls": {n: got[n]["calls"] for n in ("mesh", "grid")},
            "dev_top6": drv["last_dev_top6"],
            "run_steps_per_s": drv["run_steps_per_s"]}


def thread_meshes(size: int, device):
    """``size`` data-parallel ranks as threads of this process on one
    device: each is a ``parallel/mesh.py:Mesh`` whose all-reduce sums the
    ranks' tensors on the device in rank order, so a step run through them
    does the mesh's arithmetic (each rank's rows, the halves' gradients
    and batch statistics summed) with no process group."""
    import threading
    from multimodalgame_tpu_torch.parallel.mesh import Mesh
    slots, total = [None] * size, [None]
    barrier = threading.Barrier(size)

    class ThreadMesh(Mesh):
        def all_reduce_(self, x):
            slots[self.rank] = x
            barrier.wait()
            if self.rank == 0:
                acc = slots[0].clone()
                for s in slots[1:]:
                    acc += s
                total[0] = acc
            barrier.wait()
            x.copy_(total[0])
            barrier.wait()
            self.calls += 1
            return x

    return [ThreadMesh(r, size, device, "threads") for r in range(size)]


def run_threads(fn, meshes, *args) -> list:
    """``fn(mesh, *args)`` on a thread for each of ``meshes``; their
    results in rank order (the first failure re-raised)."""
    import threading
    out = [None] * len(meshes)

    def run(i):
        try:
            out[i] = fn(meshes[i], *args)
        except BaseException as e:     # noqa: BLE001 - re-raised below
            out[i] = e
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


def weights_digest(mods) -> str:
    """A SHA-256 of every weight's bytes: equal digests, equal weights."""
    import hashlib
    import torch
    flat = torch.cat([p.detach().reshape(-1) for p in mods.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def state_digest(mods, opts) -> str:
    """A SHA-256 of the weights, every optimizer slot and Adam's counts
    (each exact in float64): equal digests, equal states."""
    import hashlib
    import torch
    parts = [p.detach().reshape(-1).double() for p in mods.parameters()]
    parts += [x.detach().reshape(-1).double() for st in opts.values()
              for k in ("mu", "nu", "count") if k in st
              for x in (st[k] if isinstance(st[k], list) else [st[k]])]
    return hashlib.sha256(torch.cat(parts).cpu().numpy().tobytes()
                          ).hexdigest()


def first_difference(a, b):
    """The first index at which two digest streams differ, else None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def mesh_train_rank(mesh, steps: int, device: str = "cuda",
                    n_model: int = 1, trace: bool = False) -> dict:
    """``steps`` steps of the canonical Adaptive game through the train
    kernel (``make_multistep_train_step_indexed(fast="kernel")``) from
    seed 0, on ``mesh`` (its rows of each batch of 64; with ``n_model``
    above 1 a ``(data, model)`` grid of the ranks, tensor-parallel) or,
    with ``mesh`` None, on ``device`` alone: the accuracy stream, the
    weights, the train kernel's launches and the seconds, with the
    collectives' (each axis's). With ``trace`` the steps run one a chunk
    and the weights' digest after each is returned (``digests``)."""
    import torch
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.agents import (AgentModules,
                                                      init_params)
    from multimodalgame_tpu_torch.game.train import (
        init_opt_states, make_multistep_train_step_indexed)
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_train_forward)
    dev = torch.device(device if mesh is None else mesh.device)
    probe = (gloo_cuda_collectives(mesh) if mesh is not None
             and n_model == 1 and mesh.backend == "gloo"
             and dev.type == "cuda" else None)
    cfg = canonical_cfg(**TRAIN_HP)
    mods = init_params(AgentModules(cfg), seed=0, device=dev)
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device=dev)
    desc = torch.from_numpy(descriptions()).to(dev)
    tp = None
    if n_model > 1:
        from multimodalgame_tpu_torch.parallel.tensor import (
            TensorParallel, init_tp_opt_states, make_mesh_2d)
        mesh = make_mesh_2d(mesh, n_model)
        tp = TensorParallel(mesh, mods, num_classes=NUM_CLASSES)
    chunk = make_multistep_train_step_indexed(
        mods, top_k=6, batch_denom=TRAIN_BATCH, fast="kernel", seed=0,
        device=dev, mesh=mesh, tp=tp)
    opts = (init_opt_states(cfg, mods) if tp is None
            else init_tp_opt_states(cfg, tp))
    plan = train.epoch_indices(0, True, TRAIN_BATCH)[:steps]
    fused_train_forward.launches = 0
    # The first step (the process's lazy set-up with it) apart; the
    # others timed, the collectives counted over them alone; the weights
    # read after MESH_PARAM_STEPS steps and at the end.
    k = MESH_PARAM_STEPS
    bounds = (range(len(plan) + 1) if trace
              else sorted({0, 1, k, len(plan)}))
    axes = [] if mesh is None else [mesh] + (
        [] if mesh.model is None else [mesh.model])
    accs, digests = [], []
    for a, b in zip(bounds, bounds[1:]):
        m = chunk(opts, train.feats, train.targets, plan[a:b], desc, a)
        accs.append(m.accuracy)
        if trace:
            digests.append(weights_digest(mods))
        if a == 0:
            m.accuracy.cpu()
            for axis in axes:
                axis.seconds = axis.grad_seconds = 0.0
                axis.calls = axis.grad_calls = 0
            t0 = time.perf_counter()
        if b == k:
            params_k = {n: p.detach().clone().cpu()
                        for n, p in mods.named_parameters()}
    acc = torch.cat(accs).double().cpu()
    secs = time.perf_counter() - t0
    out = {"accuracy": acc, "params_early": params_k,
           "params": {k: p.detach().clone().cpu()
                      for k, p in mods.named_parameters()},
           "launches": fused_train_forward.launches, "seconds": secs,
           "steps_per_s": (len(plan) - 1) / secs, "digests": digests}
    if mesh is not None:
        out.update(rank=mesh.global_rank, backend=mesh.backend,
                   collective_ms_per_step=1e3 * mesh.seconds
                   / (len(plan) - 1),
                   collective_calls_per_step=mesh.calls / (len(plan) - 1),
                   grad_reduce_ms_per_step=1e3 * mesh.grad_seconds
                   / max(mesh.grad_calls, 1),
                   gloo_cuda=probe)
    if tp is not None:
        out.update(model_collective_ms_per_step=1e3 * mesh.model.seconds
                   / (len(plan) - 1),
                   model_collective_calls_per_step=mesh.model.calls
                   / (len(plan) - 1))
    return out


def params_close(got: dict, want: dict, exclude=("receiver.y2.bias",)):
    """The largest share of JAX's mesh tolerance (rtol 5e-3, atol 1e-5;
    tests/test_mesh_driver.py:80-93 excludes the analytically
    zero-gradient ``receiver.y2.bias``) that a weight's difference takes
    (<= 1 passes), and the three parameters that take the most."""
    use = {}
    for k, w in want.items():
        if k in exclude:
            continue
        err = (got[k].double() - w.double()).abs()
        lim = MESH_PARAM_ATOL + MESH_PARAM_RTOL * w.double().abs()
        i = int((err / lim).argmax())
        use[k] = (float((err / lim).flatten()[i]), float(err.flatten()[i]),
                  float(w.double().flatten()[i]))
    top = sorted(use.items(), key=lambda kv: -kv[1][0])[:3]
    return max(v[0] for v in use.values()), {
        k: {"use": u, "abs_err": e, "weight": w} for k, (u, e, w) in top}


def mesh_step(device, smi):
    """Two ranks sharing the card (gloo on CUDA tensors) train one epoch
    of the canonical game, batch 64 split 32/32, against one device from
    the same seed on the same card; then a one-rank NCCL group through the
    same code. The one device runs twice (it must repeat itself bit for
    bit), and the mesh's arithmetic is run on one device too: two threads
    of this process, each a rank on its 32 rows, their gradients and batch
    statistics summed on the card (``thread_meshes``). That run must equal
    the two ranks bit for bit after every step: then what parts the mesh
    from one device is the order of the sums, which RMSprop amplifies
    (MESH_PARAM_STEPS' note), and not a fault of the mesh."""
    from multimodalgame_tpu_torch.parallel.distributed import launch
    steps = MESH_STEP_STEPS
    one = mesh_train_rank(None, steps, device, trace=True)
    again = mesh_train_rank(None, steps, device, trace=True)
    split = run_threads(mesh_train_rank, thread_meshes(2, device + ":0"),
                        steps, device, 1, True)
    ranks = launch(mesh_train_rank, MESH_DEVICES, (steps, device, 1, True))
    nccl, = launch(mesh_train_rank, [device + ":0"], (steps,),
                   backend="nccl")
    acc_err = max(float((r["accuracy"] - one["accuracy"]).abs().max())
                  for r in ranks)
    same = all(all(bool((r["params"][k] == ranks[0]["params"][k]).all())
                   for k in r["params"]) for r in ranks[1:])
    excess, worst = params_close(ranks[0]["params_early"],
                                 one["params_early"])
    late, late_worst = params_close(ranks[0]["params"], one["params"])
    repeat_use, _ = params_close(again["params"], one["params"])
    repeat_diff = first_difference(one["digests"], again["digests"])
    split_diff = [first_difference(s["digests"], r["digests"])
                  for s, r in zip(split, ranks)]
    split_equal = all(d is None for d in split_diff) and all(
        torch_equal(s["params"], r["params"]) for s, r in zip(split, ranks))
    nccl_excess, _ = params_close(nccl["params"], one["params"])
    nccl_acc_err = float((nccl["accuracy"] - one["accuracy"]).abs().max())
    row = {"phase": "mesh_step", "steps": steps, "ranks": len(ranks),
           "backend": ranks[0]["backend"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "accuracy_max_err": acc_err, "ranks_bit_identical": same,
           "param_tolerance_use": excess, "param_worst": worst,
           "param_steps": MESH_PARAM_STEPS,
           "param_tolerance_use_after_all_steps": late,
           "param_worst_after_all_steps": late_worst,
           "single_device_repeat_use": repeat_use,
           "single_device_first_diff_step": repeat_diff,
           "split_batch_equals_ranks": split_equal,
           "split_batch_first_diff_step": split_diff,
           "split_batch_first_diff_from_one_device": first_difference(
               split[0]["digests"], one["digests"]),
           "steps_per_s_one_device": one["steps_per_s"],
           "steps_per_s_per_rank": [r["steps_per_s"] for r in ranks],
           "grad_reduce_ms_per_step": [r["grad_reduce_ms_per_step"]
                                       for r in ranks],
           "collective_ms_per_step": [r["collective_ms_per_step"]
                                      for r in ranks],
           "collective_calls_per_step": [r["collective_calls_per_step"]
                                         for r in ranks],
           "gloo_cuda_collectives": ranks[0]["gloo_cuda"],
           "nccl_one_rank": {"launches": nccl["launches"],
                             "accuracy_max_err": nccl_acc_err,
                             "param_tolerance_use": nccl_excess,
                             "steps_per_s": nccl["steps_per_s"],
                             "route": "graph"},
           "note": "steps/s with a weights digest after every step",
           "card": smi}
    log(row)
    if (acc_err > 1e-6 or not same or excess > 1
            or any(r["launches"] != steps for r in ranks)
            or nccl["launches"] != steps or nccl_acc_err > 1e-6
            or nccl_excess > 1 or repeat_diff is not None
            or not split_equal):
        # (The two-rank weights after every step are reported above, not
        # held: MESH_PARAM_STEPS's note.)
        raise SystemExit(f"mesh_step: the two ranks do not reproduce the "
                         f"single device: {row}")
    return {"train_launches": sum(r["launches"] for r in ranks)
            + nccl["launches"], "eval_launches": 0, **row}


def mesh_step_cpu() -> int:
    """``--mesh-cpu``: ``mesh_step``'s readings with every rank on the CPU
    (two gloo ranks and two threads against one device, the train
    kernel's plain version sampling), to set beside the card's; no
    result line."""
    from multimodalgame_tpu_torch.parallel.distributed import launch
    steps = MESH_STEP_STEPS
    import torch
    one = mesh_train_rank(None, steps, "cpu", trace=True)
    again = mesh_train_rank(None, steps, "cpu", trace=True)
    # The CPU's products round by how many threads split them: the
    # threads get the ranks' share of them (parallel/distributed.py).
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    split = run_threads(mesh_train_rank, thread_meshes(2, "cpu"), steps,
                        "cpu", 1, True)
    torch.set_num_threads(threads)
    ranks = launch(mesh_train_rank, ["cpu", "cpu"], (steps, "cpu", 1, True))
    log({"phase": "mesh_step_cpu", "steps": steps,
         "param_tolerance_use": params_close(ranks[0]["params_early"],
                                             one["params_early"])[0],
         "param_steps": MESH_PARAM_STEPS,
         "param_tolerance_use_after_all_steps": params_close(
             ranks[0]["params"], one["params"])[0],
         "single_device_first_diff_step": first_difference(
             one["digests"], again["digests"]),
         "split_batch_first_diff_step": [
             first_difference(s["digests"], r["digests"])
             for s, r in zip(split, ranks)],
         "split_batch_first_diff_from_one_device": first_difference(
             split[0]["digests"], one["digests"])})
    return 0


def torch_equal(a: dict, b: dict) -> bool:
    """Two dicts of tensors with the same keys hold equal tensors."""
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


BEST = "Checkpointing with best Development Accuracy: "


def run_messages(path):
    """A log's messages (one ``Log`` call each, their first lines) from
    the first epoch on, the mesh banner left out, up to a later run
    appended to the same log (an -eval_only on its checkpoint, which
    starts at its flag dump)."""
    import re
    text = open(path).read()
    msgs = [m.split("\n")[0] for m in re.split(
        r"^\d\d-\d\d-\d\d \d\d:\d\d:\d\d \[\d\] ", text, flags=re.M)[1:]
        if "Data-parallel mesh" not in m]
    start = msgs.index(next(m for m in msgs
                            if m.startswith("Starting epoch: ")))
    end = next((i for i in range(start, len(msgs))
                if msgs[i].startswith("Flag Values")), len(msgs))
    return msgs[start:end]


def message_kinds(msgs):
    """Each message's kind: every number replaced by ``#``
    (tests/test_mesh_driver.py:96-107), sparkline bars and runs of blanks
    dropped, and the best checkpoint's lines left out. Two runs whose sums
    are taken in other orders part after some hundreds of sampled steps,
    and then the contents of a message (a dump's turns, its bars) differ
    while its kind does not; whether a dev sweep beats the best before it
    differs too, so those lines are held against the run's own sweeps
    (:func:`best_lines_misplaced`)."""
    import re
    kinds = []
    for m in msgs:
        if m.startswith(BEST):
            continue
        head = re.sub(r"[-+]?\d+\.?\d*(e[-+]?\d+)?", "#", m)
        kinds.append(" ".join(re.sub(r"[\u2581-\u2588]", "", head).split()))
    return kinds


def best_lines_misplaced(msgs, save_after: int):
    """The first of a run's messages at which its best-checkpoint lines
    part from its own dev sweeps, else None. The driver writes one, with
    the sweep's accuracy, right after a sweep's three lines where the step
    is at least ``save_after`` and the accuracy beats every earlier such
    one (game/driver.py:382-385; a fresh run starts from 0)."""
    import re
    best, want = 0.0, {}
    for i, m in enumerate(msgs):
        dev = re.match(r"Epoch: \d+ Step: (\d+) Batch: \d+ Development "
                       r"Accuracy: (\S+)$", m)
        if dev and int(dev[1]) >= save_after and float(dev[2]) > best:
            best = float(dev[2])
            want[i + 3] = BEST + dev[2]
    got = {i: m for i, m in enumerate(msgs) if m.startswith(BEST)}
    return next((i for i in sorted(set(got) | set(want))
                 if got.get(i) != want.get(i)), None)


def mesh_drive(device, workdir, smi, driven):
    """``train.run`` with the demo's argv and ``-mesh 2`` on two ranks that
    share the card, against the ``driver`` phase's single-device run;
    then ``-eval_only -mesh 2`` on its ``_best``."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.train import run
    flags = flags_from_argv(DEMO_ARGV + [
        "-mesh", "2", "-max_epoch", str(MESH_DRIVER_EPOCHS), "-log_path",
        os.path.join(workdir, "mesh"), "-experiment_name", "mesh"])
    inputs = canonical_inputs("cpu")
    want = cadence_counts(flags, inputs[2].size, inputs[3].size)
    t0 = time.perf_counter()
    summary = run(flags, device=MESH_DEVICES, inputs=inputs)
    secs = time.perf_counter() - t0
    got, losses, last_dev, timing = read_log(flags, summary)
    ranks = summary["ranks"]
    launches = {k: [r["launches"][k] for r in ranks]
                for k in ("train", "eval")}
    row = {"phase": "mesh_driver", **got, "expected": want,
           "launches_per_rank": launches, "finite_losses": len(losses),
           "last_dev_top6": last_dev, "best_dev_acc": summary["best_dev_acc"],
           "seconds": secs, "run_steps_per_s": want["steps"] / secs,
           "last_epoch_steps_per_s": timing["steps_per_sec"],
           "driver_run_steps_per_s": driven["run_steps_per_s"],
           "accuracy_equal_until_step": next(
               (i for i, (a, b) in enumerate(zip(
                   summary["batch_accuracy"], driven["batch_accuracy"]))
                if abs(a - b) > 1e-6), len(driven["batch_accuracy"])),
           "grad_reduce_ms_per_step": [
               1e3 * r["collectives"]["grad_seconds"]
               / max(r["collectives"]["grad_calls"], 1) for r in ranks],
           "collective_ms_per_step": [
               1e3 * r["collectives"]["seconds"] / want["steps"]
               for r in ranks],
           "collective_calls_per_step": [
               r["collectives"]["calls"] / want["steps"] for r in ranks],
           "step_eager": "Step: eager" in open(flags.log_file).read(),
           "card": smi}
    log(row)
    check_counts("mesh_driver", got, want, losses)
    if not row["step_eager"]:
        raise SystemExit("mesh_driver: two gloo ranks sharing the card "
                         "must step eagerly (Step: eager)")
    if any(n != want["train_launches"] for n in launches["train"]) or any(
            n != want["eval_launches"] for n in launches["eval"]):
        raise SystemExit(f"mesh_driver: launches {launches}, expected "
                         f"{want['train_launches']} and "
                         f"{want['eval_launches']} on each rank")
    # The run's messages are the driver phase's first ones, but for its
    # closing two ("Final step timing", "Finished training.") and its
    # best checkpoints, which follow its own dev sweeps.
    msgs = run_messages(flags.log_file)
    misplaced = best_lines_misplaced(msgs, flags.save_after)
    if misplaced is not None:
        raise SystemExit(f"mesh_driver: rank 0's best-checkpoint lines "
                         f"part from its dev sweeps at message {misplaced}: "
                         f"{msgs[misplaced - 3:misplaced + 1]}")
    got_kinds = message_kinds(msgs)
    want_kinds = message_kinds(run_messages(driven["log_file"]))[
        :len(got_kinds) - 2] + got_kinds[-2:]
    if not (got_kinds[-2].startswith("Final step timing")
            and got_kinds[-1] == "Finished training."):
        raise SystemExit(f"mesh_driver: the log ends in {got_kinds[-2:]}")
    if got_kinds != want_kinds:
        first = next((i for i, (a, b) in enumerate(zip(got_kinds,
                                                       want_kinds))
                      if a != b), min(len(got_kinds), len(want_kinds)))
        raise SystemExit(f"mesh_driver: rank 0's log is not the single-"
                         f"device log message for message: message "
                         f"{first}: {got_kinds[first:first + 2]} against "
                         f"{want_kinds[first:first + 2]}")
    if last_dev < MIN_DEV_TOP6:
        raise SystemExit(f"mesh_driver: dev top-6 {last_dev} is below "
                         f"{MIN_DEV_TOP6}")
    best = check_reloads("mesh_driver", flags, device)
    eval_flags = flags_from_argv(["-log_load", flags.json_file,
                                  "-eval_only", "-mesh", "2", "-checkpoint",
                                  flags.checkpoint + "_best"])
    out = run(eval_flags, device=MESH_DEVICES, inputs=inputs)
    evals = [r["launches"]["eval"] for r in out["ranks"]]
    log({"phase": "mesh_driver", "eval_only_mesh_dev_acc": out["dev_acc"],
         "best_dev_acc": best["best_dev_acc"],
         "eval_only_launches_per_rank": evals})
    if out["dev_acc"] != best["best_dev_acc"]:
        raise SystemExit(f"mesh_driver: -eval_only -mesh 2 gave "
                         f"{out['dev_acc']} on _best, which recorded "
                         f"{best['best_dev_acc']}")
    return {"train_launches": sum(launches["train"]),
            "eval_launches": sum(launches["eval"]) + sum(evals), **row}


def sweep_mesh(device, workdir, smi):
    """``run_sweep`` at ``-population 4`` for 2 epochs with its members
    split over two ranks that share the card, against the unsharded sweep
    from the same seed: every member's dev accuracies equal."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.sweep import run_sweep
    runs = {}
    for name, dev in (("one", device), ("mesh", MESH_DEVICES)):
        flags = flags_from_argv(DEMO_ARGV + SWEEP_MESH_ARGV + [
            "-log_path", os.path.join(workdir, "sweep_mesh_" + name)])
        t0 = time.perf_counter()
        runs[name] = run_sweep(flags, max_steps=SWEEP_MESH_STEPS,
                               eval_every=SWEEP_MESH_EVERY, device=dev,
                               inputs=canonical_inputs(device))
        runs[name]["seconds"] = time.perf_counter() - t0
    accs = {k: [(m["final_dev_acc"], m["best_dev_acc"])
                for m in r["members"]] for k, r in runs.items()}
    dev_rows = canonical_inputs("cpu")[3].size
    rows_apart = max(round(abs(a - b) * dev_rows)
                     for one, two in zip(accs["one"], accs["mesh"])
                     for a, b in zip(one, two))
    row = {"phase": "sweep_mesh", "members": len(accs["mesh"]),
           "ranks": len(runs["mesh"]["ranks"]),
           "steps": runs["mesh"]["steps"], "dev_accuracies": accs,
           "equal": accs["one"] == accs["mesh"],
           "most_dev_rows_apart": rows_apart,
           "winner": [runs["one"]["winner"], runs["mesh"]["winner"]],
           "seconds": {k: r["seconds"] for k, r in runs.items()},
           "game_steps_per_s": {
               k: r["population"] * r["steps"] / r["seconds"]
               for k, r in runs.items()},
           "steps_per_sec_total": {k: r["steps_per_sec_total"]
                                   for k, r in runs.items()},
           "card": smi}
    log(row)
    if (rows_apart > SWEEP_MESH_TIE_ROWS
            or row["winner"][0] != row["winner"][1]):
        raise SystemExit(f"sweep_mesh: the split sweep differs: {row}")
    return {"train_launches": 0, "eval_launches": 0, **row}


def serve_mesh(device, served):
    """The canonical ``Predictor`` over two blocks on the card against the
    one-device ``Predictor``, at batches 1, 64 and 100."""
    import torch
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        compare_outputs, fused_eval_exchange)
    from multimodalgame_tpu_torch.serve import Predictor
    one = served["pred"]
    pred = Predictor(one.cfg, one.modules, one.desc_pack,
                     device=MESH_DEVICES)
    ties, worst, launches = 0, 0.0, 0
    for batch in TIMED_BATCHES:
        x = features(batch, seed=700 + batch)
        fused_eval_exchange.launches = 0
        out = pred.predict(x)
        torch.cuda.synchronize()
        launches += fused_eval_exchange.launches
        ref = one.predict(x)
        same = all(np.array_equal(out[k], ref[k]) for k in (
            "prediction", "sender_messages", "receiver_messages",
            "conversation_length")) and out["n_steps"] == ref["n_steps"]
        err = float(np.abs(out["log_probs"] - ref["log_probs"]).max())
        rep = {"ok": same and err <= 1e-4, "tie_rows": 0}
        if not same:
            # Tie rows only: the blocks' records against the whole's.
            data = torch.from_numpy(x).to(device)
            with torch.inference_mode():
                whole = one._exchange(data, one._desc)
                per = len(x) // 2 if len(x) % 2 == 0 else len(x)
                parts = [pred._exchange(data[i:i + per], pred._desc)
                         for i in range(0, len(x), per)]
            got = whole._replace(**{k: torch.cat(
                [getattr(p, k) for p in parts], dim=1) for k in (
                "stop_feats", "stop_probs", "sen_feats", "sen_probs",
                "rec_feats", "rec_probs", "y")})
            rep = compare_outputs(one.cfg, got, whole)
        log({"phase": "serve_mesh", "batch": batch,
             "blocks": 2 if batch % 2 == 0 else 1, "equal": same,
             "max_log_prob_err": err, **rep})
        if not rep["ok"]:
            raise SystemExit(f"serve_mesh: batch {batch} differs from one "
                             f"device: {rep}")
        ties += rep["tie_rows"]
        worst = max(worst, err)
    return {"launches": launches, "eval_launches": launches,
            "train_launches": 0, "tie_rows": ties, "max_abs_err": worst}


def run_mesh_paths(workdir, smi, served, driven) -> dict:
    """This slice's paths: the split train kernel, the two-rank step, the
    driver and -eval_only on a mesh, the split sweep and serving."""
    return {"row_base": check_row_base("cuda"),
            "mesh_step": mesh_step("cuda", smi),
            "mesh_driver": mesh_drive("cuda", workdir, smi, driven),
            "sweep_mesh": sweep_mesh("cuda", workdir, smi),
            "serve_mesh": serve_mesh("cuda", served)}


# ------------------------------------ the kernel route, tensor parallelism,
# ------------------------------------ the feature extractor

def big_inputs(device):
    """The big game's sets (BIG_CLASSES classes of BIG_TRAIN_PER_CLASS
    and 1 example, features made as ``features`` makes them) and its
    GloVe-300 descriptions, random from seeds."""
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    proto = np.random.RandomState(1234).randn(BIG_CLASSES, 512)

    def split(per_class, seed):
        rng = np.random.RandomState(seed)
        labels = np.repeat(np.arange(BIG_CLASSES), per_class)
        feats = np.abs(proto[labels] + 0.3 * rng.randn(len(labels), 512))
        return DeviceDataset(feats.astype(np.float32), labels,
                             device=device)

    desc = np.random.RandomState(7).randn(BIG_CLASSES, 300).astype(
        np.float32)
    pack = DescriptionPack(desc, desc, [1] * BIG_CLASSES,
                           {i: i for i in range(BIG_CLASSES)},
                           {i: f"class{i}" for i in range(BIG_CLASSES)})
    return (pack, pack, split(BIG_TRAIN_PER_CLASS, 11), split(1, 12))


def run_big(flags, inputs, device, phase, smi):
    """``train.run`` of the big game for BIG_STEPS steps with both
    kernels' counts set to 0 just before it: its log's counts, losses
    and sampler line, the last epoch's steps/s and each rank's (or this
    process's) peak memory."""
    import torch
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.train import run
    fused_train_forward.launches = fused_eval_exchange.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = run(flags, max_steps=BIG_STEPS, device=device, inputs=inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ranks = summary.get("ranks")
    launches = ({k: [r["launches"][k] for r in ranks]
                 for k in ("train", "eval")} if ranks else
                {"train": [fused_train_forward.launches],
                 "eval": [fused_eval_exchange.launches]})
    peak = ([r["peak_memory_bytes"] for r in ranks] if ranks
            else [torch.cuda.max_memory_allocated()])
    got, losses, _, timing = read_log(flags, summary)
    text = open(flags.log_file).read()
    row = {"phase": phase, "steps": summary["step"],
           "launches_per_rank": launches,
           "sampler_line": "Phase A sampler: plain" in text,
           "finite_losses": len(losses),
           "all_losses_finite": bool(losses) and bool(
               np.all(np.isfinite(losses))),
           "last_epoch_steps_per_s": timing["steps_per_sec"],
           "seconds": secs, "peak_memory_bytes_per_rank": peak,
           "card": smi}
    if ranks:
        row["model_collective_calls_per_step"] = [
            r["collectives"]["model"]["calls"] / summary["step"]
            for r in ranks]
        row["model_collective_ms_per_step"] = [
            1e3 * r["collectives"]["model"]["seconds"] / summary["step"]
            for r in ranks]
    log(row)
    if (summary["step"] != BIG_STEPS or not row["sampler_line"]
            or not row["all_losses_finite"]
            or any(n for v in launches.values() for n in v)):
        raise SystemExit(f"{phase}: the big game did not train {BIG_STEPS} "
                         f"steps on the plain conversation with finite "
                         f"losses and no kernel launch: {row}")
    return summary, row


def route_big(device, workdir, smi):
    """The big game (bench.py:514-520) at float32, batch 256, 1,000
    classes: no launch plan of either kernel fits, so ``train.run``
    trains it on the plain conversation and ``Predictor`` answers on it."""
    import torch
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.game.config import GameConfig
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        eval_kernel_supports, find_plan, fused_eval_exchange,
        supports_config, train_kernel_supports)
    from multimodalgame_tpu_torch.serve import Predictor
    flags = flags_from_argv(DEMO_ARGV + BIG_ARGV + ["-log_path", workdir])
    cfg = GameConfig.from_flags(flags)
    sizes = (cfg.img_feat_dim, cfg.img_h_dim, cfg.rec_w_dim,
             cfg.rec_hidden, BIG_CLASSES, cfg.wv_dim, flags.batch_size)
    route = {"supports_config": supports_config(cfg),
             "plan": find_plan(*sizes),
             "eval_kernel": eval_kernel_supports(cfg, flags.batch_size,
                                                 BIG_CLASSES),
             "train_kernel": train_kernel_supports(cfg, flags.batch_size,
                                                   BIG_CLASSES)}
    # The kernel's function at these shapes, were it run: its bound.
    log({"phase": "route_big", "sizes_FHWRDVB": sizes, **route,
         "kernel_bound": work(cfg, flags.batch_size, num_desc=BIG_CLASSES)})
    if route["plan"] is not None or route["eval_kernel"] \
            or route["train_kernel"] or not route["supports_config"]:
        raise SystemExit(f"route_big: expected a supported config with no "
                         f"launch plan: {route}")
    inputs = big_inputs(device)
    summary, row = run_big(flags, inputs, device, "route_big", smi)
    pred = Predictor(cfg, summary["modules"], inputs[1], device=device)
    x = inputs[3].feats[:BIG_BATCH].cpu().numpy()
    fused_eval_exchange.launches = 0
    out = pred.predict(x)
    torch.cuda.synchronize()
    served = {"batch": len(x), "eval_launches": fused_eval_exchange.launches,
              "finite": bool(np.isfinite(out["log_probs"]).all()),
              "log_probs_shape": list(out["log_probs"].shape)}
    log({"phase": "route_big", "predictor": served, "card": smi})
    if served["eval_launches"] or not served["finite"] or \
            served["log_probs_shape"] != [BIG_BATCH, BIG_CLASSES]:
        raise SystemExit(f"route_big: the Predictor request {served}")
    return {"train_launches": 0, "eval_launches": 0,
            "steps_per_s": row["last_epoch_steps_per_s"],
            "peak_memory_bytes": row["peak_memory_bytes_per_rank"][0]}


def tp_step(device, smi):
    """Two ranks sharing the card as a (1 data x 2 model) grid train one
    epoch of the canonical game through the train kernel against one
    device from the same seed, as ``mesh_step`` holds data parallelism."""
    from multimodalgame_tpu_torch.parallel.distributed import launch
    steps = MESH_STEP_STEPS
    one = mesh_train_rank(None, steps, device)
    ranks = launch(mesh_train_rank, MESH_DEVICES, (steps, "cuda", 2))
    acc_err = max(float((r["accuracy"] - one["accuracy"]).abs().max())
                  for r in ranks)
    same = all(all(bool((r["params"][k] == ranks[0]["params"][k]).all())
                   for k in r["params"]) for r in ranks[1:])
    excess, worst = params_close(ranks[0]["params_early"],
                                 one["params_early"])
    late, late_worst = params_close(ranks[0]["params"], one["params"])
    row = {"phase": "tp_step", "steps": steps, "grid": [1, 2],
           "backend": ranks[0]["backend"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "accuracy_max_err": acc_err, "ranks_bit_identical": same,
           "param_tolerance_use": excess, "param_worst": worst,
           "param_steps": MESH_PARAM_STEPS,
           "param_tolerance_use_after_all_steps": late,
           "param_worst_after_all_steps": late_worst,
           "steps_per_s_one_device": one["steps_per_s"],
           "steps_per_s_per_rank": [r["steps_per_s"] for r in ranks],
           "model_collective_calls_per_step": [
               r["model_collective_calls_per_step"] for r in ranks],
           "model_collective_ms_per_step": [
               r["model_collective_ms_per_step"] for r in ranks],
           "data_collective_calls_per_step": [
               r["collective_calls_per_step"] for r in ranks],
           "card": smi}
    log(row)
    if (acc_err > 1e-6 or not same or excess > 1
            or any(r["launches"] != steps for r in ranks)
            or any(r["model_collective_calls_per_step"] != TP_MODEL_CALLS
                   for r in ranks)):
        raise SystemExit(f"tp_step: the grid does not reproduce the "
                         f"single device: {row}")
    return {"train_launches": sum(r["launches"] for r in ranks),
            "eval_launches": 0, **row}


def tp_drive(device, workdir, smi):
    """``train.run`` with the demo's argv on a (1 data x 2 model) grid of
    two ranks sharing the card for TP_EPOCHS epochs, then ``-eval_only``
    on the same grid reproducing _best's ``best_dev_acc``; the .pt files
    reload in the single-device layout."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.train import run
    flags = flags_from_argv(DEMO_ARGV + TP_ARGV + [
        "-max_epoch", str(TP_EPOCHS), "-log_path",
        os.path.join(workdir, "tp"), "-experiment_name", "tp"])
    inputs = canonical_inputs("cpu")
    want = cadence_counts(flags, inputs[2].size, inputs[3].size)
    t0 = time.perf_counter()
    summary = run(flags, device=MESH_DEVICES, inputs=inputs)
    secs = time.perf_counter() - t0
    got, losses, last_dev, timing = read_log(flags, summary)
    ranks = summary["ranks"]
    launches = {k: [r["launches"][k] for r in ranks]
                for k in ("train", "eval")}
    row = {"phase": "tp_driver", **got, "expected": want,
           "launches_per_rank": launches, "finite_losses": len(losses),
           "last_dev_top6": last_dev, "best_dev_acc": summary["best_dev_acc"],
           "seconds": secs, "run_steps_per_s": want["steps"] / secs,
           "last_epoch_steps_per_s": timing["steps_per_sec"],
           "model_collective_calls_per_step": [
               r["collectives"]["model"]["calls"] / want["steps"]
               for r in ranks],
           "model_collective_ms_per_step": [
               1e3 * r["collectives"]["model"]["seconds"] / want["steps"]
               for r in ranks],
           "banner": "Mesh: 2 devices = 1 data x 2 model" in open(
               flags.log_file).read(),
           "step_eager": "Step: eager" in open(flags.log_file).read(),
           "card": smi}
    log(row)
    check_counts("tp_driver", got, want, losses)
    if not row["banner"] or not row["step_eager"] or any(
            n != want["train_launches"] for n in launches["train"]) or any(
            n != want["eval_launches"] for n in launches["eval"]):
        raise SystemExit(f"tp_driver: launches {launches}, the banner or "
                         f"Step: eager (gloo ranks), expected "
                         f"{want['train_launches']} and "
                         f"{want['eval_launches']} on each rank")
    best = check_reloads("tp_driver", flags, device)
    eval_flags = flags_from_argv(["-log_load", flags.json_file,
                                  "-eval_only", "-checkpoint",
                                  flags.checkpoint + "_best"] + TP_ARGV)
    out = run(eval_flags, device=MESH_DEVICES, inputs=inputs)
    evals = [r["launches"]["eval"] for r in out["ranks"]]
    log({"phase": "tp_driver", "eval_only_grid_dev_acc": out["dev_acc"],
         "best_dev_acc": best["best_dev_acc"],
         "eval_only_launches_per_rank": evals})
    if out["dev_acc"] != best["best_dev_acc"]:
        raise SystemExit(f"tp_driver: -eval_only on the grid gave "
                         f"{out['dev_acc']} on _best, which recorded "
                         f"{best['best_dev_acc']}")
    return {"train_launches": sum(launches["train"]),
            "eval_launches": sum(launches["eval"]) + sum(evals), **row}


def tp_grid(device, workdir, smi):
    """``train.run`` on a (2 data x 2 model) grid of four ranks sharing
    the card for TP_GRID_STEPS steps: both axes' collectives run."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.train import run
    flags = flags_from_argv(DEMO_ARGV + [
        "-mesh", "4", "-mesh_model", "2", "-log_path",
        os.path.join(workdir, "tp_grid"), "-experiment_name", "tp_grid"])
    summary = run(flags, max_steps=TP_GRID_STEPS, device=MESH_DEVICES * 2,
                  inputs=canonical_inputs("cpu"))
    ranks = summary["ranks"]
    row = {"phase": "tp_grid", "grid": [2, 2], "steps": summary["step"],
           "launches_per_rank": [r["launches"]["train"] for r in ranks],
           "data_grad_calls_per_rank": [r["collectives"]["grad_calls"]
                                        for r in ranks],
           "model_calls_per_rank": [r["collectives"]["model"]["calls"]
                                    for r in ranks],
           "accuracy": summary["batch_accuracy"], "card": smi}
    log(row)
    if (summary["step"] != TP_GRID_STEPS
            or any(n != TP_GRID_STEPS for n in row["launches_per_rank"])
            or any(n != TP_GRID_STEPS
                   for n in row["data_grad_calls_per_rank"])
            or any(n < TP_GRID_STEPS * TP_MODEL_CALLS
                   for n in row["model_calls_per_rank"])
            or not np.all(np.isfinite(summary["batch_accuracy"]))):
        raise SystemExit(f"tp_grid: {row}")
    return {"train_launches": sum(row["launches_per_rank"]),
            "eval_launches": sum(r["launches"]["eval"] for r in ranks),
            **row}


def tp_big(device, workdir, smi, routed):
    """The big game on a (1 data x 2 model) grid of two ranks sharing the
    card for BIG_STEPS steps: the plain conversation on both ranks, the
    class head split 500/500; steps/s beside ``route_big``'s."""
    from multimodalgame_tpu_torch.config import flags_from_argv
    flags = flags_from_argv(DEMO_ARGV + BIG_ARGV + TP_ARGV + [
        "-log_path", os.path.join(workdir, "tp_big"), "-experiment_name",
        "tp_big"])
    inputs = big_inputs("cpu")
    _, row = run_big(flags, inputs, MESH_DEVICES, "tp_big", smi)
    out = {"steps_per_s": row["last_epoch_steps_per_s"],
           "over_one_device": row["last_epoch_steps_per_s"]
           / routed["steps_per_s"],
           "peak_memory_bytes_per_rank": row["peak_memory_bytes_per_rank"],
           "peak_over_one_device": [
               p / routed["peak_memory_bytes"]
               for p in row["peak_memory_bytes_per_rank"]]}
    log({"phase": "tp_big", **out, "card": smi})
    return {"train_launches": 0, "eval_launches": 0, **out}


def extract(device, smi):
    """``resnet34_features`` at ``random_state_dict(0)`` on EXTRACT_IMAGES
    images of 3 x 227 x 227: the card against the port on the CPU for
    ``layer4_2``, ``avgpool_512`` and ``fc`` (rtol/atol 1e-3, JAX's
    tests/test_resnet.py:88-99), and images/s on the card."""
    import torch
    from multimodalgame_tpu_torch.models.resnet import (random_params,
                                                        resnet34_features)
    taps = ("layer4_2", "avgpool_512", "fc")
    x = (np.random.RandomState(0).randn(EXTRACT_IMAGES, 3, 227, 227)
         * 0.25).astype(np.float32)
    cpu = resnet34_features(random_params(0, "cpu"), torch.from_numpy(x),
                            taps)
    params = random_params(0, device)
    xd = torch.from_numpy(x).to(device)
    got = resnet34_features(params, xd, taps)
    errs = {}
    for k in taps:
        a, b = got[k].cpu().double(), cpu[k].double()
        errs[k] = {"max_abs_err": float((a - b).abs().max()),
                   "tolerance_use": float(((a - b).abs()
                                           / (1e-3 + 1e-3 * b.abs())).max()),
                   "shape": list(a.shape)}
    ms = host_median_ms(lambda: (resnet34_features(params, xd, taps),
                                 torch.cuda.synchronize()))
    row = {"phase": "extract", "images": EXTRACT_IMAGES, "taps": errs,
           "ms": ms, "images_per_s": EXTRACT_IMAGES / ms * 1e3,
           "tf32": False, "card": smi}
    log(row)
    if any(v["tolerance_use"] > 1 for v in errs.values()):
        raise SystemExit(f"extract: the card parts from the CPU: {errs}")
    return row


def run_tp_paths(workdir, smi) -> dict:
    """This slice's paths: the kernel route at the big game, tensor
    parallelism (the step, the driver and -eval_only, a 2 x 2 grid, the
    big game) and the feature extractor."""
    routed = route_big("cuda", workdir, smi)
    return {"route_big": routed,
            "tp_step": tp_step("cuda", smi),
            "tp_driver": tp_drive("cuda", workdir, smi),
            "tp_grid": tp_grid("cuda", workdir, smi),
            "tp_big": tp_big("cuda", workdir, smi, routed),
            "extract": extract("cuda", smi)}


def work(cfg, batch: int, uniform_floats: int = 0,
         num_desc: int = NUM_CLASSES):
    """Operations and bytes one call needs at these shapes: every product
    of _kernel, each input read once (``uniform_floats`` counts the train
    mode's uniforms where they are read), each output written once.
    Only f32 operations count: Philox's integer work is left out."""
    from multimodalgame_tpu_torch.ops.cuda_exchange import param_shapes
    F, H, W = cfg.img_feat_dim, cfg.img_h_dim, cfg.rec_w_dim
    R, V, D, T, B = (cfg.rec_hidden, cfg.wv_dim, num_desc, cfg.max_exchange,
                     batch)
    flops = 2 * B * F * H + 2 * D * V * R + 2 * W * H
    per_turn = (2 * B * H * W                     # binary layer
                + 2 * B * (W + R) * 3 * R         # GRU
                + 2 * B * R * (1 + 2 * R)         # s, y1_h, w_h heads
                + 4 * B * D * R                   # add, relu, y2 multiply-add
                + 2 * B * D * V                   # softmax . desc
                + 2 * B * V * R                   # w_d
                + 2 * B * R * W)                  # w
    flops += T * per_turn + (T - 1) * 2 * B * W * H   # code layer, t > 0
    n_in = B * F + D * V + W + uniform_floats + sum(
        int(np.prod(s)) for s in param_shapes(cfg).values())
    n_out = T * B * (3 + 4 * W + D)
    nbytes = 4 * (n_in + n_out)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def event_median_ms(fn, sleep: bool = False) -> float:
    """Median CUDA-event time around one call of ``fn`` on an idle card:
    the host's launch work (the wrapper, ctypes, the launch call) and the
    device's work. With ``sleep`` the card first sleeps SLEEP_CYCLES
    while the host enqueues the events and the call, so the events time
    the device's work alone."""
    import torch
    for _ in range(10):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_median_ms(fn) -> float:
    return event_median_ms(fn, sleep=True)


def host_launch_ms(fn) -> float:
    """Median host time of one call of ``fn`` that only launches work (the
    wrapper's checks, allocations, ctypes and the launch call); the card is
    synchronized after each call, outside the timed span."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
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


def sm_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_split(cfg, params, data, desc):
    """Block 0's SM cycles per phase of one conversation, summed over the
    turns, from the stamped build: the eval instance, then the train
    instance with Philox and with given uniforms, on the same inputs."""
    import torch
    from multimodalgame_tpu_torch.ops.cuda_exchange import phase_clocks
    from multimodalgame_tpu_torch.ops.philox import philox_uniforms
    u = philox_uniforms(cfg, data.shape[0], 0, 1, device=data.device)
    runs = {"eval": dict(),
            "train_philox": dict(train=True, seed=0, step=1),
            "train_uniforms": dict(train=True, uniforms=u)}
    out = {}
    with torch.inference_mode():
        for name, kw in runs.items():
            reps = [phase_clocks(cfg, params, data, desc, **kw)
                    for _ in range(5)]
            split = {k: statistics.median(r[k] for r in reps)
                     for k in reps[0]}
            slowest = split.pop("slowest_cta")
            total = sum(split.values())
            out[name] = dict(split, slowest_cta=slowest)
            log({"phase": "timing", "phase_cycles": name,
                 "batch": data.shape[0], "turns": cfg.max_exchange,
                 "total_cycles": total, "slowest_cta_cycles": slowest,
                 "cycles": split,
                 "share": {k: v / total for k, v in split.items()},
                 "sm_clocks": sm_clocks()})
    return out


def latency_floor(cfg, batch: int, num_desc: int):
    """The least time the conversation's dependence chain allows on this
    card: T x (exchanges x one measured exchange link + CTA barriers x one
    measured CTA link), a link being a dependent shared-memory load, a
    warp reduction and the barrier or push-and-wait (the stamped build's
    probe kernel), at the SM clock nvidia-smi reports."""
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        CTA_BARRIERS, EXCHANGES, link_cycles, plan_for)
    plan = plan_for(cfg, batch, num_desc)
    cta = link_cycles(1)
    exchange = link_cycles(plan.cluster)
    per_turn = EXCHANGES * exchange + CTA_BARRIERS * cta
    clocks = sm_clocks()
    mhz = float(clocks.split(",")[0].split()[0])
    row = {"phase": "timing", "latency_floor_ms":
           cfg.max_exchange * per_turn / (mhz * 1e3),
           "cta_link_cycles": cta, "exchange_link_cycles": exchange,
           "cluster": plan.cluster, "links_a_turn": [EXCHANGES,
                                                     CTA_BARRIERS],
           "sm_clocks": clocks}
    log(row)
    return row


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
            kd_ms = device_median_ms(lambda: fused_eval_exchange(
                cfg, params, data, pred._desc))
            kh_ms = host_launch_ms(lambda: fused_eval_exchange(
                cfg, params, data, pred._desc))
            p_ms = event_median_ms(lambda: fused_eval_exchange_reference(
                cfg, params, data, pred._desc))
        e2e_ms = host_median_ms(lambda: pred.predict(x))
        row = {"phase": "timing", "batch": batch, "kernel_ms": k_ms,
               "kernel_device_ms": kd_ms, "kernel_host_ms": kh_ms,
               "plain_ms": p_ms,
               "predict_ms": e2e_ms, **work(cfg, batch)}
        log(row)
        rows[batch] = row
    # One turn instead of ten, same weights, device time: (t10 - t1) / 9
    # is a turn.
    one = dataclasses.replace(cfg, max_exchange=1)
    data = torch.from_numpy(features(64, seed=564)).to(device)
    with torch.inference_mode():
        t1 = device_median_ms(lambda: fused_eval_exchange(
            one, params, data, pred._desc))
    t10 = rows[64]["kernel_device_ms"]
    log({"phase": "timing", "batch": 64, "kernel_device_ms_1_turn": t1,
         "kernel_device_ms_per_turn": (t10 - t1) / (cfg.max_exchange - 1)})
    rows["phases"] = phase_split(cfg, params, data, pred._desc)
    rows["floor"] = latency_floor(cfg, 64, pred._desc.shape[0])
    return rows


def train_timing(device, trained):
    """Both random modes of the train kernel and its plain version at
    batches 1, 64, 100; then, at batch 64, the whole training step and its
    phase A (weights packed plus the kernel), on the trained agents."""
    import torch
    from multimodalgame_tpu_torch.game.fast_train import sample_conversation
    from multimodalgame_tpu_torch.game.fast_train import compute_losses_fast
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward,
        fused_train_forward_reference, kernel_params)
    from multimodalgame_tpu_torch.ops.philox import philox_uniforms
    from multimodalgame_tpu_torch.ops.sampling import uniform_widths
    mods, desc, train = trained["mods"], trained["desc"], trained["train"]
    cfg = mods.cfg
    params = kernel_params(mods)
    rows = {}
    for batch in TIMED_BATCHES:
        data = train.feats[:batch].contiguous()
        u = philox_uniforms(cfg, batch, 0, 1, device=device)
        with torch.inference_mode():
            k_ms = event_median_ms(lambda: fused_train_forward(
                cfg, params, data, desc, seed=0, step=1))
            kd_ms = device_median_ms(lambda: fused_train_forward(
                cfg, params, data, desc, seed=0, step=1))
            kh_ms = host_launch_ms(lambda: fused_train_forward(
                cfg, params, data, desc, seed=0, step=1))
            ku_ms = event_median_ms(lambda: fused_train_forward(
                cfg, params, data, desc, uniforms=u))
            p_ms = event_median_ms(lambda: fused_train_forward_reference(
                cfg, params, data, desc, u))
            # The eval mode on the same weights and data, for comparison.
            e_ms = event_median_ms(lambda: fused_eval_exchange(
                cfg, params, data, desc))
            ed_ms = device_median_ms(lambda: fused_eval_exchange(
                cfg, params, data, desc))
        n_u = cfg.max_exchange * batch * sum(
            uniform_widths(cfg, train=True).values())
        with_u = work(cfg, batch, uniform_floats=n_u)
        row = {"phase": "timing", "kernel": "fused_train_forward",
               "batch": batch, "kernel_ms": k_ms,
               "kernel_device_ms": kd_ms, "kernel_host_ms": kh_ms,
               "kernel_ms_given_uniforms": ku_ms, "plain_ms": p_ms,
               "eval_kernel_ms_same_inputs": e_ms,
               "eval_kernel_device_ms_same_inputs": ed_ms,
               "train_over_eval": k_ms / e_ms,
               "train_over_eval_device": kd_ms / ed_ms,
               "bound_ms_given_uniforms": with_u["bound_ms"],
               "bound_by_given_uniforms": with_u["bound_by"],
               **work(cfg, batch)}
        log(row)
        rows[batch] = row
    # One turn instead of ten, same weights and data, device time:
    # (t10 - t1) / 9 is a turn of the train instance.
    one = dataclasses.replace(cfg, max_exchange=1)
    data = train.feats[:TRAIN_BATCH].contiguous()
    with torch.inference_mode():
        t1 = device_median_ms(lambda: fused_train_forward(
            one, params, data, desc, seed=0, step=1))
    t10 = rows[TRAIN_BATCH]["kernel_device_ms"]
    log({"phase": "timing", "kernel": "fused_train_forward",
         "batch": TRAIN_BATCH, "kernel_device_ms_1_turn": t1,
         "kernel_device_ms_per_turn": (t10 - t1) / (cfg.max_exchange - 1)})

    # The step and phase A at batch 64, host clock around work that ends
    # in a synchronize; the steps go on training the same agents.
    chunk, opts = trained["chunk"], trained["opts"]
    plan = train.epoch_indices(EPOCHS, True, TRAIN_BATCH)
    counter = {"step": trained["steps"]}

    def one_step():
        i = counter["step"]
        chunk(opts, train.feats, train.targets,
              plan[i % len(plan)][None], desc, i)
        counter["step"] += 1
        torch.cuda.synchronize()

    batch_idx = torch.from_numpy(plan[0]).to(device)
    data, target = train.feats[batch_idx], train.targets[batch_idx]

    def phase_a():
        sample_conversation(mods, data, desc, "kernel", seed=0, step=1)
        torch.cuda.synchronize()

    def forward(backward: bool):
        mods.zero_grad(set_to_none=True)
        total, _ = compute_losses_fast(mods, data, target, desc, 6,
                                       TRAIN_BATCH, sampler="kernel",
                                       seed=0, step=1)
        if backward:
            total.backward()
        torch.cuda.synchronize()

    row = step_breakdown(one_step, phase_a, forward)
    row["train_kernel_ms"] = rows[TRAIN_BATCH]["kernel_ms"]
    # Phase A inside the replayed step is the train kernel's device time.
    row["phase_a_share"] = (rows[TRAIN_BATCH]["kernel_device_ms"]
                            / row["train_step_ms"])
    log(row)
    rows["step"] = row
    return rows


def step_breakdown(one_step, phase_a, forward) -> dict:
    """Host-clock medians of a training step (on the trainer's route: the
    graph on one card), and of its phase A and its forward pass without
    and with the backward pass launched eagerly (each ends in a
    synchronize), then the device's kernels a step and busy share over a
    few profiled steps (the profiler adds its own host overhead). The
    eager pieces are not parts of the replayed step's time, so no share
    of it is derived from them."""
    step_ms = host_median_ms(one_step)
    a_ms = host_median_ms(phase_a)
    fwd_ms = host_median_ms(lambda: forward(False))
    fwd_bwd_ms = host_median_ms(lambda: forward(True))
    return {"phase": "timing", "batch": TRAIN_BATCH, "train_step_ms": step_ms,
            "steps_per_s": 1e3 / step_ms, "eager_phase_a_ms": a_ms,
            "eager_forward_ms": fwd_ms,
            "eager_backward_ms": fwd_bwd_ms - fwd_ms,
            **profile_steps(one_step)}


def profile_steps(one_step, n_prof: int = 5) -> dict:
    """The device's kernels a step and its busy share over ``n_prof``
    profiled steps (the profiler adds its own host overhead), the kernels
    that took the most device time, and the host's calls that put work
    on the card (HOST_LAUNCH_CALLS) a step, by name and in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one_step()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_events = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device_events)
    launches = sum(e.count for e in device_events)
    top = sorted(device_events, key=lambda e: -e.self_device_time_total)[:5]
    calls = {name: sum(e.count for e in events if e.key == name) / n_prof
             for name in HOST_LAUNCH_CALLS}
    return {"profiled_steps": n_prof,
            "device_kernels_per_step": launches / n_prof,
            "device_busy_share": (device_us / wall_us) if device_us else None,
            "top_device_kernels_us_per_step": [
                [e.key[:60], e.self_device_time_total / n_prof]
                for e in top],
            "host_calls_per_step": {k: v for k, v in calls.items() if v},
            "host_launch_calls_per_step": sum(calls.values())}


def attention_timing(device, attention):
    """The AdaptiveAttention step at batch 64 on the trained agents:
    phase A on the plain conversation (uniforms drawn by Philox on the
    card, as the driver's steps draw them; the draw alone is
    ``philox_ms``), the forward and backward passes, and the device's
    share."""
    import torch
    from multimodalgame_tpu_torch.game.fast_train import (
        compute_losses_fast, sample_conversation)
    from multimodalgame_tpu_torch.game.train import (
        make_multistep_train_step_indexed)
    from multimodalgame_tpu_torch.ops.philox import philox_uniforms
    mods, opts = attention["summary"]["modules"], \
        attention["summary"]["opt_states"]
    train, desc = attention["train"], attention["desc"]
    chunk = make_multistep_train_step_indexed(
        mods, top_k=6, batch_denom=TRAIN_BATCH, seed=0, device=device)
    plan = train.epoch_indices(0, True, TRAIN_BATCH)
    counter = {"step": 0}

    def one_step():
        i = counter["step"]
        chunk(opts, train.feats, train.targets, plan[i % len(plan)][None],
              desc, i, feats_context=train.context)
        counter["step"] += 1
        torch.cuda.synchronize()

    rows = torch.from_numpy(plan[0]).to(device)
    data, ctx = train.feats[rows], train.context[rows]
    target = train.targets[rows]

    def phase_a():
        sample_conversation(mods, data, desc, "plain", uniforms=(
            philox_uniforms(mods.cfg, TRAIN_BATCH, 0, 1, device)),
            data_context=ctx)
        torch.cuda.synchronize()

    def forward(backward: bool):
        mods.zero_grad(set_to_none=True)
        total, _ = compute_losses_fast(
            mods, data, target, desc, 6, TRAIN_BATCH,
            uniforms=philox_uniforms(mods.cfg, TRAIN_BATCH, 0, 1, device),
            data_context=ctx)
        if backward:
            total.backward()
        torch.cuda.synchronize()

    def draw():
        philox_uniforms(mods.cfg, TRAIN_BATCH, 0, 1, device)
        torch.cuda.synchronize()

    row = step_breakdown(one_step, phase_a, forward)
    row["config"] = "AdaptiveAttention"
    row["philox_ms"] = host_median_ms(draw)
    log(row)
    return row


def times_only(out: str = None, other: str = None) -> int:
    """``--times``: the probe, then at batch 64 on random canonical
    weights the times of both kernels (``ms``, ``device_ms`` and the host
    time of the launch), of ``Predictor.predict`` and of one step of the
    bare trainer (host ms, then kernels a step and busy share); no result
    line. It builds nothing itself and calls only entry points that every
    tree of the port with a training step has, so the same script times an
    older tree of the port beside this one. ``out``: where to save the
    weights after the trainer's first MESH_PARAM_STEPS steps from seed 0;
    ``other``: another tree's such file, against which this tree's
    weights are reported: bit-equal or not, the largest change from the
    start, the three largest differences, and the share of JAX's mesh
    tolerance they take (``params_close``)."""
    import torch
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    from multimodalgame_tpu_torch.game.agents import (AgentModules,
                                                      init_params)
    from multimodalgame_tpu_torch.game.train import (
        init_opt_states, make_multistep_train_step_indexed)
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward, kernel_params)
    from multimodalgame_tpu_torch.serve import Predictor
    smi = probe()
    cfg = canonical_cfg(**TRAIN_HP)
    params = kernel_params(make_agents(cfg, "cuda"))
    x = features(64, seed=564)
    data = torch.from_numpy(x).to("cuda")
    desc = torch.from_numpy(descriptions()).to("cuda")
    pack = DescriptionPack(descriptions(), descriptions(), [1] * NUM_CLASSES)
    pred = Predictor(canonical_cfg(), make_agents(canonical_cfg(), "cuda"),
                     pack, device="cuda")

    def ev():
        return fused_eval_exchange(cfg, params, data, desc)

    def tr():
        return fused_train_forward(cfg, params, data, desc, seed=0, step=1)

    with torch.inference_mode():
        row = {"phase": "timing", "batch": 64,
               "eval_kernel_ms": event_median_ms(ev),
               "eval_kernel_device_ms": device_median_ms(ev),
               "eval_kernel_host_ms": host_launch_ms(ev),
               "train_kernel_ms": event_median_ms(tr),
               "train_kernel_device_ms": device_median_ms(tr),
               "train_kernel_host_ms": host_launch_ms(tr)}
    row["predict_ms"] = host_median_ms(lambda: pred.predict(x))
    import inspect
    if "graph" in inspect.signature(Predictor).parameters:
        eager_pred = Predictor(canonical_cfg(),
                               make_agents(canonical_cfg(), "cuda"), pack,
                               device="cuda", graph=False)
        row["predict_ms_eager"] = host_median_ms(
            lambda: eager_pred.predict(x))

    mods = init_params(AgentModules(cfg), seed=0, device="cuda")
    train = DeviceDataset(*synthetic_set(TRAIN_PER_CLASS, seed=1),
                          device="cuda")
    chunk = make_multistep_train_step_indexed(
        mods, top_k=6, batch_denom=TRAIN_BATCH, fast="kernel", seed=0,
        device="cuda")
    opts = init_opt_states(cfg, mods)
    plan = train.epoch_indices(0, True, TRAIN_BATCH)
    start = {n: p.detach().clone().cpu()
             for n, p in mods.named_parameters()}
    k = MESH_PARAM_STEPS
    chunk(opts, train.feats, train.targets, plan[:k], desc, 0)
    after = {n: p.detach().clone().cpu() for n, p in mods.named_parameters()}
    if out:
        torch.save(after, out)
    if other:
        want = torch.load(other)
        diff = {n: float((after[n] - w).abs().max()) for n, w in want.items()}
        row["change_steps"] = k
        row["change_bit_equal"] = all(torch.equal(after[n], w)
                                      for n, w in want.items())
        row["change_max_abs"] = max(float((w - start[n]).abs().max())
                                    for n, w in want.items())
        row["change_worst_abs_diff"] = sorted(
            diff.items(), key=lambda kv: -kv[1])[:3]
        row["param_tolerance_use"], row["param_worst"] = params_close(
            after, want)
    done = [k]

    def one_step():
        i = done[0]
        chunk(opts, train.feats, train.targets, plan[i % len(plan)][None],
              desc, i)
        done[0] += 1
        torch.cuda.synchronize()

    row["train_step_ms"] = host_median_ms(one_step)
    row["steps_per_s"] = 1e3 / row["train_step_ms"]
    row.update(profile_steps(one_step), card=smi)
    # A tree with the graph route: its graph step beside its eager step
    # (``train_step_ms`` is the default route's).
    if "graph" in inspect.signature(
            make_multistep_train_step_indexed).parameters:
        for graph in (False, True):
            g_mods = init_params(AgentModules(cfg), seed=0, device="cuda")
            g_chunk = make_multistep_train_step_indexed(
                g_mods, top_k=6, batch_denom=TRAIN_BATCH, fast="kernel",
                seed=0, device="cuda", graph=graph)
            g_opts = init_opt_states(cfg, g_mods)
            g_done = [0]

            def g_step():
                i = g_done[0]
                g_chunk(g_opts, train.feats, train.targets,
                        plan[i % len(plan)][None], desc, i)
                g_done[0] += 1
                torch.cuda.synchronize()

            name = "graph" if graph else "eager"
            row[f"train_step_ms_{name}"] = host_median_ms(g_step)
            row[f"device_busy_share_{name}"] = profile_steps(
                g_step)["device_busy_share"]
    log(row)
    return 0


def tower_epilogues(batch: int, size: int):
    """The tower's block epilogues in launch order, ``(shape, shortcut)``:
    each block's first convolution without a shortcut, its second with
    the block's input (``"input"``) or the downsample's output and bias
    (``"downsample"``)."""
    from multimodalgame_tpu_torch.models.resnet import STAGES
    side = ((size - 1) // 2) // 2 + 1       # conv1 (7x7/2), the max pool
    c_in, out = 64, []
    for blocks, c, stride in STAGES:
        for b in range(blocks):
            s = stride if b == 0 else 1
            side = (side - 1) // s + 1
            down = b == 0 and (s != 1 or c_in != c)
            out += [((batch, c, side, side), None),
                    ((batch, c, side, side),
                     "downsample" if down else "input")]
            c_in = c
    return out


def float32_ulps(a, b) -> int:
    """The largest distance between ``a`` and ``b`` in units in the last
    place (float32 bit patterns on one ordered integer line)."""
    import torch

    def line(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((line(a) - line(b)).abs().max())


def check_tower(device, smi) -> dict:
    """Phase 23: the served ResNet-34 tower's three kernels
    (``ops/cuda_tower.py``, ``csrc/tower_epilogue.cu``) at the pixel
    cell's shapes, held against their plain versions: normalisation and
    the stem bit for bit, the block epilogue within one unit in the last
    place at each stage's planes, with and without a shortcut and the
    downsample's bias, with and without the ReLU; then the captured tower
    (``PixelTower``, random weights) replayed TOWER_REPLAYS times with the
    wrappers' launches set to 0 first, which have to read 1, 1 and 32 a
    run, ``fused_runs`` equal to ``runs``, its output within TOWER_TOL of
    the plain forward, and a replay's profile free of PyTorch
    elementwise and pooling kernels. Each kernel is timed at the cell's
    shapes (the block epilogue as the 32 launches of a request, summed)
    with its plain version and its bound, bytes over PEAK_BYTES."""
    import torch
    import torch.nn.functional as F
    from multimodalgame_tpu_torch.models.resnet import (
        PixelTower, random_params, resnet34_features)
    from multimodalgame_tpu_torch.ops import cuda_tower as ct
    B, S = TOWER_BATCH, TOWER_SIZE
    gen = torch.Generator(device=device).manual_seed(24)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def fail(what):
        raise SystemExit(f"tower: {what}")

    px = torch.randint(0, 256, (B, 3, S, S), generator=gen,
                       dtype=torch.uint8, device=device)
    every = torch.arange(256, dtype=torch.uint8, device=device)
    for x in (px, every):
        if not torch.equal(ct.normalize_pixels(x),
                           ct.normalize_pixels_reference(x)):
            fail(f"normalize_pixels parts from its plain version at "
                 f"{tuple(x.shape)}")
    side = (S - 1) // 2 + 1
    y = randn(B, 64, side, side)
    y[:, :8] = torch.round(y[:, :8] * 2) / 2          # ties
    bias = randn(64)
    got = ct.stem(y, bias)
    if not (torch.equal(got, ct.stem_reference(y, bias))
            and torch.equal(got, F.max_pool2d(
                torch.relu(y + bias.view(1, -1, 1, 1)), 3, 2, 1))):
        fail(f"stem parts from its plain version at {tuple(y.shape)}")
    log({"phase": "tower", "check": "normalize_and_stem",
         "normalize_shape": list(px.shape), "stem_shape": list(y.shape),
         "bit_equal": True})
    launches = tower_epilogues(B, S)
    worst = 0
    for shape in sorted({shape for shape, _ in launches}, reverse=True):
        for shortcut in (None, "input", "downsample"):
            for relu in (True, False):
                y, bias, rbias = randn(*shape), randn(shape[1]), \
                    randn(shape[1])
                r = None if shortcut is None else randn(*shape)
                rb = rbias if shortcut == "downsample" else None
                want = ct.block_epilogue_reference(y.clone(), bias, r, rb,
                                                   relu)
                got = ct.block_epilogue(y, bias, r, rb, relu)
                ulps = float32_ulps(got, want)
                worst = max(worst, ulps)
                if got is not y or ulps > 1:
                    fail(f"block_epilogue at {shape}, shortcut {shortcut}, "
                         f"relu {relu}: {ulps} ulps")
    log({"phase": "tower", "check": "block_epilogue",
         "shapes": sorted({tuple(s) for s, _ in launches}, reverse=True),
         "cases": 6 * len({s for s, _ in launches}), "max_ulps": worst})

    params = random_params(0, device)
    served = PixelTower(params, TOWER_TAP, device)
    key = served.stage(px.cpu().numpy())
    served(key)                                 # eager warm-up
    served(key)                                 # capture, first replay
    for f in ct.COUNTED:
        f.launches = 0
    before = (PixelTower.runs, PixelTower.fused_runs, PixelTower.replays)
    for _ in range(TOWER_REPLAYS):
        out = served(key)
    torch.cuda.synchronize()
    counts = {f.__name__: f.launches for f in ct.COUNTED}
    runs, fused_runs, replays = (a - b for a, b in zip(
        (PixelTower.runs, PixelTower.fused_runs, PixelTower.replays),
        before))
    per_run = {"normalize_pixels": 1, "stem": 1,
               "block_epilogue": len(launches)}
    if (counts != {k: TOWER_REPLAYS * n for k, n in per_run.items()}
            or (runs, fused_runs, replays) != (TOWER_REPLAYS,) * 3):
        fail(f"{TOWER_REPLAYS} replays counted launches {counts}, runs "
             f"{runs}, fused_runs {fused_runs}, replays {replays}")
    plain = resnet34_features(params, ct.normalize_pixels_reference(px),
                              (TOWER_TAP,))[TOWER_TAP]
    gap = float((out.double() - plain.double()).norm()
                / plain.double().norm())
    if not gap < TOWER_TOL:
        fail(f"the replay parts from the plain forward by {gap}")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        served(key)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    plain_ops = [n for n in names
                 if "elementwise_kernel" in n or "max_pool" in n]
    if not names or plain_ops:
        fail(f"a replay's profile: {len(names)} operations, PyTorch's "
             f"elementwise or pooling among them: {plain_ops[:3]}")
    replay_ms = event_median_ms(lambda: served(key))
    log({"phase": "tower", "check": "replays", "batch": B, "size": S,
         "tap": TOWER_TAP, "replays": TOWER_REPLAYS, "launches": counts,
         "runs": runs, "fused_runs": fused_runs,
         "gap_to_plain_forward": gap, "device_operations_a_replay":
             len(names), "tower_kernels_a_replay": {
                 k: sum(k in n for n in names) for k in (
                     "tower_normalize", "tower_stem", "tower_epilogue")},
         "replay_ms": replay_ms, "card": smi})

    def timed(fn, plain_fn, nbytes) -> dict:
        return {"ms": event_median_ms(fn), "device_ms": device_median_ms(fn),
                "plain_ms": event_median_ms(plain_fn), "bytes": nbytes}

    y, bias = randn(B, 64, side, side), randn(64)
    pooled = ((side - 1) // 2 + 1) ** 2 * B * 64
    times = {"normalize_pixels": timed(
        lambda: ct.normalize_pixels(px),
        lambda: ct.normalize_pixels_reference(px), px.numel() * 5),
        "stem": timed(lambda: ct.stem(y, bias),
                      lambda: ct.stem_reference(y, bias),
                      4 * (y.numel() + pooled))}
    total = dict.fromkeys(("ms", "device_ms", "plain_ms", "bytes"), 0)
    for shape, shortcut in launches:
        y, bias, rb = randn(*shape), randn(shape[1]), randn(shape[1])
        r = None if shortcut is None else randn(*shape)
        rb = rb if shortcut == "downsample" else None
        row = timed(lambda: ct.block_epilogue(y, bias, r, rb),
                    lambda: ct.block_epilogue_reference(y, bias, r, rb),
                    4 * y.numel() * (2 + (r is not None)))
        total = {k: total[k] + row[k] for k in total}
    times["block_epilogue"] = total
    kernel = {"normalize_pixels": "tower_normalize", "stem": "tower_stem",
              "block_epilogue": "tower_epilogue"}
    rows = []
    for name, t in times.items():
        bound_ms = 1e3 * t["bytes"] / PEAK_BYTES
        rows.append({
            "name": kernel[name], "route": "cuda",
            "source": "multimodalgame_tpu_torch/csrc/tower_epilogue.cu",
            "wrapper": f"multimodalgame_tpu_torch/ops/cuda_tower.py:{name}",
            "replaces": "none: XLA fuses these passes into the "
                        "convolutions",
            "launches": counts[name], "launches_per_run": per_run[name],
            "batch": B, "size": S,
            "max_ulps": worst if name == "block_epilogue" else 0,
            **t, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / t["device_ms"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "card": smi})
        log({"phase": "timing", "kernel": kernel[name],
             **{k: v for k, v in rows[-1].items()
                if k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "bytes")}, "card": smi})
    return {"rows": rows, "replay_ms": replay_ms,
            "device_operations_a_replay": len(names)}


def check_vision(device, smi) -> dict:
    """Phase 24: the vision tower's rotary kernel (``ops/cuda_vision.py``,
    ``csrc/vision_rotary.cu``) at the photo cell's shapes against its
    plain version, in both dtypes and both layouts, and timed beside its
    bound (bytes over PEAK_BYTES: the product read once, q, k and v
    written once); then the captured ``VisionTower`` on the kernel and on
    the plain version in its place, each profiled for one replay, timed
    and held against the reference tower."""
    import torch
    from unittest import mock
    from gamebench.entries.serve_photos import tower_state
    from gamebench.entries.serve_pixels import make_pixels
    from gamebench.reference import qwen_vision as ref
    from multimodalgame_tpu_torch.models.qwen_vision import (
        QWEN2_5_VL_7B, Layout, VisionTower, params_from_state)
    from multimodalgame_tpu_torch.ops import cuda_vision as cv
    vcfg = {**QWEN2_5_VL_7B, "initializer_range": 0.02}
    B, (H, W) = VISION_BATCH, VISION_HW
    C, heads = vcfg["hidden_size"], vcfg["num_heads"]
    lay = Layout(vcfg, H, W, device)
    gen = torch.Generator(device=device).manual_seed(26)

    def fail(what):
        raise SystemExit(f"vision: {what}")

    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn((B, lay.tokens, 3 * C), generator=gen,
                          device=device).to(dtype)
        for full in (False, True):
            dest = lay.full_dest if full else lay.window_dest
            got = cv.rotary_qkv(qkv, lay.cos, lay.sin, dest, heads)
            torch.cuda.synchronize()
            want = cv.rotary_qkv_reference(qkv, lay.cos, lay.sin, dest,
                                           heads)
            row = {"dtype": str(dtype).split(".")[-1], "full": full,
                   "elements_apart": {n: int((g != w).sum()) for n, g, w in
                                      zip("qkv", got, want)}}
            checks.append(row)
            if any(row["elements_apart"].values()):
                fail(f"rotary_qkv parts from its plain version: {row}")
    log({"phase": "vision", "check": "rotary_qkv", "batch": B,
         "size": [H, W], "cases": checks})

    qkv = torch.randn((B, lay.tokens, 3 * C), generator=gen,
                      device=device).to(torch.bfloat16)
    dest = lay.window_dest
    nbytes = 2 * qkv.numel() * qkv.element_size()
    timed = {"ms": event_median_ms(
        lambda: cv.rotary_qkv(qkv, lay.cos, lay.sin, dest, heads)),
        "device_ms": device_median_ms(
        lambda: cv.rotary_qkv(qkv, lay.cos, lay.sin, dest, heads)),
        "plain_ms": event_median_ms(
        lambda: cv.rotary_qkv_reference(qkv, lay.cos, lay.sin, dest,
                                        heads)),
        "bytes": nbytes}
    del qkv

    sd = tower_state(vcfg, 11, device)
    params = params_from_state(sd, vcfg, device)
    px = make_pixels({"num_classes": 30, "image_shape": [3, H, W],
                      "dev_per_class": 4}, "dev", 11, device)[:B]
    want = ref.forward(ref.state(sd, device), vcfg, px[:4])
    pixels = px.cpu().numpy()
    names = ("runs", "replays", "rotary_launches",
             "window_attention_launches", "full_attention_launches")

    def plain_rotary(*args):
        return cv.rotary_qkv_reference(*args)
    plain_rotary.launches = 0

    def route(tower) -> dict:
        key = tower.stage(pixels)
        tower.outputs(key)                      # eager warm-up
        tower.outputs(key)                      # capture, first replay
        before = [getattr(VisionTower, k) for k in names] \
            + [cv.rotary_qkv.launches]
        for _ in range(VISION_REPLAYS):
            tokens, feats = tower.outputs(key)
        torch.cuda.synchronize()
        counts = dict(zip(names + ("kernel_launches",), (
            a - b for a, b in zip([getattr(VisionTower, k) for k in names]
                                  + [cv.rotary_qkv.launches], before))))
        gaps = {"token_gap": float(ref.relative_gaps(
            tokens[:4].flatten(0, 1), want["tokens"].flatten(0, 1)).max()),
            "feature_gap": float(ref.relative_gaps(
                feats[:4], want["features"]).max())}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            tower.outputs(key)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        return {"counts": counts, **gaps,
                "device_operations_a_replay": len(ops),
                "rotary_kernels_a_replay": sum("vit_rotary_qkv" in n
                                               for n in ops),
                "addcmul_a_replay": sum("addcmul" in n for n in ops),
                "replay_ms": event_median_ms(lambda: tower.outputs(key)),
                "tokens": tokens[:4].clone()}

    kernel = route(VisionTower(params, vcfg, device))
    with mock.patch.object(cv, "rotary_qkv", plain_rotary):
        plain = route(VisionTower(params, vcfg, device))
    routes = {"kernel": kernel, "plain": plain}
    if not torch.equal(kernel.pop("tokens"), plain.pop("tokens")):
        fail("the kernel route's tokens part from the plain route's")
    per_run = {"runs": VISION_REPLAYS, "replays": VISION_REPLAYS,
               "rotary_launches": 32 * VISION_REPLAYS,
               "window_attention_launches": 112 * VISION_REPLAYS,
               "full_attention_launches": 4 * VISION_REPLAYS}
    for name, r in routes.items():
        want_counts = dict(per_run, kernel_launches=(
            32 * VISION_REPLAYS if name == "kernel" else 0))
        if (r["counts"] != want_counts
                or not r["token_gap"] < VISION_TOKEN_GAP
                or not r["feature_gap"] < VISION_FEATURE_GAP
                or r["rotary_kernels_a_replay"] != (
                    32 if name == "kernel" else 0)
                or (name == "kernel" and r["addcmul_a_replay"])):
            fail(f"the {name} route's replays: {r}")
    log({"phase": "vision", "check": "replays", "batch": B, "size": [H, W],
         "routes": routes, "tokens_equal_across_routes": True,
         "device_operations_removed": (
             plain["device_operations_a_replay"]
             - kernel["device_operations_a_replay"]), "card": smi})
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    row = {"name": "vit_rotary_qkv", "route": "cuda",
           "source": "multimodalgame_tpu_torch/csrc/vision_rotary.cu",
           "wrapper": "multimodalgame_tpu_torch/ops/cuda_vision.py:"
                      "rotary_qkv",
           "replaces": "none: the JAX package has no vision tower",
           "launches": kernel["counts"]["kernel_launches"],
           "launches_per_run": 32, "batch": B, "size": [H, W],
           "bit_equal": True,
           **timed, "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_share": bound_ms / timed["device_ms"],
           "library_ms": None,
           "library_note": "no single PyTorch call computes this function",
           "card": smi}
    log({"phase": "timing", "kernel": "vit_rotary_qkv",
         **{k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "bytes")}, "card": smi})
    return {"rows": [row], "routes": routes}


def run_new_paths(workdir, smi) -> dict:
    """bfloat16, CIFAR and the population's paths."""
    return {"bf16": drive_bf16("cuda", workdir, smi),
            "cifar": drive_cifar("cuda", workdir, smi),
            **run_population_paths(workdir, smi)}


def run_population_paths(workdir, smi) -> dict:
    """The population on the graph route against eager, the population
    step against single games, the sweep of 16 members with its step's
    timing, and the sweep of one."""
    return {"population_graph": check_population_graph("cuda", smi),
            "population": {d: check_population("cuda", smi, d)
                           for d in ("float64", "float32")},
            "sweep": drive_sweep("cuda", workdir, smi, SWEEP_ARGV, "sweep",
                                 min_top6=MIN_DEV_TOP6),
            "population_timing": population_timing("cuda", smi),
            "sweep_one": drive_sweep("cuda", workdir, smi, SWEEP_ONE_ARGV,
                                     "sweep_one")}


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--times"] and len(sys.argv) <= 4:
        return times_only(*sys.argv[2:])
    if sys.argv[1:] == ["--tp"]:
        # Only the build and this slice's phases; no result line.
        smi = probe()
        build()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as workdir:
            run_tp_paths(workdir, smi)
        return 0
    if sys.argv[1:] == ["--mesh-cpu"]:
        return mesh_step_cpu()
    if sys.argv[1:] in (["--tower"], ["--vision"]):
        smi = probe()
        build()
        check = check_tower if sys.argv[1] == "--tower" else check_vision
        log({"kernels": check("cuda", smi)["rows"]})
        log({"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
        return 0
    if sys.argv[1:] == ["--graph"]:
        # Only the build, the train kernel's checks (its device-key mode
        # among them) and the graph phase; no result line.
        smi = probe()
        build()
        check_train_kernels("cuda")
        check_graph("cuda", smi)
        return 0
    if sys.argv[1:] == ["--mesh-graph"]:
        # Only the build and the NCCL rank on the graph route; no result
        # line.
        smi = probe()
        build()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as workdir:
            mesh_graph(workdir, smi)
        return 0
    if sys.argv[1:] == ["--population"]:
        # Only the build, the population's paths and the split sweep; no
        # result line.
        smi = probe()
        build()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as workdir:
            run_population_paths(workdir, smi)
            sweep_mesh("cuda", workdir, smi)
        return 0
    if sys.argv[1:] == ["--staged"]:
        # Only the build, the staged trainer and the two-rank step; no
        # result line.
        smi = probe()
        build()
        drive_staged("cuda", smi)
        mesh_step("cuda", smi)
        return 0
    if sys.argv[1:] == ["--ckpt"]:
        # Only the build, the driver phase and the checkpoint phase that
        # resumes its _best; no result line.
        smi = probe()
        build()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as workdir:
            ckpt_msgpack("cuda", workdir, smi, drive("cuda", workdir, smi))
        return 0
    if sys.argv[1:] == ["--ckpt-orbax"]:
        # Only the build and the Orbax checkpoint phase; no result line.
        smi = probe()
        build()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as workdir:
            ckpt_orbax("cuda", workdir, smi)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        # Only the build, the serving and driver phases the mesh phases
        # are held against, and the mesh phases; no result line.
        smi = probe()
        build()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as workdir:
            run_mesh_paths(workdir, smi, serve_requests("cuda", workdir),
                           drive("cuda", workdir, smi))
        return 0
    smi = probe()
    build()
    worst = check_kernels("cuda")
    worst_train = check_train_kernels("cuda")
    cifar_kernels = check_cifar_kernels("cuda", smi)
    tower = check_tower("cuda", smi)
    vision = check_vision("cuda", smi)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as workdir:
        served = serve_requests("cuda", workdir)
        trained = train_game("cuda", workdir)
        staged = drive_staged("cuda", smi)
        graphed = check_graph("cuda", smi)
        mesh_graphed = mesh_graph(workdir, smi)
        driven = drive("cuda", workdir, smi)
        ckpt = ckpt_msgpack("cuda", workdir, smi, driven)
        orbax = ckpt_orbax("cuda", workdir, smi)
        # The attention presets and the variants: neither kernel
        # launches on them.
        attention = drive_attention("cuda", workdir, smi)
        served_attn = serve_attention("cuda", attention)
        variants = drive_variants("cuda", workdir, smi)
        new = run_new_paths(workdir, smi)
        mesh = run_mesh_paths(workdir, smi, served, driven)
        tp = run_tp_paths(workdir, smi)
    log({"phase": "variants", "steps_per_s": {
        "AdaptiveAttention": attention["run_steps_per_s"],
        **{k: v["steps_per_s"] for k, v in variants["rows"].items()},
        "bf16": new["bf16"]["run_steps_per_s"],
        "cifar": new["cifar"]["run_steps_per_s"]},
        "card": smi})
    log({"phase": "mesh", "run_steps_per_s": {
        "driver": driven["run_steps_per_s"],
        "mesh_driver": mesh["mesh_driver"]["run_steps_per_s"]},
        "grad_reduce_ms_per_step": {
            "mesh_step": mesh["mesh_step"]["grad_reduce_ms_per_step"],
            "mesh_driver": mesh["mesh_driver"]["grad_reduce_ms_per_step"]},
        "note": "two ranks share one card: correctness and overhead, "
                "not scaling", "card": smi})
    log({"phase": "driver", "run_steps_per_s": driven["run_steps_per_s"],
         "last_epoch_steps_per_s": driven["last_epoch_steps_per_s"],
         "bare_trainer_steps_per_s": trained["steps_per_s"],
         "sweep_game_steps_per_s": new["sweep"]["game_steps_per_s"],
         "sweep_over_driver": (new["sweep"]["game_steps_per_s"]
                               / driven["run_steps_per_s"]),
         "card": smi})
    rows = timing("cuda", served["pred"])
    train_rows = train_timing("cuda", trained)
    attention_row = attention_timing("cuda", attention)
    at = rows[64]
    tat = train_rows[TRAIN_BATCH]
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        ROWS, kernel_registers, plan_for)
    plan = plan_for(served["pred"].cfg, 64, NUM_CLASSES)
    layout = {"cluster": plan.cluster, "rows_per_tile": ROWS,
              "smem_bytes": plan.smem_bytes,
              "latency_floor_ms": rows["floor"]["latency_floor_ms"]}
    new_paths = ("bf16", "cifar", "sweep", "sweep_one")
    mesh_paths = ("mesh_step", "mesh_driver", "sweep_mesh", "serve_mesh")
    tp_paths = ("route_big", "tp_step", "tp_driver", "tp_grid", "tp_big")
    log({"phase": "tp", "steps_per_s": {
        "route_big": tp["route_big"]["steps_per_s"],
        "tp_big": tp["tp_big"]["steps_per_s"],
        "tp_step_per_rank": tp["tp_step"]["steps_per_s_per_rank"],
        "tp_step_one_device": tp["tp_step"]["steps_per_s_one_device"]},
        "extract_images_per_s": tp["extract"]["images_per_s"],
        "note": "ranks share one card: correctness and overhead, not "
                "scaling", "card": smi})
    log({"kernels": [{
        "name": "fused_eval_exchange",
        "route": "cuda",
        "source": "multimodalgame_tpu_torch/csrc/fused_exchange.cu",
        "replaces": "multimodalgame_tpu/ops/pallas_exchange.py:265",
        "launches": served["launches"],
        "launches_by_path": {
            "serve": served["launches"], "staged": staged["eval_launches"],
            "driver": driven["eval_launches"],
            "ckpt_msgpack": ckpt["eval_launches"],
            "ckpt_orbax": orbax["eval_launches"],
            "driver_attention": attention["counts"]["eval_launches"],
            "serve_attention": served_attn["launches"],
            "variants": variants["eval_launches"],
            "mesh_graph": mesh_graphed["eval_launches"],
            **{k: new[k]["eval_launches"] for k in new_paths},
            **{k: mesh[k]["eval_launches"] for k in mesh_paths},
            **{k: tp[k]["eval_launches"] for k in tp_paths}},
        "max_abs_err": max(worst["max_abs_err"],
                           cifar_kernels["worst"]["max_abs_err"]),
        "tie_rows": worst["tie_rows"] + cifar_kernels["worst"]["tie_rows"],
        "batch": 64,
        "ms": at["kernel_ms"],
        "device_ms": at["kernel_device_ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "cifar_width": cifar_kernels["rows"]["fused_eval_exchange"],
        "card": smi,
        **kernel_registers(train=False),
        **layout,
    }, {
        "name": "fused_train_forward",
        "route": "cuda",
        "source": "multimodalgame_tpu_torch/csrc/fused_exchange.cu",
        "replaces": "multimodalgame_tpu/ops/pallas_exchange.py:278",
        "launches": trained["launches"],
        "launches_by_path": {
            "train": trained["launches"], "staged": staged["train_launches"],
            "driver": driven["train_launches"],
            "ckpt_msgpack": ckpt["train_launches"],
            "ckpt_orbax": orbax["train_launches"],
            "driver_attention": attention["counts"]["train_launches"],
            "variants": variants["train_launches"],
            "mesh_graph": mesh_graphed["train_launches"],
            **{k: new[k]["train_launches"] for k in new_paths},
            **{k: mesh[k]["train_launches"] for k in mesh_paths},
            **{k: tp[k]["train_launches"] for k in tp_paths}},
        "max_abs_err": max(worst_train["max_abs_err"],
                           cifar_kernels["worst"]["max_abs_err"]),
        "tie_rows": worst_train["tie_rows"],
        "batch": TRAIN_BATCH,
        "rng": "philox",
        "ms": tat["kernel_ms"],
        "device_ms": tat["kernel_device_ms"],
        "plain_ms": tat["plain_ms"],
        "bound_ms": tat["bound_ms"],
        "bound_by": tat["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "cifar_width": cifar_kernels["rows"]["fused_train_forward"],
        "steps_per_s": train_rows["step"]["steps_per_s"],
        "phase_a_share": train_rows["step"]["phase_a_share"],
        "staged_kernels_per_step": staged["device_kernels_per_step"],
        "staged_step_ms": staged["train_step_ms"],
        "graph_step_ms": graphed["calls"]["graph"]["step_ms"],
        "eager_step_ms": graphed["calls"]["eager"]["step_ms"],
        "graph_host_launch_calls_per_update": graphed["calls"]["graph"][
            "chunk_of_8_per_update"]["host_launch_calls"],
        "eager_host_launch_calls_per_update": graphed["calls"]["eager"][
            "chunk_of_8_per_update"]["host_launch_calls"],
        "mesh_graph": {
            on: {"graph_step_ms": c["graph"]["step_ms"],
                 "eager_step_ms": c["eager"]["step_ms"],
                 "graph_host_launch_calls_per_update": c["graph"][
                     "chunk_of_8_per_update"]["host_launch_calls"],
                 "eager_host_launch_calls_per_update": c["eager"][
                     "chunk_of_8_per_update"]["host_launch_calls"]}
            for on, c in mesh_graphed["calls"].items()},
        "mesh_graph_driver_dev_top6": mesh_graphed["dev_top6"],
        "driver_run_steps_per_s": driven["run_steps_per_s"],
        "dev_top6": driven["last_dev_top6"],
        "checkpoint_formats": dict(ckpt["timing"],
                                   orbax=orbax["timing"]["orbax"]),
        "zstd_decode_mb_per_s": orbax["decoded_mb_per_s"],
        "attention_run_steps_per_s": attention["run_steps_per_s"],
        "attention_step_steps_per_s": attention_row["steps_per_s"],
        "attention_dev_top6": attention["last_dev_top6"],
        "bf16_run_steps_per_s": new["bf16"]["run_steps_per_s"],
        "cifar_run_steps_per_s": new["cifar"]["run_steps_per_s"],
        "sweep_game_steps_per_s": new["sweep"]["game_steps_per_s"],
        "sweep_winner_dev_top6": new["sweep"]["winner_best_dev_acc"],
        "population_step_device_busy_share":
            new["population_timing"]["device_busy_share"],
        "population_graph_step_ms":
            new["population_timing"]["population_step_ms"],
        "population_eager_step_ms":
            new["population_timing"]["eager_population_step_ms"],
        "population_graph_host_launch_calls_per_update":
            new["population_graph"]["calls"]["graph"][
                "chunk_of_8_per_update"]["host_launch_calls"],
        "sweep_mesh_game_steps_per_s":
            mesh["sweep_mesh"]["game_steps_per_s"],
        "row_base_split_max_err": mesh["row_base"]["max_prob_err"],
        "mesh_driver_run_steps_per_s":
            mesh["mesh_driver"]["run_steps_per_s"],
        "mesh_driver_dev_top6": mesh["mesh_driver"]["last_dev_top6"],
        "mesh_grad_reduce_ms_per_step":
            mesh["mesh_driver"]["grad_reduce_ms_per_step"],
        "tp_step_steps_per_s_per_rank":
            tp["tp_step"]["steps_per_s_per_rank"],
        "tp_driver_dev_top6": tp["tp_driver"]["last_dev_top6"],
        "big_game_steps_per_s": {"one_device": tp["route_big"]["steps_per_s"],
                                 "tp_1x2": tp["tp_big"]["steps_per_s"]},
        "card": smi,
        **kernel_registers(train=True),
        **layout,
    }] + tower["rows"] + vision["rows"]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
