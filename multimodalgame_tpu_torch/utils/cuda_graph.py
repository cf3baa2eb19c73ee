"""CUDA graphs of the port's steps: the counterpart of one compiled XLA
program.

The JAX package runs K optimizer updates as one compiled program
(``make_multistep_train_step``, a ``jax.jit`` of a ``lax.scan``) and each
eval conversation as one more, so the host dispatches once where the
port's eager step launches thousands of kernels. :class:`Captured` holds
a body (a function of no arguments that reads static input buffers and
returns its outputs) and runs it:

* its first ``warmup`` calls run the body eagerly on a side stream, as
  whole-network capture requires (``torch.cuda.graphs``): the kernel
  library is loaded, the kernels' one-time launch set-up runs, the
  autograd engine and cuBLAS are initialized, and nothing of that is
  recorded. These runs are real steps: the caller gets their outputs;
* the next call captures the body as one ``torch.cuda.CUDAGraph``, in a
  memory pool of its own, and replays it; every later call replays it.
  Python's cycle collector runs just before the capture and is off
  during it: a graph that is freed while another is being captured
  invalidates that capture, and dropped graphs are cyclic garbage.
  A replay's outputs are the graph's static tensors, which the next
  replay overwrites: the caller copies out what it keeps.

A capture records kernel launches without running them, so the counted
wrappers' ``launches`` (``ops/cuda_exchange.py``) are set back after the
capture, and the capture's counts are added at each replay. The same
holds for the body's other ``counters`` (a data-parallel mesh's
collective calls, ``parallel/mesh.py:Mesh``). A failed capture or
replay raises; nothing falls back to the eager body.

A body may call NCCL collectives (a rank's step on a mesh of distinct
cards, ``game/train.py:step_route``). The communicator exists before the
capture: the process group is bound to its device
(``parallel/distributed.py:initialize``) and the eager warm-up runs the
collectives first. Every rank captures and replays the same collectives
in the same order, since every rank runs the same steps. NCCL's blocking
wait (``TORCH_NCCL_BLOCKING_WAIT``) must stay off: its host-side wait
inside a capture would fail it. Gloo's collectives run on the host and
cannot be captured.

With ``capture`` False (the CPU; a card's uncaptured route: ranks of a
gloo mesh, ``graph=False``) every call runs the body as it is, on the
same static buffers: one body serves both routes, and on a card the
uncaptured run is the tests' reference for the replays.

The graphs of the port: each trainer's step or chunk
(``game/train.py:_StepGraph``) and a population's
(``parallel/population.py``); the eval conversation of each call shape
(``game/train.py:_EvalGraph``, whose body is the kernel route's or the
plain conversation that attention, ``mou`` and ``flipout_dev`` take),
and a population's dev batch (``_PopulationEvalGraph``). Besides these,
each served image tower (``models/resnet.py:PixelTower``,
``models/qwen_vision.py:VisionTower``) runs as one graph a request
shape, staged by :class:`StagedGraphs`: its body counts its runs and
images (and its kernels' launches or attention calls) through
``counters``, and the global precision flags it sets while it is
captured stay in the graph.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalgame_tpu_torch.ops.cuda_exchange import (add_launches,
                                                        launch_counts,
                                                        set_launch_counts)


def clone_tree(x):
    """``x`` with every tensor cloned: a tensor, a (named) tuple, a dict
    or a value that passes through."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        vals = [clone_tree(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


class Captured:
    """``body`` run eagerly ``warmup`` times, then captured once and
    replayed; ``capture`` False runs it eagerly on every call.
    ``counters`` are ``(object, attribute)`` pairs of integer counts that
    the body advances besides the kernels' launches: like those, they are
    set back after the capture and advanced by the capture's counts at
    each replay. The class counts the captures and replays of the
    process (``captures``, ``replays``), which show that a path ran on
    its graphs."""

    captures = 0
    replays = 0

    def __init__(self, body: Callable[[], Any], device: torch.device,
                 warmup: int, capture: bool = True,
                 counters: Sequence[Tuple[Any, str]] = ()):
        self.body = body
        self.counters = tuple(counters)
        self.device = torch.device(device)
        self.warmup = warmup
        self.capture = capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.runs = 0
        self.replay_launches: Optional[Tuple[int, ...]] = None
        self.replay_counts: Tuple[int, ...] = ()
        self._side: Optional[torch.cuda.Stream] = None

    def __call__(self) -> Tuple[Any, bool]:
        """One run: ``(outputs, replayed)``. A replay's outputs are the
        graph's static tensors."""
        if not self.capture:
            return self.body(), False
        if self.graph is None and self.runs < self.warmup:
            self.runs += 1
            return self._eager(), False
        if self.graph is None:
            self._capture()
        with torch.cuda.device(self.device):
            self.graph.replay()
        add_launches(self.replay_launches)
        for (obj, name), n in zip(self.counters, self.replay_counts):
            setattr(obj, name, getattr(obj, name) + n)
        Captured.replays += 1
        return self.outputs, True

    def _eager(self):
        """The body on a side stream, ordered after the current stream's
        work and before its later work."""
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = self.body()
        main.wait_stream(self._side)
        return out

    def _counts(self) -> Tuple[int, ...]:
        return tuple(getattr(obj, name) for obj, name in self.counters)

    def _capture(self) -> None:
        before, counted = launch_counts(), self._counts()
        graph = torch.cuda.CUDAGraph()
        # A Captured and the owner of its body refer to each other, so a
        # dropped graph is freed by the cycle collector, and freeing a
        # graph while another is being captured invalidates that capture:
        # collect first, and keep the collector off during the capture.
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                self.outputs = self.body()
        finally:
            if enabled:
                gc.enable()
        counts = launch_counts()
        self.replay_launches = tuple(a - b for a, b in zip(counts, before))
        set_launch_counts(before)
        self.replay_counts = tuple(a - b for a, b in zip(self._counts(),
                                                         counted))
        for (obj, name), n in zip(self.counters, counted):
            setattr(obj, name, n)
        self.graph = graph
        Captured.captures += 1


class StagedGraphs(dict):
    """A served tower's request shapes: for each ``(B, H, W)``, a static
    uint8 input buffer on ``device`` and a :class:`Captured` body over it
    (``warmup`` 1), made at the shape's first :meth:`stage` by
    ``make_body(buf)``, which returns the body (a function of no
    arguments). ``counters`` go to each :class:`Captured`; ``replays``,
    an ``(object, attribute)`` pair, counts the calls that were graph
    replays."""

    def __init__(self, make_body: Callable[[torch.Tensor],
                                           Callable[[], Any]],
                 device: torch.device, capture: bool,
                 counters: Sequence[Tuple[Any, str]],
                 replays: Tuple[Any, str]):
        super().__init__()
        self.make_body = make_body
        self.device = torch.device(device)
        self.capture = capture
        self.counters = tuple(counters)
        self.replays = replays

    def stage(self, pixels: np.ndarray) -> tuple:
        """Copy a batch of uint8 pixels ``(B, C, H, W)`` into its shape's
        buffer; returns the key :meth:`run` takes."""
        key = (pixels.shape[0],) + tuple(pixels.shape[2:])
        if key not in self:
            with torch.inference_mode(False):
                buf = torch.empty(pixels.shape, dtype=torch.uint8,
                                  device=self.device)
            self[key] = (buf, Captured(self.make_body(buf), self.device,
                                       warmup=1, capture=self.capture,
                                       counters=self.counters))
        self[key][0].copy_(torch.from_numpy(np.ascontiguousarray(pixels)))
        return key

    def run(self, key: tuple):
        """The body's outputs for the batch last staged under ``key``."""
        out, replayed = self[key][1]()
        obj, name = self.replays
        setattr(obj, name, getattr(obj, name) + int(replayed))
        return out
