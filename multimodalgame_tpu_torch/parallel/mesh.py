"""Data parallelism over ranks of ``torch.distributed``: one process a
device.

The port of ``multimodalgame_tpu/parallel/mesh.py``. The JAX package
annotates shardings on one SPMD program and XLA inserts the collectives;
here each device is driven by a process of its own (the step is
host-bound, ~4,000 eager kernels, so one host thread driving N devices
would pay N times the dispatch), and the collectives are written out:

* every rank holds the same full host value (the staged sets, the seeds,
  the shuffle plans; JAX parallel/distributed.py:63-76) and takes rows
  ``[r·B/N, (r+1)·B/N)`` of each batch (:func:`row_block`); a batch that
  ``N`` does not divide (a ragged dev tail) runs whole on every rank, as
  JAX's ``axis_placer`` replicates it (mesh.py:73-99);
* the losses' batch statistics go through :class:`Mesh` as the
  reduction seam of ``game/losses.py``;
* :func:`reduce_step` sums the updated agents' gradients over the ranks
  in one all-reduce of one flat buffer before the optimizers, with the
  step's logged scalars appended, so every clip-by-global-norm sees the
  global gradient and every rank applies the same update;
* :func:`gather_metrics` / :meth:`Mesh.gather_rows` assemble per-row
  values in rank order where a log window or a dev sweep needs the whole
  batch.

Every collective is an ``all_reduce(SUM)``: a gather is an all-reduce of
a buffer in which each rank fills its own block (exact: the other blocks
are zeros). That keeps to the one collective that both NCCL and gloo (on
CUDA tensors too, for ranks that share a card) provide.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from multimodalgame_tpu_torch.game.exchange import (ExchangeOutputs,
                                                    turns_run)


def row_block(batch: int, rank: int, size: int) -> Tuple[int, int]:
    """Rank ``rank``'s rows ``[lo, hi)`` of a batch of ``batch`` over
    ``size`` ranks: an even block when ``size`` divides ``batch``, else
    the whole batch (a ragged batch runs replicated, JAX's
    ``axis_placer`` rule)."""
    if batch % size:
        return 0, batch
    per = batch // size
    return rank * per, (rank + 1) * per


class Mesh:
    """This process's place in a data-parallel job: its ``rank`` among
    ``size`` ranks, its ``device`` and the process group's ``backend``.
    It is the losses' reduction seam (:meth:`sum`, :attr:`size`) and
    counts the collectives it runs (``calls``; the gradient all-reduces
    alone in ``grad_calls``) and the host seconds spent in them
    (``seconds``, ``grad_seconds``).

    On the eager route each collective is called from Python: under gloo
    it returns when it is done, under NCCL when it is enqueued, so its
    seconds are the host's part only. On the graph route (NCCL,
    ``game/train.py:step_route``) a step's collectives are recorded once,
    at the capture, and run inside each replay: the graph's owner
    (``utils/cuda_graph.py:Captured``) takes the capture's calls back and
    adds them at each replay, so ``calls`` and ``grad_calls`` count what
    ran; the seconds cover the eager warm-up steps only, since a
    collective recorded into a graph is not timed and a replayed one has
    no host part of its own.

    On a 2-D ``(data, model)`` grid (``parallel/tensor.py:make_mesh_2d``)
    the mesh is the data axis: ``rank`` and ``size`` are this rank's data
    index and the data-axis size, ``group`` the process group of its data
    shard's peers, ``global_rank`` its rank in the job, and ``model`` the
    model axis, a :class:`Mesh` of its own over this data shard's ranks.
    Off the grid ``group`` is the whole job and ``model`` is ``None``."""

    def __init__(self, rank: int, size: int, device, backend: str,
                 group=None, global_rank: Optional[int] = None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.global_rank = self.rank if global_rank is None \
            else int(global_rank)
        self.model: Optional["Mesh"] = None
        self.seconds = 0.0
        self.calls = 0
        self.grad_seconds = 0.0
        self.grad_calls = 0

    @property
    def writer(self) -> bool:
        """Whether this rank writes the run's shared files."""
        return self.global_rank == 0

    def rows(self, batch: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a batch (:func:`row_block`)."""
        return row_block(batch, self.rank, self.size)

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        dist.all_reduce(x, group=self.group)
        self.seconds += host_seconds(x, t0)
        self.calls += 1
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a detached copy of ``x``."""
        return self.all_reduce_(x.detach().clone())

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce of one number)."""
        self.all_reduce_(torch.zeros(1, device=self.device))

    def gather_rows(self, tensors: Sequence[torch.Tensor],
                    dims: Sequence[int]) -> List[torch.Tensor]:
        """Each tensor's rows from every rank, concatenated in rank order
        along its batch axis ``dims[i]``; every rank gets the result. The
        ranks hold equal blocks. Exact for float32, bfloat16, integers
        and booleans (carried in float64)."""
        flat = [t.detach().movedim(d, 0).reshape(-1)
                for t, d in zip(tensors, dims)]
        sizes = [f.numel() for f in flat]
        per_rank = sum(sizes)
        buf = torch.zeros((self.size, per_rank), dtype=torch.float64,
                          device=self.device)
        buf[self.rank] = torch.cat([f.to(torch.float64) for f in flat])
        self.all_reduce_(buf)
        out, off = [], 0
        for t, d, n in zip(tensors, dims, sizes):
            block = t.movedim(d, 0).shape
            rows = buf[:, off:off + n].reshape(
                (self.size * block[0],) + tuple(block[1:]))
            out.append(rows.to(t.dtype).movedim(0, d).contiguous())
            off += n
        return out


def host_seconds(x: torch.Tensor, t0: float) -> float:
    """The host seconds since ``t0`` of a collective on ``x``, or 0 while
    ``x``'s stream is being captured into a CUDA graph (the call only
    recorded the collective)."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return 0.0
    return time.perf_counter() - t0


_SUMMED = ("loss_rec", "loss_sen", "nll_loss", "loss_binary_rec",
           "loss_binary_s", "loss_bas_rec", "loss_bas_sen",
           "ent_binary_sen", "ent_binary_rec", "ent_y_rec", "accuracy")


def all_reduce_grads(mesh: Mesh, params: Sequence[torch.nn.Parameter],
                     extras: Sequence[torch.Tensor] = ()
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One ``all_reduce(SUM)`` over one flat buffer: every parameter's
    ``.grad`` (zeros where it has none), then ``extras``. Returns the
    buffer's gradient block (the summed gradients back to back, in the
    parameters' order: the flat carry's gradient, ``game/train.py``) and
    the summed ``extras`` in their shapes and dtypes."""
    dtype = params[0].dtype
    parts = [(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
             for p in params]
    parts += [e.detach().reshape(-1).to(dtype) for e in extras]
    flat = torch.cat(parts)
    t0 = time.perf_counter()
    mesh.all_reduce_(flat)
    mesh.grad_seconds += host_seconds(flat, t0)
    mesh.grad_calls += 1
    off = sum(p.numel() for p in params)
    grads = flat[:off]
    out = []
    for e in extras:
        out.append(flat[off:off + e.numel()].reshape(e.shape).to(e.dtype))
        off += e.numel()
    return grads, out


def reduce_step(mesh: Mesh, params: Sequence[torch.nn.Parameter],
                metrics):
    """The step's gradient all-reduce (:func:`all_reduce_grads`), which
    also sums the ranks' shares of the logged losses, negentropies and
    accuracy (``game/losses.py``): ``(metrics`` with those fields global,
    the summed gradients back to back``)``."""
    grads, summed = all_reduce_grads(mesh, params,
                                     [getattr(metrics, k) for k in _SUMMED])
    return metrics._replace(**dict(zip(_SUMMED, summed))), grads


def gather_record(mesh: Mesh, ex: ExchangeOutputs,
                  fixed_exchange: bool) -> ExchangeOutputs:
    """The whole batch's conversation record from the ranks' rows (batch
    axis 1 of every field), its turn count taken anew from the gathered
    stop masks (``game/exchange.py:turns_run``)."""
    names = [k for k in ex._fields
             if k != "n_steps" and getattr(ex, k) is not None]
    got = mesh.gather_rows([getattr(ex, k) for k in names], [1] * len(names))
    whole = ex._replace(**dict(zip(names, got)))
    return whole._replace(n_steps=turns_run(whole.stop_masks,
                                            fixed_exchange))


def gather_metrics(mesh: Mesh, metrics, fixed_exchange: bool):
    """A full-metrics step's per-row fields (``dist``, ``argmax`` and the
    conversation record) gathered over the ranks in rank order: what the
    single-device step returns for the whole batch."""
    dist_, argmax = mesh.gather_rows([metrics.dist, metrics.argmax], [0, 0])
    return metrics._replace(
        dist=dist_, argmax=argmax,
        exchange=gather_record(mesh, metrics.exchange, fixed_exchange))


def axis_rows(mesh: Optional[Mesh], batch: int) -> slice:
    """The rows of a batch this process evaluates: its block, the whole
    of a ragged batch, or everything off the mesh."""
    return slice(0, batch) if mesh is None else slice(*mesh.rows(batch))


def make_sharded_train_step(modules, top_k: int, batch_denom: int,
                            mesh: Mesh, fast="auto", *, seed: int = 0,
                            uniforms=None):
    """Data-parallel ``game/train.py:make_train_step`` (JAX mesh.py:
    101-131): the same signature and semantics. Each rank calls the step
    with the same whole batch; it trains on its rows on ``mesh.device``,
    the batch statistics and gradients summed over the ranks, and
    returns the whole batch's metrics. The batch must split evenly over
    the ranks."""
    from multimodalgame_tpu_torch.game.train import make_train_step
    return make_train_step(modules, top_k, batch_denom, fast, seed=seed,
                           uniforms=uniforms, mesh=mesh)
