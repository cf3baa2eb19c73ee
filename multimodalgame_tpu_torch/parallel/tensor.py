"""Tensor (model) parallelism over a 2-D ``(data, model)`` grid of ranks.

The port of ``multimodalgame_tpu/parallel/tensor.py``, with JAX's
placement policy kept leaf for leaf (tensor.py:79-80, 99-150):

* **column-parallel**: ``image_layer``, ``code_layer`` and the
  baselines' ``linear1``, sharded on their output features, biases
  alike;
* **row-parallel**: ``binary_layer`` and ``linear2``, sharded on the
  contraction, the bias replicated;
* **replicated**: every receiver parameter;
* **class-axis sharding** of the prediction head through the description
  rows (:func:`class_axis_placer`);
* **ragged fallback**: a dimension that the model-axis size does not
  divide stays replicated, for that leaf only.

JAX places the leaves and XLA derives the collectives. Here each rank is
a process of its own (``parallel/distributed.py``), as in the data-
parallel layer, and the collectives are written out as autograd-aware
functions over the model axis's process group, Megatron's:

* ``f`` (:meth:`Shards.enter`): identity forward, all-reduce of the
  gradient backward, where a replicated activation enters a rank's own
  share of a product;
* ``g`` (:meth:`Shards.reduce`): all-reduce forward, identity backward,
  on a row-parallel product's partial sums;
* an all-gather (:meth:`Shards.whole`) whose backward takes the
  rank's slice: a sharded activation made whole for a replicated
  consumer (the class scores for the softmax, the sender's ``h_x`` for
  its baseline).

A replicated tensor always carries the whole gradient on every rank; a
sharded one its own block's.

The step (``game/train.py``) runs phase A, the conversation sampled
without gradients, and every dev sweep on the *whole* weights: each rank
keeps :attr:`TensorParallel.full`, the single-device agents, whose
replicated parameters are the shards' own tensors and whose sharded ones
are gathered over the model axis once a step (:meth:`TensorParallel.sync`).
So both kernels keep their launches under ``-mesh_model``, and no
collective sits on the serial turn chain. Phase B (the differentiable
recompute) and the optimizers run on :attr:`TensorParallel.shard`, the
rank's blocks. A step's collectives on the model axis: the row-parallel
``g`` of the sender and both baselines, the class scores' gather and the
sender's ``h_x`` for its baseline (forward); the ``f`` of the code input
and of the head's ``h_z`` (backward); the partial gradients of the
class-sharded head, the clip norm and the sync — 10 a step at the
canonical width (tests/test_torch_tensor_parallel.py counts them).

On a grid of ranks on distinct cards (NCCL; ``game/train.py:
step_route``) all of them run inside the rank's step graph, phase A's
launch on :attr:`TensorParallel.full` too, which reads what the last
replay's sync wrote in place; each replay adds the capture's calls to
the model axis's ``calls``. Ranks that share a card (gloo) step eagerly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.parallel.mesh import Mesh

# Column-parallel layers: weight (out, in) sharded on the output dim,
# bias alike. Row-parallel layers: weight sharded on the contraction
# (in) dim, bias replicated (JAX tensor.py:79-80, 132-150; its kernels
# are the transposes, so its dims are swapped).
_COLUMN_PARALLEL = ("image_layer", "code_layer", "linear1")
_ROW_PARALLEL = ("binary_layer", "linear2")


def make_mesh_2d(mesh: Mesh, n_model: int) -> Mesh:
    """The ``(data, model)`` grid over the job's ranks (``mesh``, one
    process group of every rank), with the model axis innermost: rank
    ``d * n_model + m`` is data index ``d``, model index ``m`` (JAX
    tensor.py:83-96). Every rank creates every group, in the same order.
    Returns the data axis (:class:`Mesh`: ``rank`` ``d`` of ``size``
    ``N / n_model``, over the ranks of model index ``m``) with ``model``
    set to the model axis (``rank`` ``m`` of ``n_model``, over the ranks
    of data index ``d``)."""
    import torch.distributed as dist
    n = mesh.size
    if n_model < 1 or n % n_model:
        raise ValueError(f"-mesh_model {n_model} does not divide the -mesh "
                         f"size {n}")
    n_data = n // n_model
    d, m = divmod(mesh.global_rank, n_model)
    data_groups = [dist.new_group([dd * n_model + mm
                                   for dd in range(n_data)])
                   for mm in range(n_model)]
    model_groups = [dist.new_group(list(range(dd * n_model,
                                              (dd + 1) * n_model)))
                    for dd in range(n_data)]
    data = Mesh(d, n_data, mesh.device, mesh.backend, group=data_groups[m],
                global_rank=mesh.global_rank)
    data.model = Mesh(m, n_model, mesh.device, mesh.backend,
                      group=model_groups[d], global_rank=mesh.global_rank)
    return data


def block(size: int, rank: int, n: int) -> Tuple[int, int]:
    """Rank ``rank``'s block ``[lo, hi)`` of a dimension of ``size`` over
    ``n`` ranks, or the whole of a ragged one."""
    if size % n:
        return 0, size
    per = size // n
    return rank * per, (rank + 1) * per


def class_axis_placer(axis: Mesh):
    """Placement for class-indexed description tensors (leading axis =
    class; JAX tensor.py:99-130): a rank's block of the rows when the
    model-axis size divides them, the whole tensor otherwise; ``None``
    passes through."""
    def place(x):
        if x is None or x.dim() == 0:
            return x
        lo, hi = block(x.shape[0], axis.rank, axis.size)
        return x[lo:hi]
    return place


def tp_param_specs(modules: AgentModules, n_model: int
                   ) -> Dict[str, Optional[int]]:
    """The placement policy as ``{parameter name: sharded dim or None}``
    over ``modules.named_parameters()``; the dim is the torch tensor's
    (JAX tensor.py:132-150)."""
    specs = {}
    for name, p in modules.named_parameters():
        parts = set(name.split("."))
        dim = None
        if parts & set(_COLUMN_PARALLEL):
            dim = 0 if p.shape[0] % n_model == 0 else None
        elif parts & set(_ROW_PARALLEL) and p.dim() == 2:
            dim = 1 if p.shape[1] % n_model == 0 else None
        specs[name] = dim
    return specs


def count_model_sharded(specs: Dict[str, Optional[int]]) -> int:
    """Leaves placed on the model axis (JAX tensor.py:203-208)."""
    return sum(d is not None for d in specs.values())


def _narrow(x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    per = x.shape[dim] // n
    return x.narrow(dim, rank * per, per)


class _Enter(torch.autograd.Function):
    """Megatron's ``f``: identity forward, gradient summed backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce_(grad.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    """Megatron's ``g``: partial sums summed forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Whole(torch.autograd.Function):
    """All-gather along ``dim`` (an all-reduce of a buffer each rank
    fills in its block; exact), the rank's slice backward."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        shape = list(x.shape)
        shape[dim] *= axis.size
        out = x.new_zeros(shape)
        _narrow(out, dim, axis.rank, axis.size).copy_(x)
        return axis.all_reduce_(out)

    @staticmethod
    def backward(ctx, grad):
        a = ctx.axis
        return _narrow(grad, ctx.dim, a.rank, a.size).contiguous(), None, None


class Shards:
    """The tensor-parallel seam of one agent (``Sender.tp``,
    ``Receiver.tp``, ``Baseline.tp``; ``None`` off the model axis):
    whether its column-parallel and row-parallel layers are sharded,
    whether its prediction head is class-sharded, and the collectives."""

    def __init__(self, axis: Mesh, column: bool = False, row: bool = False,
                 classes: bool = False):
        self.axis = axis
        self.column, self.row, self.classes = column, row, classes

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.axis)

    def whole(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _Whole.apply(x, self.axis, dim % x.dim())

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation's block of its last dim, entering this
        rank's share of a row-parallel product."""
        return _narrow(self.enter(x), -1, self.axis.rank, self.axis.size)

    def column_linear(self, layer: torch.nn.Linear,
                      x: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer: this rank's block of its outputs (all
        of them when the layer is replicated)."""
        if not self.column:
            return layer(x)
        return F.linear(self.enter(x), layer.weight, layer.bias)

    def row_linear(self, layer: torch.nn.Linear,
                   x: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer on this rank's block of its inputs: the
        partial products summed over the model axis, then the bias."""
        return self.reduce(F.linear(x, layer.weight)) + layer.bias

    def class_block(self, num_classes: int) -> Tuple[int, int]:
        return block(num_classes, self.axis.rank, self.axis.size)


def _agent_shards(name: str, specs: Dict[str, Optional[int]], axis: Mesh,
                  class_sharded: bool, num_classes: Optional[int]) -> Shards:
    def sharded(layer):
        return specs.get(f"{name}.{layer}.weight") is not None
    if name == "sender":
        return Shards(axis, column=sharded("image_layer"),
                      row=sharded("binary_layer"))
    if name == "receiver":
        classes = (class_sharded and num_classes is not None
                   and num_classes % axis.size == 0)
        return Shards(axis, classes=classes)
    return Shards(axis, column=sharded("linear1"), row=sharded("linear2"))


# The receiver's parameters that the class-sharded head reads on a
# block of the classes: their gradients are partial sums over the model
# axis (the head's h_z enters through ``f``; ``y1`` is the reference's one
# matrix, both blocks of it read here).
_HEAD_PARAMS = ("y1.weight", "y1.bias", "y2.weight", "y2.bias",
                "d_d.weight", "d_d.bias", "d_h.weight", "d_h.bias",
                "d_attn.weight", "d_attn.bias")


class TensorParallel:
    """One rank's tensor-parallel state over ``mesh.model``.

    :attr:`full` is the single-device agents (phase A, dev sweeps,
    checkpoints); :attr:`shard` the same agents with the model-sharded
    leaves cut to this rank's block (JAX ``shard_params_tp``: taken from
    the full host value every rank holds) and each agent's seam set; the
    replicated leaves are the same tensors in both. ``num_classes``
    (with ``class_sharded``) class-shards the head when the model axis
    divides it."""

    def __init__(self, mesh: Mesh, full: AgentModules,
                 class_sharded: bool = True,
                 num_classes: Optional[int] = None):
        axis = mesh.model
        if axis is None:
            raise ValueError("tensor parallelism needs a (data, model) "
                             "mesh (make_mesh_2d)")
        self.mesh, self.axis, self.full = mesh, axis, full
        self.specs = tp_param_specs(full, axis.size)
        self.shard = shard_params_tp(full, axis, self.specs)
        self.seams = {}
        for name in AGENT_NAMES:
            seam = _agent_shards(name, self.specs, axis, class_sharded,
                                 num_classes)
            getattr(self.shard, name).tp = seam
            self.seams[name] = seam
        self.partial = ([p for n, p in self.shard.receiver.named_parameters()
                         if n in _HEAD_PARAMS]
                        if self.seams["receiver"].classes else [])
        self._full_params = dict(full.named_parameters())
        self._sharded = [(n, p, self.specs[n])
                         for n, p in self.shard.named_parameters()
                         if self.specs[n] is not None]

    def sharded(self, agent: str) -> List[bool]:
        """Which of an agent's parameters (in order) are model-sharded."""
        return [self.specs[f"{agent}.{n}"] is not None
                for n, _ in getattr(self.shard, agent).named_parameters()]

    def gather(self, tensors: List[torch.Tensor], dims: List[int],
               shapes: List[torch.Size]) -> List[torch.Tensor]:
        """Whole tensors of ``shapes`` from each rank's block (sharded on
        ``dims``), in one all-reduce over the model axis."""
        a = self.axis
        whole = []
        for t, d, shape in zip(tensors, dims, shapes):
            buf = t.new_zeros(shape)
            _narrow(buf, d, a.rank, a.size).copy_(t)
            whole.append(buf.reshape(-1))
        flat = a.all_reduce_(torch.cat(whole))
        out, off = [], 0
        for shape in shapes:
            n = int(torch.Size(shape).numel())
            out.append(flat[off:off + n].view(shape))
            off += n
        return out

    @torch.no_grad()
    def sync(self) -> None:
        """Refresh :attr:`full`'s model-sharded leaves from the ranks'
        blocks (one all-reduce); its replicated ones are the shards'."""
        if not self._sharded:
            return
        names = [n for n, _, _ in self._sharded]
        got = self.gather([p for _, p, _ in self._sharded],
                          [d for _, _, d in self._sharded],
                          [self._full_params[n].shape for n in names])
        for n, g in zip(names, got):
            self._full_params[n].copy_(g)

    @torch.no_grad()
    def reduce_partial_grads(self) -> None:
        """Sum the class-sharded head's partial gradients over the model
        axis (one all-reduce), before the data axis's."""
        if not self.partial:
            return
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.partial]
        flat = self.axis.all_reduce_(torch.cat([g.reshape(-1)
                                                for g in grads]))
        off = 0
        for p in self.partial:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()

    @torch.no_grad()
    def global_norms(self, names,
                     grads: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
        """Each agent's gradient norm over its whole parameters, from its
        flat gradient's two blocks (``game/train.py:flat_order``): the
        replicated leaves, counted once, then the sharded ones, whose
        squares are summed over the model axis (one all-reduce for every
        agent)."""
        rep = [(grads[name][0] * grads[name][0]).sum() for name in names]
        shd = self.axis.all_reduce_(torch.stack(
            [(grads[name][1] * grads[name][1]).sum() for name in names]))
        return {name: torch.sqrt(r + s)
                for name, r, s in zip(names, rep, shd)}

    @torch.no_grad()
    def full_opt_states(self, opt_states: Dict[str, Dict[str, Any]]
                        ) -> Dict[str, Dict[str, Any]]:
        """The optimizer slots in the single-device layout: each sharded
        slot gathered over the model axis (one all-reduce), the others
        as they are (the checkpoint's layout)."""
        picks, out = [], {}
        for agent in AGENT_NAMES:
            names = [n for n, _ in getattr(self.shard, agent)
                     .named_parameters()]
            st = {k: (list(v) if isinstance(v, list) else v)
                  for k, v in opt_states[agent].items()}
            for slot in ("mu", "nu"):
                for i, n in enumerate(names):
                    if slot in st and self.specs[f"{agent}.{n}"] is not None:
                        picks.append((agent, slot, i, f"{agent}.{n}"))
            out[agent] = st
        if picks:
            got = self.gather(
                [out[a][s][i] for a, s, i, _ in picks],
                [self.specs[n] for *_, n in picks],
                [self._full_params[n].shape for *_, n in picks])
            for (a, s, i, _), g in zip(picks, got):
                out[a][s][i] = g
        return out


@torch.no_grad()
def shard_params_tp(full: AgentModules, axis: Mesh,
                    specs: Optional[Dict[str, Optional[int]]] = None
                    ) -> AgentModules:
    """The agents with each model-sharded leaf cut to this rank's block of
    the full value (a new tensor) and every other leaf the full agents'
    own tensor (JAX tensor.py:153-165). Registration order, and so every
    optimizer slot's position, is the full agents'."""
    if specs is None:
        specs = tp_param_specs(full, axis.size)
    shard = AgentModules(full.cfg)
    for name, p in full.named_parameters():
        owner = shard
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        dim = specs[name]
        setattr(owner, leaf, p if dim is None else torch.nn.Parameter(
            _narrow(p.detach(), dim, axis.rank, axis.size).clone()))
    return shard


def _check_opt_placement(opt_states: Dict[str, Dict[str, Any]],
                         shard: AgentModules,
                         specs: Dict[str, Optional[int]]) -> int:
    """Guard against a silent replicated accumulator (JAX
    tensor.py:211-244): every slot list mirrors its agent's parameters,
    each slot shaped like the rank's block of its parameter. Returns the
    model-sharded slot count."""
    n_opt = 0
    for agent in AGENT_NAMES:
        named = list(getattr(shard, agent).named_parameters())
        for slot in ("mu", "nu"):
            got = opt_states.get(agent, {}).get(slot)
            if got is None:
                continue
            if len(got) != len(named):
                raise ValueError(
                    f"tensor parallelism: {agent}'s {slot} holds {len(got)} "
                    f"accumulators for {len(named)} parameters")
            for (n, p), acc in zip(named, got):
                if tuple(acc.shape) != tuple(p.shape):
                    raise ValueError(
                        f"tensor parallelism: the {slot} accumulator of "
                        f"{agent}.{n} is {tuple(acc.shape)}, its parameter "
                        f"{tuple(p.shape)} — the optimizer state does not "
                        "mirror the model-sharded parameters")
                n_opt += specs[f"{agent}.{n}"] is not None
    return n_opt


def init_tp_opt_states(cfg, tp: TensorParallel) -> Dict[str, Dict[str, Any]]:
    """Optimizer states for the rank's shards, each slot shaped like the
    parameter block it mirrors (JAX tensor.py:260-282)."""
    from multimodalgame_tpu_torch.game.train import init_opt_states
    states = init_opt_states(cfg, tp.shard)
    _check_opt_placement(states, tp.shard, tp.specs)
    return states


@torch.no_grad()
def place_opt_states_tp(opt_states: Dict[str, Dict[str, Any]],
                        tp: TensorParallel) -> Dict[str, Dict[str, Any]]:
    """Existing single-device optimizer states (a resumed checkpoint's)
    with each slot of a model-sharded parameter cut to the rank's block
    (JAX tensor.py:247-257); the placement is checked."""
    a = tp.axis
    out = {}
    for agent in AGENT_NAMES:
        names = [n for n, _ in getattr(tp.full, agent).named_parameters()]
        st = dict(opt_states[agent])
        for slot in ("mu", "nu"):
            if slot not in st:
                continue
            st[slot] = [x if i >= len(names)
                        or tp.specs[f"{agent}.{names[i]}"] is None
                        else _narrow(x, tp.specs[f"{agent}.{names[i]}"],
                                     a.rank, a.size).clone()
                        for i, x in enumerate(st[slot])]
        out[agent] = st
    _check_opt_placement(out, tp.shard, tp.specs)
    return out
