"""Training steps, the four per-agent optimizers, and the eval-mode
exchange used by serving.

Port of ``multimodalgame_tpu/game/train.py``. The reference runs one
forward ``exchange`` per batch and then four separate backward/clip/step
updates: receiver, sender and the two baselines (model.py:1307-1330).
Every tensor that crosses between the agents is detached, so one
``backward()`` of the summed loss gives each agent exactly its own
gradient. Each agent then takes its own clip-by-global-norm(1.0) and
optimizer step, written out by hand with optax's conventions
(train.py:42-62): RMSprop with ``alpha = 0.99`` and ``eps`` outside the
square root, Adam with bias correction, plain SGD. The rule is a pure
function (:func:`optimizer_update`), which the single game applies in
place over its flat carry and the population (``parallel/population.py``)
over its stacked members.

With ``compute_dtype="bfloat16"`` the conversation runs on bfloat16
copies of the float32 parameters and the losses in float32
(:func:`in_compute_dtype`, JAX train.py:84-120); phase A then samples on
the plain exchange, as the train kernel is float32-only.

The steps update the modules and the optimizer states in place and
return the metrics. Randomness is pluggable: by default the uniforms of
global step ``s`` are Philox4x32-10 keyed by ``(seed, s)``
(``ops/philox.py``; the train-mode kernel draws the same numbers itself),
so how steps are split into chunks cannot change a run. A caller may
instead pass ``uniforms``, a function ``step -> {s, z, w[, fz, fw]}``;
the tests pass one that replays the JAX package's draws.

On a data-parallel mesh (``mesh``, ``parallel/mesh.py``) every rank
holds the same whole batch and steps on its own rows
``[r·B/N, (r+1)·B/N)``: its uniforms are those rows of the whole batch's
(Philox numbers them from the shard's first global row, ``row_base``),
its losses' batch statistics are global (``game/losses.py``), and one
all-reduce a step sums the updated agents' gradients, with the step's
logged scalars in the same buffer, before each agent's clip and
optimizer step. Every rank then applies the same update, so the
parameters stay equal without a broadcast. A step that returns the full
metrics (:func:`make_train_step`, :func:`make_train_step_indexed`)
gathers the rows' predictions and conversation record in rank order, so
it returns what the single-device step returns.

Every trainer carries each trained agent flat, as JAX's K-step trainers
do by default (train.py:307-355): its parameters, its gradient and each
optimizer slot are one contiguous buffer each (:func:`flat_buffers`), so
the clip, the rule and the update are a handful of kernels an agent
rather than a leaf. The parameters and the per-leaf slot lists are views
of those buffers, so everything that reads them leaf by leaf
(checkpoints, resume, serving) is unchanged. The numbers differ from
JAX's per-leaf steps only by the order of the clip's sum of squares
(JAX train.py:314-316).

Visual attention takes the feature map ``(B, C, H, W)`` as ``data`` and,
with ``attn_extra_context``, the ``fc`` context; description attention
the padded word sets. Each factory's step takes them as keyword
arguments (``data_context`` or, over a staged set, ``feats_context``,
gathered by the same indices as the features; ``desc_set_padded`` and
``desc_set_mask``), as the JAX package's steps do.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch
from torch.autograd.graph import increment_version

from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import (ExchangeOutputs,
                                                    exchange,
                                                    finalize_stop_masks,
                                                    needed_uniforms)
from multimodalgame_tpu_torch.game.losses import (get_rec_outp, loglikelihood,
                                                  multistep_loss_bas,
                                                  multistep_loss_binary,
                                                  nll_loss, topk_accuracy)
from multimodalgame_tpu_torch.game.masks import assemble_loss_masks
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    eval_kernel_supports, fused_eval_exchange, kernel_params,
    supports_config, train_kernel_supports)
from multimodalgame_tpu_torch.ops.philox import philox_uniforms
from multimodalgame_tpu_torch.utils.cuda_graph import Captured, clone_tree
from multimodalgame_tpu_torch.utils.device import resolve_device

UniformSource = Callable[[int], Dict[str, torch.Tensor]]
FAST_MODES = (True, False, "auto", "kernel")

# optax's constants (train.py:48-53).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.99, 1e-8
CLIP_NORM = 1.0


# ---------------------------------------------------------------- optimizers

def init_opt_states(cfg: GameConfig, modules: AgentModules
                    ) -> Dict[str, Dict[str, Any]]:
    """Per-agent optimizer slots, zeros beside each parameter: RMSprop
    ``nu``, Adam ``mu``/``nu`` and ``count`` (a 0-dim int64 tensor on the
    parameters' device, so that a captured step advances it), nothing for
    SGD."""
    return zero_slots(cfg, {name: list(getattr(modules, name).parameters())
                            for name in AGENT_NAMES})


def zero_slots(cfg: GameConfig, params: Dict[str, List[torch.Tensor]]
               ) -> Dict[str, Dict[str, Any]]:
    """:func:`init_opt_states` for each agent's list of parameter tensors
    (a population's stacked ones too)."""
    if cfg.optim_type not in ("SGD", "Adam", "RMSprop"):
        raise NotImplementedError(cfg.optim_type)
    states = {}
    for name, tensors in params.items():
        state: Dict[str, Any] = {}
        if cfg.optim_type in ("Adam", "RMSprop"):
            state["nu"] = [torch.zeros_like(p) for p in tensors]
        if cfg.optim_type == "Adam":
            state["mu"] = [torch.zeros_like(p) for p in tensors]
            state["count"] = torch.zeros((), dtype=torch.int64,
                                         device=tensors[0].device)
        states[name] = state
    return states


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float = CLIP_NORM,
                        batch_dims: int = 0,
                        norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``g`` when ``‖g‖ < max_norm``,
    else ``(g / ‖g‖) · max_norm``. Not torch's ``clip_grad_norm_``, which
    divides by ``‖g‖ + 1e-6``. With ``batch_dims`` leading axes (a
    population's member axis) the norm is taken per index of those axes,
    over every other axis. ``norm`` is ``‖g‖`` where the caller took it
    (tensor parallelism: over the whole agent, not this rank's blocks)."""
    def sq(g):
        return (g * g).sum(dim=tuple(range(batch_dims, g.dim()))) \
            if g.dim() > batch_dims else g * g
    if norm is None:
        norm = torch.sqrt(sum(sq(g) for g in grads))
    keep = norm < max_norm

    def lift(x, g):
        return x.reshape(x.shape + (1,) * (g.dim() - batch_dims))
    return [torch.where(lift(keep, g), g, (g / lift(norm, g)) * max_norm)
            for g in grads]


@torch.no_grad()
def optimizer_update(cfg: GameConfig, grads: List[torch.Tensor],
                     state: Dict[str, Any], batch_dims: int = 0,
                     norm: Optional[torch.Tensor] = None
                     ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
    """One agent's clip-by-global-norm and optimizer rule as a pure
    function: ``(updates, new_state)``, where the parameter moves by
    ``-learning_rate * update`` (train.py:42-62, 293-304). ``state`` is
    not changed. ``batch_dims`` leading axes of every tensor (a
    population's member axis) are independent problems: the clip norm is
    taken per member, every other step is elementwise. ``norm`` is the
    clip's gradient norm where the caller took it."""
    grads = clip_by_global_norm(grads, batch_dims=batch_dims, norm=norm)
    if cfg.optim_type == "SGD":
        return grads, state
    if cfg.optim_type == "RMSprop":
        nu = [(1 - RMS_DECAY) * g ** 2 + RMS_DECAY * v
              for g, v in zip(grads, state["nu"])]
        return ([(1 / (torch.sqrt(v) + RMS_EPS)) * g
                 for g, v in zip(grads, nu)], {**state, "nu": nu})
    if cfg.optim_type == "Adam":
        count = state["count"] + 1
        # A tensor count (every trainer's) gives the bias corrections on
        # its device in float64, as Python gives them for an int count.
        n = (count.to(torch.float64) if isinstance(count, torch.Tensor)
             else count)
        c1, c2 = 1 - ADAM_B1 ** n, 1 - ADAM_B2 ** n
        mu = [(1 - ADAM_B1) * g + ADAM_B1 * m
              for g, m in zip(grads, state["mu"])]
        nu = [(1 - ADAM_B2) * g ** 2 + ADAM_B2 * v
              for g, v in zip(grads, state["nu"])]
        return ([(m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
                 for m, v in zip(mu, nu)],
                {**state, "mu": mu, "nu": nu, "count": count})
    raise NotImplementedError(cfg.optim_type)


# ---------------------------------------------------------- flat carry

def flat_order(tensors: List[torch.Tensor],
               sharded: Optional[List[bool]] = None) -> List[int]:
    """The order in which an agent's leaves lie in its flat buffers: the
    registration order, or under tensor parallelism (``sharded``, one flag
    a leaf) the replicated leaves first, so that the clip norm reads each
    kind as one block."""
    idx = list(range(len(tensors)))
    if sharded is None:
        return idx
    return ([i for i in idx if not sharded[i]]
            + [i for i in idx if sharded[i]])


def _flat_view(tensors: List[torch.Tensor],
               order: List[int]) -> Optional[torch.Tensor]:
    """The 1-D tensor over the memory that ``tensors``, taken in
    ``order``, fill back to back in one storage; None if they do not."""
    first = tensors[order[0]]
    ptr = first.untyped_storage().data_ptr()
    start = end = first.storage_offset()
    for i in order:
        t = tensors[i]
        if (t.storage_offset() != end or not t.is_contiguous()
                or t.untyped_storage().data_ptr() != ptr):
            return None
        end += t.numel()
    return first.detach().new_empty(0).set_(first.untyped_storage(), start,
                                            (end - start,))


def _pack(tensors: List[torch.Tensor], order: List[int]
          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One new 1-D buffer holding ``tensors`` in ``order``, and each
    tensor's view of it (in the tensors' own order)."""
    buf = torch.cat([tensors[i].detach().reshape(-1) for i in order])
    views: List[Optional[torch.Tensor]] = [None] * len(tensors)
    off = 0
    for i in order:
        n = tensors[i].numel()
        views[i] = buf[off:off + n].view_as(tensors[i])
        off += n
    return buf, views


@torch.no_grad()
def flat_buffers(params: List[torch.nn.Parameter], state: Dict[str, Any],
                 order: List[int]) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """One agent's flat carry (JAX ``_flat_carry``, train.py:307-349): its
    parameters as views of one contiguous buffer, and each optimizer slot
    (``nu``, ``mu``) as views of one buffer each, laid out in ``order``.
    The per-leaf API stays: each parameter keeps its identity (its
    ``.data`` becomes a view) and each slot list its per-leaf entries
    (now views), so ``named_parameters``, checkpoints and
    ``opt_states[agent]["nu"]`` read as before. Leaves already laid out
    so are taken as they are (no copy); others, such as new slots, a
    resumed state or modules moved to another device, are packed
    anew. An integer Adam ``count`` becomes a 0-dim int64 tensor on the
    buffer's device. Returns ``(parameter buffer, {slot: buffer})``."""
    pbuf = _flat_view(params, order)
    if pbuf is None:
        pbuf, views = _pack(params, order)
        for p, v in zip(params, views):
            p.data = v
    if "count" in state and not (
            isinstance(state["count"], torch.Tensor)
            and state["count"].device == pbuf.device):
        state["count"] = torch.full((), int(state["count"]),
                                    dtype=torch.int64, device=pbuf.device)
    slots = {}
    for slot in ("mu", "nu"):
        if slot not in state:
            continue
        buf = _flat_view(state[slot], order)
        if buf is None:
            buf, views = _pack(state[slot], order)
            state[slot][:] = views
        slots[slot] = buf
    return pbuf, slots


@torch.no_grad()
def apply_flat_updates(cfg: GameConfig, update_names,
                       flats: Dict[str, Tuple[torch.Tensor, Dict]],
                       grads: Dict[str, torch.Tensor],
                       opt_states: Dict[str, Dict[str, Any]],
                       params: Dict[str, List[torch.nn.Parameter]],
                       norms: Optional[Dict[str, torch.Tensor]] = None
                       ) -> None:
    """One clip + optimizer step per trained agent, in place, on the flat
    carry (train.py:293-304): each agent's clip (one sum of squares),
    rule and update over its whole buffer, so a handful of kernels an
    agent instead of a handful a leaf. ``grads`` are the agents' flat
    gradients laid out as their buffers (:func:`flat_buffers`); ``norms``
    the clip's norms where the caller took them (tensor parallelism: the
    norm of the whole agent, not of this rank's shards)."""
    lr = cfg.learning_rate
    norms = norms or {}
    for name in update_names:
        pbuf, slots = flats[name]
        state = opt_states[name]
        updates, new = optimizer_update(
            cfg, [grads[name]], {**state, **{s: [b] for s, b in
                                            slots.items()}},
            norm=norms.get(name))
        for slot, buf in slots.items():
            buf.copy_(new[slot][0])
        if "count" in state:
            state["count"].copy_(new["count"])
        pbuf.add_(-lr * updates[0])
        # The parameters were changed through the buffer: bump their
        # version counters, as an in-place update of each would.
        for p in params[name]:
            increment_version(p)


# -------------------------------------------------------------------- losses

class TrainMetrics(NamedTuple):
    """What the driver's interval logging needs (model.py:1341-1542)."""
    loss_rec: torch.Tensor
    loss_sen: torch.Tensor
    nll_loss: torch.Tensor
    loss_binary_rec: torch.Tensor
    loss_binary_s: torch.Tensor
    loss_bas_rec: torch.Tensor
    loss_bas_sen: torch.Tensor
    ent_binary_sen: torch.Tensor   # (T,)  per-turn negentropies
    ent_binary_rec: torch.Tensor   # (T-1,) (empty when max_exchange == 1)
    ent_y_rec: torch.Tensor        # (T,)
    accuracy: torch.Tensor
    dist: torch.Tensor             # (B, D) log-softmax scores
    argmax: torch.Tensor           # (B,)
    exchange: ExchangeOutputs


class ScanMetrics(NamedTuple):
    """Per-step scalars of the multi-step trainer, each ``(K,)``."""
    loss_rec: torch.Tensor
    loss_sen: torch.Tensor
    nll_loss: torch.Tensor
    loss_bas_rec: torch.Tensor
    loss_bas_sen: torch.Tensor
    accuracy: torch.Tensor


def losses_from_exchange(cfg: GameConfig, ex: ExchangeOutputs,
                         target: torch.Tensor, top_k: int, batch_denom: int,
                         reduce=None) -> Tuple[torch.Tensor, TrainMetrics]:
    """Every loss term from a (differentiable) conversation record, and
    their sum (train.py:123-186, model.py:1264-1305). On a data-parallel
    mesh ``reduce`` makes the batch statistics global and the losses,
    negentropies and accuracy are this rank's shares
    (``game/losses.py``)."""
    T = cfg.max_exchange
    masks = None if cfg.fixed_exchange else assemble_loss_masks(ex.stop_masks)

    outp, ent_y = get_rec_outp(ex.y, None if masks is None else masks.y,
                               reduce)
    dist = torch.log_softmax(outp, dim=-1)
    argmax = dist.argmax(dim=-1)
    nll = nll_loss(dist, target, reduce)
    logs = loglikelihood(dist, target).detach()     # reward (model.py:1274)

    zero = dist.new_zeros(())
    loss_binary_s = loss_binary_rec = loss_binary_sen = zero
    loss_bas_rec = loss_bas_sen = zero
    ent_s = dist.new_zeros((T,))
    ent_rec = dist.new_zeros((max(T - 1, 0),))
    ent_sen = dist.new_zeros((T,))

    if cfg.use_binary:
        if not cfg.fixed_exchange:
            loss_binary_s, ent_s = multistep_loss_binary(
                ex.stop_feats, ex.stop_probs, logs, ex.br,
                masks.binary_s, cfg.entropy_s, reduce)
        if T > 1:
            # No receiver z-loss when the conversation stops after the
            # first sender message (model.py:1284-1289).
            loss_binary_rec, ent_rec = multistep_loss_binary(
                ex.rec_feats[:-1], ex.rec_probs[:-1], logs, ex.br[:-1],
                None if masks is None else masks.binary_rec,
                cfg.entropy_rec, reduce)
        loss_binary_sen, ent_sen = multistep_loss_binary(
            ex.sen_feats, ex.sen_probs, logs, ex.bs,
            None if masks is None else masks.binary_sen, cfg.entropy_sen,
            reduce)
        loss_bas_rec = multistep_loss_bas(
            ex.br, logs, None if masks is None else masks.bas_rec, reduce)
        loss_bas_sen = multistep_loss_bas(
            ex.bs, logs, None if masks is None else masks.bas_sen, reduce)

    loss_rec = nll
    if cfg.use_binary:
        loss_rec = loss_rec + loss_binary_rec
        if not cfg.fixed_exchange:
            loss_rec = loss_rec + loss_binary_s
    loss_sen = loss_binary_sen
    total = loss_rec + loss_sen + loss_bas_rec + loss_bas_sen

    accuracy = topk_accuracy(dist, target, top_k, batch_denom)
    metrics = TrainMetrics(
        loss_rec=loss_rec, loss_sen=loss_sen, nll_loss=nll,
        loss_binary_rec=loss_binary_rec, loss_binary_s=loss_binary_s,
        loss_bas_rec=loss_bas_rec, loss_bas_sen=loss_bas_sen,
        ent_binary_sen=ent_sen, ent_binary_rec=ent_rec, ent_y_rec=ent_y,
        accuracy=accuracy, dist=dist, argmax=argmax, exchange=ex)
    return total, metrics


def cast_floating(x, dtype: torch.dtype):
    """``x`` with every floating tensor cast to ``dtype``: a tensor, or a
    named tuple of tensors and other values (a conversation record); other
    values pass through. Differentiable: gradients come back in each
    source's dtype (JAX game/train.py:84-91)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        return type(x)(*(cast_floating(v, dtype) for v in x))
    return x


def in_compute_dtype(modules: AgentModules, conversation: Callable,
                     *tensors, **kwargs) -> ExchangeOutputs:
    """``conversation(modules, *tensors, **kwargs)``, a function that
    returns the conversation record, in ``cfg.compute_dtype``.

    Under ``bfloat16`` the agents run on bfloat16 copies of their float32
    parameters (cast differentiably, so gradients come back float32 to
    the parameters the optimizers update), the floating ``tensors`` and
    the attention inputs among ``kwargs`` are cast too, and the record is
    cast back to float32 before any loss algebra (JAX
    game/train.py:110-120). The uniforms stay float32 and are compared
    with the probabilities in float32 (ops/sampling.py)."""
    if modules.cfg.compute_dtype != "bfloat16":
        return conversation(modules, *tensors, **kwargs)
    bf16 = torch.bfloat16
    kwargs = {k: (v if k == "uniforms" else cast_floating(v, bf16))
              for k, v in kwargs.items()}
    params = {k: p.to(bf16) for k, p in modules.named_parameters()}
    ex = torch.func.functional_call(
        modules, params, (conversation,) + tuple(
            cast_floating(t, bf16) for t in tensors), kwargs)
    return cast_floating(ex, torch.float32)


def compute_losses(modules: AgentModules, data: torch.Tensor,
                   target: torch.Tensor, desc: torch.Tensor, top_k: int,
                   batch_denom: int, uniforms: Dict[str, torch.Tensor],
                   reduce=None, **inputs
                   ) -> Tuple[torch.Tensor, TrainMetrics]:
    """One training forward pass through the plain train-mode exchange,
    baselines scored turn by turn, and every loss term
    (train.py:94-120). ``inputs`` are the exchange's attention inputs
    (``data_context``, ``desc_set_padded``, ``desc_set_mask``). Under
    ``compute_dtype="bfloat16"`` the conversation runs in bfloat16 and the
    losses in float32 (:func:`in_compute_dtype`). ``reduce`` is the
    data-parallel seam of :func:`losses_from_exchange`."""
    ex = in_compute_dtype(modules, _train_exchange, data, desc,
                          uniforms=uniforms, **inputs)
    return losses_from_exchange(modules.cfg, ex, target, top_k, batch_denom,
                                reduce)


def _train_exchange(modules, data, desc, **kwargs) -> ExchangeOutputs:
    return exchange(modules, data, desc, train=True, **kwargs)


# ------------------------------------------------------------------- trainers

# The graph route: eager steps of a step signature before its capture, and
# the rows of the staged index plan a graph holds (the driver's piece
# planner never cuts a chunk longer than 512, game/driver.py).
GRAPH_WARMUP = 2
INDEX_CAPACITY = 512


def step_route(device: Optional[Union[str, torch.device]] = None,
               mesh=None, tp=None) -> str:
    """How a trainer takes its steps: ``"graph"`` on a CUDA device
    (``None`` is ``cuda``) when every collective of the step is NCCL's
    (no mesh, or a mesh and, under a grid, its model axis of ranks on
    distinct cards), each step a replay of one captured CUDA graph with
    the step's collectives inside it (the port of the JAX package's one
    compiled program per K updates, train.py:470-491, and per sharded
    step, parallel/mesh.py:101-131); ``"eager"`` on the CPU, and on a
    card for ranks that share it, whose gloo collectives run on the host
    and cannot be captured. A route by configuration, decided from the
    arguments alone (``tp``'s axes are ``tp.mesh`` and its ``model``),
    without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "eager"
    if tp is not None:
        mesh = tp.mesh
    axes = (mesh, getattr(mesh, "model", None))
    return ("graph" if all(a.backend == "nccl" for a in axes
                           if a is not None) else "eager")


def _detach(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, tuple):
        return type(x)(*(_detach(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(_detach(v) for v in x)
    return x


class _Trainer:
    """The state every factory shares: the loss function for ``fast``,
    the device, the uniform source, the agents to update and, on a
    data-parallel mesh, this rank's place in it. Under tensor parallelism
    (``tp``, whose ``full`` are ``modules``) the step trains the rank's
    shards, phase A samples on the whole agents, and ``mesh`` is the data
    axis (with one data shard, no data-axis collective runs). Each
    trained agent's parameters, gradient and optimizer slots are one
    buffer each (:func:`flat_buffers`), laid out at the first step, after
    the move to the device.

    Every update runs one body (:class:`_StepGraph`), which reads its
    batch from static buffers and its randomness from a device counter.
    ``graph`` (default: :func:`step_route`) decides whether the body is
    captured: on the "graph" route each step signature is one captured
    CUDA graph, replayed once per update, a mesh's NCCL collectives inside
    it; on the CPU, on a card for a gloo mesh, and with ``graph=False``
    the body runs as it is on every update. ``graph=True`` on a card needs
    the route to be "graph" (a gloo mesh raises); on the CPU it captures
    nothing."""

    def __init__(self, modules: AgentModules, top_k: int, batch_denom: int,
                 fast: Union[bool, str], seed: int,
                 uniforms: Optional[UniformSource],
                 device: Optional[Union[str, torch.device]], mesh=None,
                 tp=None, graph: Optional[bool] = None):
        cfg = modules.cfg
        if tp is not None and (tp.full is not modules or fast is False):
            raise ValueError("tensor parallelism trains the agents of its "
                             "TensorParallel on the fast path")
        if not (fast is True or fast is False or fast in ("auto", "kernel")):
            raise ValueError(f"fast must be one of {FAST_MODES}, got "
                             f"{fast!r}")
        if fast == "kernel" and not (supports_config(cfg) and
                                     cfg.compute_dtype == "float32"):
            raise ValueError(
                "fast='kernel' needs a config the train kernel samples: "
                "binary channel, no attention, sum or prod mix, no "
                "-flipout_dev with flipout, and float32 compute (the "
                "kernel samples in float32 only; bfloat16 takes the plain "
                "sampler)")
        where = device if mesh is None else mesh.device
        route = step_route(where, mesh, tp)
        if graph and route != "graph" and torch.device(
                "cuda" if where is None else where).type == "cuda":
            raise ValueError("a step over gloo collectives (ranks that "
                             "share a card) runs eagerly: gloo's "
                             "collectives cannot be captured")
        self.tp = tp
        self.modules = modules if tp is None else tp.shard
        self.cfg = cfg
        self.top_k, self.batch_denom = top_k, batch_denom
        self.fast = fast is not False
        self.sampler = "kernel" if fast == "kernel" else "plain"
        self.seed, self.uniforms = int(seed), uniforms
        self.mesh = mesh
        # The data axis's collectives: none on one data shard of a grid.
        self.reduce = (None if tp is not None and mesh.size == 1
                       else mesh)
        self.device = resolve_device(where)
        self.capture = ((route == "graph" if graph is None else bool(graph))
                        and self.device.type == "cuda")
        modules.to(self.device)
        self.dtype = next(modules.parameters()).dtype
        self.update_names = AGENT_NAMES if cfg.use_binary else ("receiver",)
        # The flat carry's layout (flat_order) and, under tensor
        # parallelism, which leaves are model-sharded: fixed by the agents.
        self.sharded = {name: None if tp is None else tp.sharded(name)
                        for name in self.update_names}
        self.orders = {name: flat_order(list(getattr(self.modules, name)
                                             .parameters()),
                                        self.sharded[name])
                       for name in self.update_names}
        # Shape signature -> (carry and input addresses, _StepGraph).
        self._graphs: Dict[tuple, Tuple[tuple, "_StepGraph"]] = {}

    def tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype or self.dtype,
                               device=self.device)

    def counters(self) -> List[Tuple[Any, str]]:
        """The collective counts of the step's axes (``Mesh.calls``,
        ``grad_calls``), which a graph's replays advance
        (:class:`Captured`)."""
        axes = [] if self.mesh is None else [self.mesh, self.mesh.model]
        return [(a, k) for a in axes if a is not None
                for k in ("calls", "grad_calls")]

    def rows(self, batch: int) -> slice:
        """This rank's rows of a batch of ``batch`` (all of them off the
        mesh); a training batch must split evenly over the ranks."""
        if self.mesh is None:
            return slice(0, batch)
        if batch % self.mesh.size:
            raise ValueError(f"a training batch of {batch} does not split "
                             f"over {self.mesh.size} ranks")
        return slice(*self.mesh.rows(batch))

    def key_randomness(self, key: torch.Tensor, batch: int,
                       uniforms: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, Any]:
        """The randomness of a step keyed by ``key``, the int64 device
        tensor ``[seed, step, row_base]``: the key itself for the kernel,
        which draws its uniforms, else the key's Philox uniforms of the
        ``batch`` rows from ``row_base``, drawn on the device; ``uniforms``,
        the caller's source's numbers of this step, where it has one."""
        if uniforms is not None:
            return {"uniforms": uniforms}
        if self.sampler == "kernel":
            return {"key": key}
        return {"uniforms": philox_uniforms(self.cfg, batch, key[0], key[1],
                                            self.device, row_base=key[2])}

    def step(self, opt_states, data: torch.Tensor, target: torch.Tensor,
             desc: torch.Tensor, rand: Dict[str, Any], full: bool = False,
             **inputs) -> TrainMetrics:
        """One update on ``data`` (this rank's rows on a mesh) with the
        randomness ``rand`` (:meth:`key_randomness`); ``inputs`` are the
        attention inputs. On the mesh the gradients and the logged scalars
        are summed over the ranks and, with ``full``, the rows'
        predictions and record gathered."""
        from multimodalgame_tpu_torch.game.fast_train import (
            compute_losses_fast)
        if self.sampler == "kernel" and not train_kernel_supports(
                self.cfg, data.shape[0], desc.shape[0]):
            raise ValueError(
                f"fast='kernel': no launch plan of the train kernel fits "
                f"{data.shape[0]} rows and {desc.shape[0]} classes at this "
                f"width; train it with fast='auto' (the plain sampler)")
        self.modules.zero_grad(set_to_none=True)
        if self.fast:
            total, metrics = compute_losses_fast(
                self.modules, data, target, desc, self.top_k,
                self.batch_denom, sampler=self.sampler, reduce=self.reduce,
                sample_modules=None if self.tp is None else self.tp.full,
                **rand, **inputs)
        else:
            total, metrics = compute_losses(
                self.modules, data, target, desc, self.top_k,
                self.batch_denom, rand["uniforms"], reduce=self.reduce,
                **inputs)
        total.backward()
        metrics = _detach(metrics)
        if self.tp is not None:
            self.tp.reduce_partial_grads()
        metrics = self.update(opt_states, metrics, full)
        if self.tp is not None:
            self.tp.sync()
        return metrics

    def lay_out(self, opt_states) -> tuple:
        """Lay out every trained agent's flat carry (:func:`flat_buffers`)
        and return the addresses of its buffers and of Adam's count: what
        a captured step reads and writes."""
        ptrs = []
        for name in self.update_names:
            pbuf, slots = flat_buffers(
                list(getattr(self.modules, name).parameters()),
                opt_states[name], self.orders[name])
            ptrs += [pbuf.data_ptr()] + [b.data_ptr() for b in
                                         slots.values()]
            if "count" in opt_states[name]:
                ptrs.append(opt_states[name]["count"].data_ptr())
        return tuple(ptrs)

    def run_graph(self, opt_states, kind: str, steps: int, step0: int,
                  stacks: Dict[str, Any], fixed: Dict[str, Any],
                  make_batch: Callable, full: bool):
        """``steps`` updates through the step body, step ``i`` on row
        ``i`` of each of ``stacks`` (the index plan ``idx``, a host array,
        or tensors staged per step) with the randomness of global step
        ``step0 + i``; ``fixed`` are the inputs every step reads where
        they lie (the staged set, the descriptions), ``make_batch(rows,
        fixed) -> (data, target, desc, inputs)`` builds a step's batch
        from its rows. Returns the last step's :class:`TrainMetrics` with
        ``full``, else the steps' :class:`ScanMetrics`, copied out of the
        body's buffers. On a mesh the stacks (axis 1 the batch) and a
        uniform source's numbers are cut to this rank's rows first, and
        the counter's ``row_base`` is the rank's first row. A step
        signature's body is built once, and built again for a longer
        chunk or, where it is captured, when the carry or a ``fixed``
        input moves: a graph reads them at the addresses it captured."""
        rows = self.rows(next(iter(stacks.values())).shape[1])
        stacks = {k: v[:, rows] for k, v in stacks.items()}
        if self.uniforms is not None:
            drawn = [self.uniforms(int(step0) + i) for i in range(steps)]
            for name in drawn[0]:
                stacks["u:" + name] = torch.stack(
                    [u[name][:, rows].to(self.device) for u in drawn])
        shape_key = (kind, full, tuple(
            (k, tuple(v.shape[1:]), str(v.dtype)) for k, v in
            stacks.items()), tuple(
                None if v is None else (tuple(v.shape), str(v.dtype))
                for v in fixed.values()))
        ptr_key = self.lay_out(opt_states) + tuple(
            None if v is None else v.data_ptr() for v in fixed.values())
        known = self._graphs.get(shape_key)
        if known is None or steps > known[1].capacity or (
                self.capture and known[0] != ptr_key):
            capacity = max(steps, INDEX_CAPACITY if kind == "indexed"
                           else steps)
            known = (ptr_key, _StepGraph(self, stacks, make_batch, full,
                                         capacity))
            self._graphs[shape_key] = known
        sg = known[1]
        sg.opt_states, sg.fixed = opt_states, fixed
        sg.load(steps, int(step0), rows.start, stacks)
        for _ in range(steps):
            out = sg.step()
        return out if full else ScanMetrics(*sg.out[:, :steps].clone())

    def update(self, opt_states, metrics: TrainMetrics,
               full: bool) -> TrainMetrics:
        """The optimizers' step on the flat carry: each agent's gradient
        as one buffer laid out as its parameters' (on the mesh, its block
        of the all-reduce's buffer, which also makes the logged scalars
        global), one clip, rule and update an agent."""
        params = {name: list(getattr(self.modules, name).parameters())
                  for name in self.update_names}
        flats = {name: flat_buffers(ps, opt_states[name], self.orders[name])
                 for name, ps in params.items()}
        ordered = {name: [ps[i] for i in self.orders[name]]
                   for name, ps in params.items()}
        if self.reduce is not None:
            from multimodalgame_tpu_torch.parallel.mesh import (
                gather_metrics, reduce_step)
            metrics, summed = reduce_step(
                self.reduce, [p for ps in ordered.values() for p in ps],
                metrics)
            if full:
                metrics = gather_metrics(self.reduce, metrics,
                                         self.cfg.fixed_exchange)
            grads, off = {}, 0
            for name, ps in ordered.items():
                n = sum(p.numel() for p in ps)
                grads[name], off = summed[off:off + n], off + n
        else:
            grads = {name: torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1) for p in ps]) for name, ps in ordered.items()}
        norms = None
        if self.tp is not None:
            # The replicated leaves lie first (flat_order): each kind as
            # one block of the clip norm.
            blocks = {}
            for name, ps in params.items():
                rep = sum(p.numel() for p, f in zip(ps, self.sharded[name])
                          if not f)
                blocks[name] = (grads[name][:rep], grads[name][rep:])
            norms = self.tp.global_norms(list(self.update_names), blocks)
        apply_flat_updates(self.cfg, self.update_names, flats, grads,
                           opt_states, params, norms)
        return metrics


class _StepGraph:
    """One step signature's training step, the body every update runs.

    Static buffers hold the step's inputs for a chunk of up to
    ``capacity`` steps (on a mesh, this rank's rows of them): the int64
    counter ``[seed, step, row_base, i]`` (the Philox key the step reads,
    ``row_base`` the rank's first row, and the chunk row it trains on)
    with, behind it, the index plan when it comes from the host, so that
    a chunk's plan and key reach the device in one copy; the other stacks
    (staged batches, a uniform source's numbers) in buffers of their own,
    and the scalars of each step (:class:`ScanMetrics`) in ``out``, a row
    a step. The body (:meth:`_body`) gathers row ``i`` of the stacks, runs
    the trainer's step (zero_grad, phase A, phase B, backward and the
    flat update, on a mesh with its collectives) on the carry
    ``opt_states`` and the inputs ``fixed`` that the caller sets before
    each chunk, and advances the counter. Where the trainer captures,
    :class:`Captured` runs it eagerly for the first GRAPH_WARMUP steps,
    then captures it and replays it once per update, the mesh's
    collective counts advanced at each replay; elsewhere it runs the body
    on every update."""

    def __init__(self, tr: _Trainer, stacks: Dict[str, Any],
                 make_batch: Callable, full: bool, capacity: int):
        dev = tr.device
        self.tr, self.opt_states, self.fixed = tr, None, None
        self.make_batch, self.full, self.capacity = make_batch, full, capacity
        self.host = [k for k, v in stacks.items()
                     if not isinstance(v, torch.Tensor)]
        width = sum(int(np.prod(stacks[k].shape[1:])) for k in self.host)
        self.ints = torch.zeros(4 + capacity * width, dtype=torch.int64,
                                device=dev)
        self.ctr = self.ints[:4]
        self.bufs, off = {}, 4
        for k in self.host:
            n = int(np.prod(stacks[k].shape[1:]))
            self.bufs[k] = self.ints[off:off + capacity * n].view(
                (capacity,) + tuple(stacks[k].shape[1:]))
            off += capacity * n
        for k, v in stacks.items():
            if k not in self.bufs:
                self.bufs[k] = torch.empty((capacity,) + tuple(v.shape[1:]),
                                           dtype=v.dtype, device=dev)
        self.inc = torch.zeros(4, dtype=torch.int64, device=dev)
        self.inc[1::2] = 1                       # step and row, each + 1
        self.out = (None if full else torch.zeros(
            (len(ScanMetrics._fields), capacity), dtype=tr.dtype,
            device=dev))
        self.run = Captured(self._body, dev, GRAPH_WARMUP,
                            capture=tr.capture, counters=tr.counters())

    def load(self, steps: int, step0: int, row_base: int,
             stacks: Dict[str, Any]) -> None:
        """The chunk's stacks into the static buffers and the counter to
        ``(seed, step0, row_base, 0)``: one host-to-device copy of the
        counter and the host's index plan, and one device copy per other
        stack."""
        host = np.concatenate(
            [np.array([self.tr.seed, step0, row_base, 0], np.int64)]
            + [np.asarray(stacks[k], np.int64).reshape(-1)
               for k in self.host])
        src = torch.from_numpy(host)
        if self.ints.device.type == "cuda":
            src = src.pin_memory()
        self.ints[:src.numel()].copy_(src, non_blocking=True)
        for k, v in stacks.items():
            if k not in self.host:
                self.bufs[k][:steps].copy_(v)

    def step(self):
        """One update: the last run's metrics with ``full`` (copied out
        of a replay's buffers), else None."""
        out, replayed = self.run()
        return clone_tree(out) if replayed and self.full else out

    def _body(self):
        tr = self.tr
        pos = self.ctr[3:4]
        rows = {k: b.index_select(0, pos)[0] for k, b in self.bufs.items()}
        data, target, desc, inputs = self.make_batch(rows, self.fixed)
        batch = data.shape[0]
        u = {k[2:]: v for k, v in rows.items() if k.startswith("u:")}
        m = tr.step(self.opt_states, data, target, desc,
                    tr.key_randomness(self.ctr[:3], batch, u or None),
                    full=self.full, **inputs)
        if not self.full:
            self.out.index_copy_(1, pos, torch.stack(_scan_row(m))[:, None])
        self.ctr.add_(self.inc)
        return m if self.full else None


def _plan(idx):
    """An index plan as the graph route stages it: a host array (copied
    with the step counter) or an int64 device tensor."""
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        return idx.long()
    return np.asarray(idx, np.int64)


def _indexed_batch(transform, context_fn):
    """``make_batch`` of the indexed steps: row ``idx`` of the staged
    set."""
    def make_batch(rows, fixed):
        idx = rows["idx"]
        data, ctx = gather_batch(fixed["feats"], idx, fixed["feats_context"],
                                 transform, context_fn)
        return data, fixed["targets"][idx].long(), fixed["desc"], dict(
            data_context=ctx, desc_set_padded=fixed["desc_set_padded"],
            desc_set_mask=fixed["desc_set_mask"])
    return make_batch


def _staged_batch(rows, fixed):
    """``make_batch`` of the staged steps: the step's own batch."""
    return rows["data"], rows["target"], fixed["desc"], dict(
        data_context=rows.get("ctx"),
        desc_set_padded=fixed["desc_set_padded"],
        desc_set_mask=fixed["desc_set_mask"])


def _run_staged(tr: _Trainer, opt_states, data: torch.Tensor,
                target: torch.Tensor, desc, step0: int,
                data_context: Optional[torch.Tensor], desc_set_padded,
                desc_set_mask, full: bool):
    """The staged steps of ``data`` and ``target`` (and ``data_context``),
    stacked a row a step, through :meth:`_Trainer.run_graph`; the
    descriptions are read where they lie, as tensors on the trainer's
    device."""
    def opt(x):
        return None if x is None else tr.tensor(x)
    stacks = {"data": data, "target": target}
    if data_context is not None:
        stacks["ctx"] = data_context
    return tr.run_graph(
        opt_states, "staged", data.shape[0], step0, stacks,
        dict(desc=tr.tensor(desc), desc_set_padded=opt(desc_set_padded),
             desc_set_mask=opt(desc_set_mask)),
        _staged_batch, full)


def make_train_step(modules: AgentModules, top_k: int, batch_denom: int,
                    fast: Union[bool, str] = "auto", *, seed: int = 0,
                    uniforms: Optional[UniformSource] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    mesh=None, tp=None, graph: Optional[bool] = None):
    """Build ``step(opt_states, data, target, desc, step,
    desc_set_padded=None, desc_set_mask=None, data_context=None) ->
    TrainMetrics`` (train.py:216-248), which updates ``modules`` and
    ``opt_states`` in place. ``step`` is the global step index that keys
    the randomness.

    ``fast``: False runs the plain exchange with gradients through every
    turn; True or "auto" the sample-then-recompute path
    (game/fast_train.py); "kernel" that path with phase A in the
    train-mode CUDA kernel (for CUDA tensors; its plain version for CPU
    ones). ``device`` defaults to ``cuda``; the modules are moved there.
    Make the optimizer states (:func:`init_opt_states`) after this call.
    With ``mesh`` (``parallel/mesh.py``) the step takes the whole batch
    and trains on this rank's rows, on the mesh's device. With ``tp``
    (``parallel/tensor.py``, ``mesh`` its data axis) it trains the rank's
    shards; ``opt_states`` are then ``init_tp_opt_states``'.

    The step is the trainer's one body (:class:`_StepGraph`): the batch
    (this rank's rows of it) is copied into its buffers and the metrics
    out of them. ``graph`` (default :func:`step_route`: a CUDA device
    whose collectives, if any, are NCCL's) captures it, so that each step
    is a replay of one CUDA graph, a mesh's collectives and the full
    metrics' gathers inside it; a captured step reads the descriptions
    where they lie: give the same device tensors every step.
    """
    tr = _Trainer(modules, top_k, batch_denom, fast, seed, uniforms, device,
                  mesh, tp, graph)

    def step(opt_states, data, target, desc, step: int,
             desc_set_padded=None, desc_set_mask=None, data_context=None
             ) -> TrainMetrics:
        return _run_staged(
            tr, opt_states, tr.tensor(data)[None],
            tr.tensor(target, torch.long)[None], desc, step,
            None if data_context is None else tr.tensor(data_context)[None],
            desc_set_padded, desc_set_mask, full=True)

    return step


def gather_batch(feats, idx, feats_context=None, transform=None,
                 context_fn=None):
    """The batch ``feats[idx]`` (through ``transform`` when given) and its
    context: ``feats_context[idx]``, else ``context_fn`` of the batch."""
    data = feats[idx]
    if transform is not None:
        data = transform(data)
    if feats_context is not None:
        return data, feats_context[idx]
    return data, None if context_fn is None else context_fn(data)


def make_indexed_train_steps(modules: AgentModules, top_k: int,
                             batch_denom: int,
                             fast: Union[bool, str] = "auto", *,
                             seed: int = 0,
                             uniforms: Optional[UniformSource] = None,
                             device: Optional[Union[str,
                                                    torch.device]] = None,
                             transform: Optional[Callable] = None,
                             context_fn: Optional[Callable] = None,
                             mesh=None, tp=None,
                             graph: Optional[bool] = None):
    """``(step, chunk)``: :func:`make_train_step_indexed`'s step and
    :func:`make_multistep_train_step_indexed`'s chunk over one trainer,
    so that they share the flat carry's layout and one table of step
    bodies (one for the full step, one for the chunk), as the driver
    (``game/driver.py:run_fast``) takes both from one call."""
    tr = _Trainer(modules, top_k, batch_denom, fast, seed, uniforms, device,
                  mesh, tp, graph)
    make_batch = _indexed_batch(transform, context_fn)

    def run(opt_states, feats, targets, plan, desc, step0, feats_context,
            desc_set_padded, desc_set_mask, full):
        return tr.run_graph(
            opt_states, "indexed", plan.shape[0], step0, {"idx": plan},
            dict(feats=feats, targets=targets, feats_context=feats_context,
                 desc=desc, desc_set_padded=desc_set_padded,
                 desc_set_mask=desc_set_mask),
            make_batch, full)

    def step(opt_states, feats, targets, idx, desc, step0: int,
             feats_context=None, desc_set_padded=None, desc_set_mask=None
             ) -> TrainMetrics:
        return run(opt_states, feats, targets, _plan(idx)[None], desc, step0,
                   feats_context, desc_set_padded, desc_set_mask, full=True)

    def chunk(opt_states, feats, targets, idx, desc, step0: int = 0,
              feats_context=None, desc_set_padded=None, desc_set_mask=None
              ) -> ScanMetrics:
        return run(opt_states, feats, targets, _plan(idx), desc, step0,
                   feats_context, desc_set_padded, desc_set_mask,
                   full=False)

    return step, chunk


def make_train_step_indexed(modules: AgentModules, top_k: int,
                            batch_denom: int,
                            fast: Union[bool, str] = "auto", *,
                            seed: int = 0,
                            uniforms: Optional[UniformSource] = None,
                            device: Optional[Union[str,
                                                   torch.device]] = None,
                            transform: Optional[Callable] = None,
                            context_fn: Optional[Callable] = None,
                            mesh=None, tp=None,
                            graph: Optional[bool] = None):
    """Build ``step(opt_states, feats, targets, idx, desc, step0,
    feats_context=None, desc_set_padded=None, desc_set_mask=None) ->
    TrainMetrics`` over a dataset already on the device
    (data/device_dataset.py): the batch is ``feats[idx]``, its context
    ``feats_context[idx]`` (train.py:412-467). Randomness is keyed by
    ``step0`` as in :func:`make_multistep_train_step_indexed`, so a step
    run alone equals the same step inside a chunk.

    ``transform`` maps the gathered batch before the step (the CIFAR
    pixels' normalization, on the device); ``context_fn`` derives the
    attention context from the transformed batch where no
    ``feats_context`` is staged (JAX train.py:432-437). With ``mesh``
    the step trains on this rank's share of ``idx`` and returns the
    whole batch's metrics; ``tp`` and ``graph`` are
    :func:`make_train_step`'s (the set and the descriptions are read where
    they lie)."""
    return make_indexed_train_steps(
        modules, top_k, batch_denom, fast, seed=seed, uniforms=uniforms,
        device=device, transform=transform, context_fn=context_fn,
        mesh=mesh, tp=tp, graph=graph)[0]


def _scan_row(m: TrainMetrics) -> Tuple[torch.Tensor, ...]:
    """A step's :class:`ScanMetrics` scalars (the rest of its metrics,
    the conversation record with them, is let go)."""
    return tuple(getattr(m, f) for f in ScanMetrics._fields)


def make_multistep_train_step(modules: AgentModules, top_k: int,
                              batch_denom: int,
                              fast: Union[bool, str] = "auto", *,
                              seed: int = 0,
                              uniforms: Optional[UniformSource] = None,
                              device: Optional[Union[str,
                                                     torch.device]] = None,
                              mesh=None, tp=None,
                              graph: Optional[bool] = None):
    """Build ``chunk(opt_states, data (K, B, ...), target (K, B), desc,
    step0=0, data_context=None (K, B, C), desc_set_padded=None,
    desc_set_mask=None) -> ScanMetrics``: K training steps over batches
    staged as stacks (train.py:352-409), step ``i`` on ``data[i]`` with
    the randomness of global step ``step0 + i`` (Philox ``(seed, step,
    row_base)`` or the ``uniforms`` seam, as in
    :func:`make_multistep_train_step_indexed`, the counterpart of JAX's
    ``keys (K,)``). The metrics stay on the device. With ``mesh`` each
    step trains on this rank's rows of ``data[i]``; ``fast``, ``device``,
    ``tp`` and ``graph`` are :func:`make_train_step`'s: the stacks are
    copied into the body's buffers once a chunk, and captured, each step
    is one replay."""
    tr = _Trainer(modules, top_k, batch_denom, fast, seed, uniforms, device,
                  mesh, tp, graph)

    def chunk(opt_states, data, target, desc, step0: int = 0,
              data_context=None, desc_set_padded=None, desc_set_mask=None
              ) -> ScanMetrics:
        return _run_staged(
            tr, opt_states, tr.tensor(data), tr.tensor(target, torch.long),
            desc, step0,
            None if data_context is None else tr.tensor(data_context),
            desc_set_padded, desc_set_mask, full=False)

    return chunk


def make_multistep_train_step_indexed(modules: AgentModules, top_k: int,
                                      batch_denom: int,
                                      fast: Union[bool, str] = "auto", *,
                                      seed: int = 0,
                                      uniforms: Optional[UniformSource] = None,
                                      device: Optional[Union[
                                          str, torch.device]] = None,
                                      transform: Optional[Callable] = None,
                                      context_fn: Optional[Callable] = None,
                                      mesh=None, tp=None,
                                      graph: Optional[bool] = None):
    """Build ``chunk(opt_states, feats, targets, idx (K, B), desc,
    step0=0, feats_context=None, desc_set_padded=None, desc_set_mask=None)
    -> ScanMetrics``: K training steps over a dataset already on the
    device, step ``i`` on batch ``feats[idx[i]]`` (and context
    ``feats_context[idx[i]]``) with the randomness of global step
    ``step0 + i`` (train.py:470-542). The metrics stay on
    the device until the caller reads them. ``transform`` and
    ``context_fn`` are :func:`make_train_step_indexed`'s. With ``mesh``
    each step trains on this rank's share of its row of ``idx``; the
    metrics are the whole batch's. ``tp`` and ``graph`` are
    :func:`make_train_step`'s: a chunk's plan (from the host) and key
    reach the device in one copy, captured each step is one replay, and
    the metrics are copied out once a chunk."""
    return make_indexed_train_steps(
        modules, top_k, batch_denom, fast, seed=seed, uniforms=uniforms,
        device=device, transform=transform, context_fn=context_fn,
        mesh=mesh, tp=tp, graph=graph)[1]


# ----------------------------------------------------------------- serving

def answer_scores(cfg: GameConfig, ex: ExchangeOutputs) -> torch.Tensor:
    """The eval conversation's answer: the log-softmax of the class scores
    that the stop masks select (the last turn's in a fixed exchange),
    ``(B, D)``, as serving reads it (JAX serve.py:91-97)."""
    y_masks = (None if cfg.fixed_exchange
               else assemble_loss_masks(ex.stop_masks).y)
    outp, _ = get_rec_outp(ex.y, y_masks)
    return torch.log_softmax(outp, dim=-1)


def _kernel_exchange(cfg: GameConfig, params: Dict[str, torch.Tensor],
                     data: torch.Tensor, desc: torch.Tensor,
                     corrupt_mask: Optional[torch.Tensor]
                     ) -> ExchangeOutputs:
    """The eval conversation through :func:`fused_eval_exchange`, as the
    record :func:`exchange` returns."""
    f = fused_eval_exchange(cfg, params, data, desc,
                            corrupt_mask=corrupt_mask)
    stop_masks, n_steps = finalize_stop_masks(f.masks, cfg.fixed_exchange)
    zeros = torch.zeros((cfg.max_exchange, data.shape[0], 1),
                        dtype=torch.float32, device=data.device)
    return ExchangeOutputs(
        stop_masks=stop_masks, stop_feats=f.stop_feats,
        stop_probs=f.stop_probs, sen_feats=f.sen_feats,
        sen_probs=f.sen_probs, rec_feats=f.rec_feats,
        rec_probs=f.rec_probs, y=f.y, bs=zeros, br=zeros,
        n_steps=n_steps, attn_scores=None)


def _kernel_conversation(modules: AgentModules, data: torch.Tensor,
                         desc: torch.Tensor,
                         corrupt_mask: Optional[torch.Tensor], **_
                         ) -> ExchangeOutputs:
    """The kernel route's conversation: the weights packed from the
    parameters as they are (:func:`kernel_params`), then
    :func:`_kernel_exchange`. The attention inputs and uniforms, which no
    config the kernel takes reads, are ignored."""
    return _kernel_exchange(modules.cfg, kernel_params(modules), data, desc,
                            corrupt_mask)


class _EvalGraph:
    """The eval conversation of one call shape: a static buffer for each
    tensor the call gives (the data, maps under visual attention; the
    descriptions; the corrupt mask; the ``fc`` context; the word sets; the
    eval uniforms ``fz``/``fw`` that ``flipout_dev`` consumes) and a body
    that runs ``conversation`` on them, chosen when the graph is built
    (:func:`_kernel_conversation` or :func:`exchange`), and computes the
    answer (:func:`answer_scores`). With ``capture`` it runs eagerly
    once, then as a captured CUDA graph (:class:`Captured`) that reads the
    parameters where they lie at every replay; else the body runs on
    every call. Its float outputs, ``attn_scores`` included, come back as
    one buffer (copied out of a replay), cut into the record's fields; a
    field that is another's tensor (the kernel route's ``br``, its
    ``bs``) is packed once and comes back as the same view."""

    def __init__(self, modules: AgentModules, conversation: Callable,
                 inputs: Dict[str, Optional[torch.Tensor]],
                 uniforms: Dict[str, torch.Tensor], capture: bool):
        dev = inputs["data"].device
        self.cfg, self.modules = modules.cfg, modules
        self.conversation = conversation
        with torch.inference_mode(False):
            self.inputs = {k: None if v is None else torch.empty(
                v.shape, dtype=v.dtype, device=dev)
                for k, v in inputs.items()}
            self.u = {k: torch.empty_like(v) for k, v in uniforms.items()}
        # (name, name of the field packed for it, shape) of each output,
        # in order; the body sets it.
        self.fields: List[Tuple[str, str, torch.Size]] = []
        self.run = Captured(self._body, dev, warmup=1, capture=capture)

    @torch.no_grad()
    def _body(self):
        ex = self.conversation(self.modules, **self.inputs, uniforms=self.u)
        out = {k: v for k, v in ex._asdict().items()
               if k != "n_steps" and v is not None}
        out["answer"] = answer_scores(self.cfg, ex)
        first: Dict[int, str] = {}
        self.fields = [(k, first.setdefault(id(v), k), v.shape)
                       for k, v in out.items()]
        packed = [v.reshape(-1) for k, v in out.items() if first[id(v)] == k]
        return torch.cat(packed), ex.n_steps

    def __call__(self, inputs, uniforms
                 ) -> Tuple[ExchangeOutputs, torch.Tensor]:
        for k, v in inputs.items():
            if v is not None:
                self.inputs[k].copy_(v)
        for k, v in uniforms.items():
            self.u[k].copy_(v)
        (flat, n_steps), replayed = self.run()
        if replayed:
            flat, n_steps = flat.clone(), n_steps.clone()
        parts = iter(torch.split(flat, [s.numel() for k, src, s in
                                        self.fields if src == k]))
        out = {}
        for k, src, s in self.fields:
            out[k] = next(parts).view(s) if src == k else out[src]
        dist = out.pop("answer")
        ex = ExchangeOutputs(**{f: out.get(f) for f in ExchangeOutputs._fields
                                if f != "n_steps"}, n_steps=n_steps)
        return ex, dist


def make_eval_exchange(modules: AgentModules, use_kernel: bool = True,
                       graph: Optional[bool] = None
                       ) -> Callable[..., ExchangeOutputs]:
    """Build ``run(data, desc, corrupt_mask=None, *, data_context=None,
    desc_set_padded=None, desc_set_mask=None, uniforms=None,
    answer=False) -> ExchangeOutputs``, the eval conversation (rounded
    messages, cumulative stop product — model.py:640, 1463-1465); with
    ``answer`` ``(record, answer_scores)``.

    With ``use_kernel`` a call that :func:`eval_kernel_supports` accepts
    (a config the kernel supports, at a batch and class count that a
    launch plan fits; asked on every call, since the batch varies) goes
    through :func:`fused_eval_exchange`: the CUDA kernel for CUDA tensors,
    its plain version for CPU ones, on the weights packed from the
    parameters at every call. The calls the kernel refuses (attention,
    ``mou``, ``flipout_dev`` with flipout, sizes that no launch plan fits)
    run the plain :func:`exchange`, with the attention inputs and, under
    ``flipout_dev``, the ``fz``/``fw`` uniforms
    (``ops/philox.py:philox_eval_uniforms``; other keys of the dict are
    not read).

    Either conversation and its answer run as one :class:`_EvalGraph` a
    call shape (the route and the shapes of the data, the descriptions,
    the mask, the context, the word sets and the uniforms), built again
    when a parameter is replaced (its ``data_ptr`` changes). On CUDA
    tensors (``graph`` None or True) it is captured, as the JAX package
    runs one compiled program per call (game/train.py:545-580), and the
    record comes back copied out of the graph; on the CPU, or with
    ``graph=False``, its body runs as it is.

    ``run.routes`` counts the calls: ``kernel_graph`` and ``plain_graph``
    captured, ``eager`` (either conversation) not.
    """
    cfg = modules.cfg
    graphs: Dict[tuple, Tuple[tuple, _EvalGraph]] = {}
    routes = {"kernel_graph": 0, "plain_graph": 0, "eager": 0}

    def run(data: torch.Tensor, desc: torch.Tensor,
            corrupt_mask: Optional[torch.Tensor] = None, *,
            data_context: Optional[torch.Tensor] = None,
            desc_set_padded: Optional[torch.Tensor] = None,
            desc_set_mask: Optional[torch.Tensor] = None,
            uniforms: Optional[Dict[str, torch.Tensor]] = None,
            answer: bool = False):
        capture = data.device.type == "cuda" and graph is not False
        kernel = use_kernel and eval_kernel_supports(cfg, data.shape[0],
                                                     desc.shape[0])
        inputs = {"data": data, "desc": desc, "corrupt_mask": corrupt_mask,
                  "data_context": data_context,
                  "desc_set_padded": desc_set_padded,
                  "desc_set_mask": desc_set_mask}
        u = {k: uniforms[k] for k in needed_uniforms(cfg, False, uniforms)}
        shape = (kernel,) + tuple(
            (k, None if v is None else (v.shape, v.dtype))
            for k, v in {**inputs, **u}.items())
        ptrs = tuple(p.data_ptr() for p in modules.parameters())
        known = graphs.get(shape)
        if known is None or known[0] != ptrs:
            known = graphs[shape] = (ptrs, _EvalGraph(
                modules, _kernel_conversation if kernel else exchange,
                inputs, u, capture))
        if not capture:
            routes["eager"] += 1
        elif kernel:
            routes["kernel_graph"] += 1
        else:
            routes["plain_graph"] += 1
        ex, dist = known[1](inputs, u)
        return (ex, dist) if answer else ex

    run.routes = routes
    return run
