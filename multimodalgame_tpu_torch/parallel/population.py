"""Population training: N independent games as one batched step.

The port of ``multimodalgame_tpu/parallel/population.py``. The reference
trains one (Sender, Receiver, two Baselines) quadruple per process
(model.py:1001-1592), so a sweep over seeds or learning rates is N runs.
Here the parameters carry a leading ``(N, ...)`` member axis, and a step
of N members is one batched step: ``torch.func.vmap`` over
``torch.func.grad`` of the four agents' losses, called through
``torch.func.functional_call`` on each member's slice of the stacked
parameters, so every small product of the game becomes one N-wide
product. The clip and optimizer rule (``game/train.py:optimizer_update``)
then run once over the stacked tensors, the clip norm per member.

Members share the data stream (the same batches in the same order) and
differ in their initial weights (member ``i`` is ``init_params`` with
seed ``seed + i``), in their uniforms (Philox keyed by ``(seed, step)``
with the member in the counter, ``ops/philox.py:member_uniforms``) and
optionally in a learning-rate scale that multiplies the member's updates
after the optimizer (the learning rate enters SGD, Adam and RMSprop as a
final linear scale, so this is the member's own learning rate).

Phase A is the plain exchange under ``vmap``, as in the JAX package
(population.py:96, ``fast="auto"`` with the scan sampler): the train
kernel is a ctypes call, which ``vmap`` cannot batch, and the JAX
package has no kernel with a member axis.

On a CUDA device (:func:`population_route`) each step is one replay of
a captured CUDA graph, as JAX compiles a chunk of K steps into one
program (population.py:116-144, ``jax.jit(donate_argnums=(0, 1))`` of a
``lax.scan``): the graph owns the stacked parameters and slots and
writes them in place, its counter keys the members' uniforms on the
device, and a chunk's index plan reaches the card in one copy
(:class:`_PopulationGraph`). Each dev batch of every member is one more
replay (:class:`_PopulationEvalGraph`, JAX's jitted ``batch_correct``).

On a data-parallel mesh the member axis is split over the ranks, JAX's
``shard_population`` / ``shard_population_keys`` (population.py:211-236):
rank ``r`` of ``W`` holds members ``[r·N/W, (r+1)·N/W)`` (:func:`member_block`),
initialized as those members (``init_population(..., first=lo)``) and
drawing their uniforms (``member_base``). Members are independent, so a
step needs no collective, and each rank takes the graph route.

Not ported: JAX's ``flat=True`` carry (no entry point reaches it, and JAX
measured it slower than the stacked carry).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.exchange import exchange
from multimodalgame_tpu_torch.game.losses import get_rec_outp
from multimodalgame_tpu_torch.game.masks import assemble_loss_masks
from multimodalgame_tpu_torch.game.train import (GRAPH_WARMUP,
                                                 INDEX_CAPACITY, ScanMetrics,
                                                 _plan, gather_batch,
                                                 optimizer_update,
                                                 zero_slots)
from multimodalgame_tpu_torch.ops.philox import member_uniforms
from multimodalgame_tpu_torch.utils.cuda_graph import Captured
from multimodalgame_tpu_torch.utils.device import resolve_device
from multimodalgame_tpu_torch.utils.torch_interop import load_torch_state

PopParams = Dict[str, torch.Tensor]   # "agent.param" -> (N, ...)
PopOpts = Dict[str, Dict[str, Any]]   # agent -> {nu, mu: [(N, ...)], count}


def stack_members(members: Sequence[AgentModules]) -> PopParams:
    """The stacked parameters of ``members`` (same config), keyed by
    :meth:`AgentModules.named_parameters` names: member ``i`` at index
    ``i`` of every tensor."""
    per = [dict(m.named_parameters()) for m in members]
    return {k: torch.stack([p[k].detach() for p in per])
            for k in per[0]}


def init_population(cfg, seed: int, n: int,
                    device: Optional[Union[str, torch.device]] = None,
                    first: int = 0) -> PopParams:
    """``n`` members' stacked parameters on ``device``, members ``first``
    to ``first + n - 1`` of the population; member ``i`` equals
    ``init_params(AgentModules(cfg), seed=seed + i)``."""
    dev = resolve_device(device)
    return stack_members([init_params(AgentModules(cfg), seed=seed + i,
                                      device=dev)
                          for i in range(first, first + n)])


def member_block(n: int, mesh) -> Tuple[int, int]:
    """The members ``[lo, hi)`` of a population of ``n`` that this rank
    of ``mesh`` holds (all of them off the mesh); the ranks must divide
    ``n``."""
    if mesh is None:
        return 0, n
    if n % mesh.size:
        raise ValueError(f"{mesh.size} ranks do not divide a population "
                         f"of {n}")
    return mesh.rows(n)


def _agent_names(pop_params: PopParams, agent: str) -> List[str]:
    return [k for k in pop_params if k.split(".", 1)[0] == agent]


def init_population_opt_states(cfg, pop_params: PopParams) -> PopOpts:
    """Per-member optimizer slots, stacked like the parameters, in each
    agent's parameter order (``game/train.py:init_opt_states``' layout)."""
    return zero_slots(cfg, {agent: [pop_params[k] for k in
                                    _agent_names(pop_params, agent)]
                            for agent in AGENT_NAMES})


def member_params(pop_params: PopParams, i: int) -> Dict[str, torch.Tensor]:
    """Member ``i``'s parameters, keyed as the stacked ones."""
    return {k: v[i] for k, v in pop_params.items()}


def member_opt_states(pop_opts: PopOpts, i: int) -> Dict[str, Dict]:
    """Member ``i``'s optimizer states in the single-game layout
    (``game/train.py:init_opt_states``), copies."""
    return {agent: {k: ([t[i].clone() for t in v] if isinstance(v, list)
                        else v) for k, v in st.items()}
            for agent, st in pop_opts.items()}


def member_modules(cfg, pop_params: PopParams, i: int,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> AgentModules:
    """A single game holding member ``i``'s weights, in the population's
    dtype, on ``device`` (the population's by default): to checkpoint the
    sweep's winner in the single-game layout."""
    first = next(iter(pop_params.values()))
    mods = AgentModules(cfg).to(first.dtype)
    state = {agent: {} for agent in AGENT_NAMES}
    for k, v in member_params(pop_params, i).items():
        agent, name = k.split(".", 1)
        state[agent][name] = v.detach().cpu()
    load_torch_state(mods, state)
    return mods.to(first.device if device is None
                   else resolve_device(device))


def _member_losses(mods, data, target, desc, uniforms, data_context,
                   desc_set_padded, desc_set_mask, top_k, batch_denom):
    from multimodalgame_tpu_torch.game.fast_train import compute_losses_fast
    total, m = compute_losses_fast(
        mods, data, target, desc, top_k, batch_denom, uniforms=uniforms,
        data_context=data_context, desc_set_padded=desc_set_padded,
        desc_set_mask=desc_set_mask)
    return total, (m.loss_rec, m.loss_sen, m.nll_loss, m.loss_bas_rec,
                   m.loss_bas_sen, m.accuracy)


def population_route(device: Union[str, torch.device]) -> str:
    """How a population takes its steps and its dev batches: ``"graph"``
    on any CUDA device, each step and each dev batch a replay of one
    captured CUDA graph (the port of the JAX package's one jitted program
    per chunk and per dev batch, population.py:116-144, 265-273);
    ``"eager"`` on the CPU. Unlike the single game's route
    (``game/train.py:step_route``) a mesh does not send it to eager: a
    member-split sweep's step runs no collective (JAX: "population
    sharding still needs zero collectives", population.py:89-92), and
    only its dev sweeps' accuracy gather and its timing gather, outside
    the step, touch the mesh. Decided from the argument alone, without a
    card."""
    return "graph" if torch.device(device).type == "cuda" else "eager"


def _opt_leaves(pop_opts: PopOpts, like: PopOpts) -> List[torch.Tensor]:
    """The tensors of ``pop_opts`` in the order of ``like``'s."""
    out = []
    for agent, st in like.items():
        for k, v in st.items():
            got = pop_opts[agent][k]
            out += list(got) if isinstance(v, list) else [got]
    return out


class _PopulationGraph:
    """One step signature of a population's training on the graph route,
    after ``game/train.py:_StepGraph``.

    Static buffers hold a chunk of up to ``capacity`` steps: one int64
    buffer with the counter ``[seed, step, member_base, i]`` (the Philox
    key of the members' uniforms and the chunk row the step trains on)
    and, behind it, the index plan, so that a chunk's plan and key reach
    the card in one copy; the ``(N,)`` learning-rate scale; a uniform
    source's numbers, staged per chunk; and the steps' scalars
    (:class:`ScanMetrics`), ``(6, capacity, N)``. The carry, the stacked
    parameters and slots with Adam's count, is the graph's own and is
    written in place (JAX's ``donate_argnums``). The body gathers row
    ``i`` of the plan, draws the members' uniforms from the counter (or
    reads the staged ones), runs ``vmap(grad)`` and the update, copies
    the update into the carry, writes row ``i`` of the scalars and
    advances the counter. :class:`Captured` runs it eagerly for the first
    GRAPH_WARMUP steps, then captures it and replays it once per
    update."""

    def __init__(self, train: Callable, make_batch: Callable, cfg,
                 seed: int, member_base: int, pop_params: PopParams,
                 pop_opts: PopOpts, batch: int, fixed: Dict[str, Any],
                 staged: Optional[Dict[str, torch.Tensor]], capacity: int,
                 capture: bool):
        first = next(iter(pop_params.values()))
        n, dev, dtype = first.shape[0], first.device, first.dtype
        self.train, self.make_batch, self.fixed = train, make_batch, fixed
        self.cfg, self.seed, self.member_base = cfg, seed, member_base
        self.capacity = capacity
        self.params = {k: torch.empty_like(v)
                       for k, v in pop_params.items()}
        self.opts = {agent: {k: ([torch.empty_like(t) for t in v]
                                 if isinstance(v, list)
                                 else torch.empty_like(v))
                             for k, v in st.items()}
                     for agent, st in pop_opts.items()}
        self.ints = torch.zeros(4 + capacity * batch, dtype=torch.int64,
                                device=dev)
        self.ctr = self.ints[:4]
        self.plan = self.ints[4:].view(capacity, batch)
        self.inc = torch.zeros(4, dtype=torch.int64, device=dev)
        self.inc[1::2] = 1                       # step and row, each + 1
        self.scale = torch.ones((n,), dtype=dtype, device=dev)
        self.scale_host = torch.ones((n,), dtype=dtype)
        self.staged = None if staged is None else {
            k: torch.empty((capacity,) + tuple(v.shape), dtype=v.dtype,
                           device=dev) for k, v in staged.items()}
        self.out = torch.zeros((len(ScanMetrics._fields), capacity, n),
                               dtype=dtype, device=dev)
        self.run = Captured(self._body, dev, GRAPH_WARMUP, capture=capture)

    def adopt(self, pop_params: PopParams, pop_opts: PopOpts) -> None:
        """Copy the caller's parameters and slots into the carry, unless
        they are the carry (a caller that passes back what a chunk
        returned); the caller's tensors are not changed."""
        mine = list(self.params.values()) + _opt_leaves(self.opts,
                                                        self.opts)
        theirs = [pop_params[k] for k in self.params] + _opt_leaves(
            pop_opts, self.opts)
        if all(a is b for a, b in zip(mine, theirs)):
            return
        with torch.no_grad():
            for a, b in zip(mine, theirs):
                a.copy_(b)

    def load(self, step0: int, plan, lr_scale,
             drawn: Optional[List[Dict[str, torch.Tensor]]]) -> None:
        """The chunk's inputs into the static buffers: the counter to
        ``(seed, step0, member_base, 0)`` and a host plan behind it in one
        copy (a device plan in one device copy), the scale where it
        changed, and a uniform source's numbers."""
        head = np.array([self.seed, step0, self.member_base, 0], np.int64)
        host = isinstance(plan, np.ndarray)
        src = torch.from_numpy(np.concatenate(
            [head, plan.reshape(-1)]) if host else head)
        if self.ints.device.type == "cuda":
            src = src.pin_memory()
        self.ints[:src.numel()].copy_(src, non_blocking=True)
        if not host:
            self.plan[:plan.shape[0]].copy_(plan)
        scale = (torch.ones_like(self.scale_host) if lr_scale is None
                 else torch.as_tensor(lr_scale,
                                      dtype=self.scale_host.dtype).cpu())
        if not torch.equal(scale, self.scale_host):
            self.scale.copy_(scale)
            self.scale_host = scale
        if drawn is not None:
            for k, buf in self.staged.items():
                buf[:len(drawn)].copy_(torch.stack([u[k] for u in drawn]))

    def _body(self) -> None:
        pos = self.ctr[3:4]
        data, target, desc, ctx, dsp, dsm = self.make_batch(
            self.plan.index_select(0, pos)[0], self.fixed)
        n = self.scale.shape[0]
        u = ({k: b.index_select(0, pos)[0] for k, b in self.staged.items()}
             if self.staged is not None else member_uniforms(
                 self.cfg, data.shape[0], self.ctr[0], self.ctr[1], n,
                 data.device, member_base=self.member_base))
        params, opts, metrics = self.train(self.params, self.opts, data,
                                           target, desc, u, ctx, dsp, dsm,
                                           self.scale)
        with torch.no_grad():
            for k, v in params.items():
                if v is not self.params[k]:
                    self.params[k].copy_(v)
            for a, b in zip(_opt_leaves(self.opts, self.opts),
                            _opt_leaves(opts, self.opts)):
                if a is not b:
                    a.copy_(b)
            self.out.index_copy_(1, pos, torch.stack(metrics)[:, None])
            self.ctr.add_(self.inc)


def make_population_train_step(modules: AgentModules, top_k: int,
                               batch_denom: int, *, seed: int = 0,
                               uniforms: Optional[Callable] = None,
                               transform: Optional[Callable] = None,
                               context_fn: Optional[Callable] = None,
                               member_base: int = 0,
                               graph: Optional[bool] = None):
    """Build ``chunk(pop_params, pop_opts, feats, targets, idx (K, B),
    desc, step0=0, lr_scale=None, feats_context=None,
    desc_set_padded=None, desc_set_mask=None) -> (pop_params, pop_opts,
    ScanMetrics with (K, N) leaves)`` (population.py:61-144).

    Step ``i`` trains every member on batch ``feats[idx[i]]`` with the
    uniforms of global step ``step0 + i``: by default
    ``member_uniforms(cfg, B, seed, step0 + i, N)``; ``uniforms``, a
    function ``step -> {s, z, w[, fz, fw]}`` of ``(N, T, B, dim)``
    tensors, replaces them (the tests replay JAX's per-member keys). The
    members are those from ``member_base`` on (a rank's block of a
    sharded population): their uniforms are drawn as those members'.
    ``lr_scale`` ``(N,)`` multiplies each member's updates after the
    optimizer. ``modules`` is the structure the members share (on their
    device); its own parameters are not read. ``transform`` and
    ``context_fn`` are ``make_train_step_indexed``'s.

    ``graph`` (default: :func:`population_route` of the parameters'
    device) runs each step as a replay of a captured CUDA graph
    (:class:`_PopulationGraph`, one a step signature), bit for bit the
    eager step; ``graph=True`` on the CPU runs the body that the graph
    captures, uncaptured, on the same static buffers. On the graph the
    returned dicts are the graph's carry: a call that passes them back
    trains them in place (JAX's donation), and the next call overwrites
    them; a call on other tensors copies them into the carry first and
    leaves them as they were. The set, the descriptions and the context
    are read where they lie: give the same tensors every chunk. Off the
    graph new parameter and slot tensors are returned and the inputs are
    not changed."""
    cfg = modules.cfg
    lr = cfg.learning_rate
    update_names = AGENT_NAMES if cfg.use_binary else ("receiver",)

    def loss(params, data, target, desc, u, ctx, dsp, dsm):
        return torch.func.functional_call(
            modules, params, (_member_losses, data, target, desc, u, ctx,
                              dsp, dsm, top_k, batch_denom))

    member_grads = torch.func.vmap(
        torch.func.grad(loss, has_aux=True),
        in_dims=(0, None, None, None, 0, None, None, None))

    def train(pop_params, pop_opts, data, target, desc, u, ctx, dsp, dsm,
              scale):
        """One update of every member: new parameters and slots (the
        inputs are not changed) and the step's six scalars."""
        grads, metrics = member_grads(
            {k: v.detach() for k, v in pop_params.items()}, data, target,
            desc, u, ctx, dsp, dsm)
        params, opts = dict(pop_params), dict(pop_opts)
        with torch.no_grad():
            for agent in update_names:
                names = _agent_names(pop_params, agent)
                ups, opts[agent] = optimizer_update(
                    cfg, [grads[k] for k in names], pop_opts[agent],
                    batch_dims=1)
                for k, up in zip(names, ups):
                    s = scale.reshape((-1,) + (1,) * (up.dim() - 1))
                    params[k] = pop_params[k] + (-lr * up) * s
        return params, opts, metrics

    def make_batch(idx, fixed):
        data, ctx = gather_batch(fixed["feats"], idx, fixed["feats_context"],
                                 transform, context_fn)
        return (data, fixed["targets"][idx].long(), fixed["desc"], ctx,
                fixed["desc_set_padded"], fixed["desc_set_mask"])

    graphs: Dict[tuple, Tuple[tuple, _PopulationGraph]] = {}

    def chunk(pop_params: PopParams, pop_opts: PopOpts, feats, targets, idx,
              desc, step0: int = 0, lr_scale=None, feats_context=None,
              desc_set_padded=None, desc_set_mask=None):
        first = next(iter(pop_params.values()))
        n, dev = first.shape[0], first.device
        fixed = dict(feats=feats, targets=targets,
                     feats_context=feats_context, desc=desc,
                     desc_set_padded=desc_set_padded,
                     desc_set_mask=desc_set_mask)
        on_graph = (population_route(dev) == "graph" if graph is None
                    else bool(graph))
        if on_graph:
            return graph_chunk(pop_params, pop_opts, fixed, idx, int(step0),
                               lr_scale)
        scale = (torch.ones((n,), dtype=first.dtype, device=dev)
                 if lr_scale is None else torch.as_tensor(
                     lr_scale, dtype=first.dtype, device=dev))
        idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
        rows = []
        for i in range(idx.shape[0]):
            step = int(step0) + i
            data, target, desc, ctx, dsp, dsm = make_batch(idx[i], fixed)
            u = (uniforms(step) if uniforms is not None
                 else member_uniforms(cfg, data.shape[0], seed, step, n,
                                      dev, member_base=member_base))
            u = {k: v.to(dev) for k, v in u.items()}
            pop_params, pop_opts, metrics = train(
                pop_params, pop_opts, data, target, desc, u, ctx, dsp, dsm,
                scale)
            rows.append(metrics)
        return pop_params, pop_opts, ScanMetrics(
            *(torch.stack(v) for v in zip(*rows)))

    def graph_chunk(pop_params, pop_opts, fixed, idx, step0, lr_scale):
        first = next(iter(pop_params.values()))
        plan = _plan(idx)
        steps, batch = plan.shape
        drawn = None
        if uniforms is not None:
            drawn = [{k: v.to(first.device) for k, v in
                      uniforms(step0 + i).items()} for i in range(steps)]
        shape_key = (batch, first.shape[0], str(first.dtype), tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in
            (drawn[0] if drawn else {}).items()), tuple(
                None if v is None else (tuple(v.shape), str(v.dtype))
                for v in fixed.values()))
        ptr_key = tuple(None if v is None else v.data_ptr()
                        for v in fixed.values())
        known = graphs.get(shape_key)
        if known is None or known[0] != ptr_key \
                or steps > known[1].capacity:
            known = (ptr_key, _PopulationGraph(
                train, make_batch, cfg, seed, member_base, pop_params,
                pop_opts, batch, fixed, None if drawn is None else drawn[0],
                max(steps, INDEX_CAPACITY), first.device.type == "cuda"))
            graphs[shape_key] = known
        pg = known[1]
        pg.adopt(pop_params, pop_opts)
        pg.load(step0, plan, lr_scale, drawn)
        for _ in range(steps):
            pg.run()
        return pg.params, pg.opts, ScanMetrics(*pg.out[:, :steps].clone())

    return chunk


def _member_correct(mods, data, target, desc, uniforms, data_context,
                    desc_set_padded, desc_set_mask, top_k):
    cfg = mods.cfg
    ex = exchange(mods, data, desc, uniforms=uniforms,
                  data_context=data_context,
                  desc_set_padded=desc_set_padded,
                  desc_set_mask=desc_set_mask)
    masks = None if cfg.fixed_exchange else assemble_loss_masks(
        ex.stop_masks)
    outp, _ = get_rec_outp(ex.y, None if masks is None else masks.y)
    dist = torch.log_softmax(outp, dim=-1)
    # Rank counting with k clamped to the class count (losses.topk_accuracy).
    tscore = torch.gather(dist, -1, target.reshape(-1, 1))
    rank = (dist > tscore).sum(-1)
    return (rank < min(top_k, dist.shape[-1])).sum()


class _PopulationEvalGraph:
    """One ``(batch, N)`` dev batch of every member on the graph route:
    static buffers for the data, the targets, the context and (under
    ``flipout_dev``) the members' uniforms; the stacked parameters, the
    descriptions and the word sets are read where they lie. It runs
    eagerly once, then as a captured CUDA graph (:class:`Captured`); the
    ``(N,)`` hit counts are copied out per call."""

    def __init__(self, correct: Callable, pop_params: PopParams, data,
                 target, desc, uniforms, data_context, desc_set_padded,
                 desc_set_mask):
        self.correct, self.pop_params, self.desc = correct, pop_params, desc
        self.dsp, self.dsm = desc_set_padded, desc_set_mask
        self.data, self.target = torch.empty_like(data), torch.empty_like(
            target)
        self.u = None if uniforms is None else {
            k: torch.empty_like(v) for k, v in uniforms.items()}
        self.ctx = (None if data_context is None
                    else torch.empty_like(data_context))
        self.run = Captured(self._body, data.device, warmup=1,
                            capture=data.device.type == "cuda")

    @torch.no_grad()
    def _body(self) -> torch.Tensor:
        return self.correct(self.pop_params, self.data, self.target,
                            self.desc, self.u, self.ctx, self.dsp, self.dsm)

    def __call__(self, data, target, uniforms, data_context) -> torch.Tensor:
        self.data.copy_(data)
        self.target.copy_(target)
        if self.u is not None:
            for k, v in uniforms.items():
                self.u[k].copy_(v)
        if self.ctx is not None:
            self.ctx.copy_(data_context)
        hits, replayed = self.run()
        return hits.clone() if replayed else hits


def make_population_eval(modules: AgentModules, top_k: int,
                         graph: Optional[bool] = None):
    """Build ``batch_correct(pop_params, data, target, desc, uniforms=None,
    data_context=None, desc_set_padded=None, desc_set_mask=None) -> (N,)``:
    each member's top-k hits on one batch through the plain eval
    conversation (population.py:238-275). ``uniforms`` are the members'
    ``(N, T, B, dim)`` ``fz``/``fw`` under ``flipout_dev``, else None.

    ``graph`` (default: :func:`population_route` of the parameters'
    device) runs each ``(batch, N)`` as one captured CUDA graph
    (:class:`_PopulationEvalGraph`), bit for bit the eager batch;
    ``graph=True`` on the CPU runs its body uncaptured. The parameters,
    the descriptions and the word sets are read where they lie (a
    training graph's carry, ``make_population_train_step``)."""

    def member_correct(params, data, target, desc, u, ctx, dsp, dsm):
        return torch.func.functional_call(
            modules, params, (_member_correct, data, target, desc, u, ctx,
                              dsp, dsm, top_k))

    def correct(pop_params, data, target, desc, uniforms, ctx, dsp, dsm):
        fn = torch.func.vmap(member_correct, in_dims=(
            0, None, None, None, None if uniforms is None else 0, None, None,
            None))
        return fn(pop_params, data, target, desc, uniforms, ctx, dsp, dsm)

    graphs: Dict[tuple, Tuple[tuple, _PopulationEvalGraph]] = {}

    def batch_correct(pop_params: PopParams, data, target, desc,
                      uniforms=None, data_context=None, desc_set_padded=None,
                      desc_set_mask=None) -> torch.Tensor:
        target = target.long()
        first = next(iter(pop_params.values()))
        if not (population_route(first.device) == "graph" if graph is None
                else graph):
            with torch.no_grad():
                return correct(pop_params, data, target, desc, uniforms,
                               data_context, desc_set_padded, desc_set_mask)
        names = tuple(sorted(uniforms or ()))
        inputs = (data, desc, data_context, desc_set_padded,
                  desc_set_mask) + tuple(uniforms[k] for k in names)
        shape_key = (first.shape[0], names, tuple(
            None if v is None else (tuple(v.shape), str(v.dtype))
            for v in inputs))
        ptr_key = tuple(v.data_ptr() for v in pop_params.values()) + tuple(
            None if v is None else v.data_ptr()
            for v in (desc, desc_set_padded, desc_set_mask))
        known = graphs.get(shape_key)
        if known is None or known[0] != ptr_key:
            known = graphs[shape_key] = (ptr_key, _PopulationEvalGraph(
                correct, pop_params, data, target, desc, uniforms,
                data_context, desc_set_padded, desc_set_mask))
        return known[1](data, target, uniforms, data_context)

    return batch_correct
