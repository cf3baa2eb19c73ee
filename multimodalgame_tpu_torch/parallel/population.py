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

On a data-parallel mesh the member axis is split over the ranks, JAX's
``shard_population`` / ``shard_population_keys`` (population.py:211-236):
rank ``r`` of ``W`` holds members ``[r·N/W, (r+1)·N/W)`` (:func:`member_block`),
initialized as those members (``init_population(..., first=lo)``) and
drawing their uniforms (``member_base``). Members are independent, so a
step needs no collective.

Not ported: JAX's ``flat=True`` carry (no entry point reaches it, and JAX
measured it slower than the stacked carry).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.exchange import exchange
from multimodalgame_tpu_torch.game.losses import get_rec_outp
from multimodalgame_tpu_torch.game.masks import assemble_loss_masks
from multimodalgame_tpu_torch.game.train import (ScanMetrics, gather_batch,
                                                 optimizer_update,
                                                 zero_slots)
from multimodalgame_tpu_torch.ops.philox import member_uniforms
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


def make_population_train_step(modules: AgentModules, top_k: int,
                               batch_denom: int, *, seed: int = 0,
                               uniforms: Optional[Callable] = None,
                               transform: Optional[Callable] = None,
                               context_fn: Optional[Callable] = None,
                               member_base: int = 0):
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
    ``context_fn`` are ``make_train_step_indexed``'s. The inputs are not
    changed: new parameter and slot tensors are returned."""
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

    def update(pop_params, pop_opts, grads, scale):
        params, opts = dict(pop_params), dict(pop_opts)
        for agent in update_names:
            names = _agent_names(pop_params, agent)
            ups, opts[agent] = optimizer_update(
                cfg, [grads[k] for k in names], pop_opts[agent],
                batch_dims=1)
            for k, u in zip(names, ups):
                s = scale.reshape((-1,) + (1,) * (u.dim() - 1))
                params[k] = pop_params[k] + (-lr * u) * s
        return params, opts

    def chunk(pop_params: PopParams, pop_opts: PopOpts, feats, targets, idx,
              desc, step0: int = 0, lr_scale=None, feats_context=None,
              desc_set_padded=None, desc_set_mask=None):
        first = next(iter(pop_params.values()))
        n, dev = first.shape[0], first.device
        scale = (torch.ones((n,), dtype=first.dtype, device=dev)
                 if lr_scale is None else torch.as_tensor(
                     lr_scale, dtype=first.dtype, device=dev))
        idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
        rows = []
        for i in range(idx.shape[0]):
            step = int(step0) + i
            data, ctx = gather_batch(feats, idx[i], feats_context,
                                     transform, context_fn)
            target = targets[idx[i]].long()
            u = (uniforms(step) if uniforms is not None
                 else member_uniforms(cfg, data.shape[0], seed, step, n,
                                      dev, member_base=member_base))
            u = {k: v.to(dev) for k, v in u.items()}
            grads, metrics = member_grads(
                {k: v.detach() for k, v in pop_params.items()}, data,
                target, desc, u, ctx, desc_set_padded, desc_set_mask)
            with torch.no_grad():
                pop_params, pop_opts = update(pop_params, pop_opts, grads,
                                              scale)
            rows.append(metrics)
        return pop_params, pop_opts, ScanMetrics(
            *(torch.stack(v) for v in zip(*rows)))

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


def make_population_eval(modules: AgentModules, top_k: int):
    """Build ``batch_correct(pop_params, data, target, desc, uniforms=None,
    data_context=None, desc_set_padded=None, desc_set_mask=None) -> (N,)``:
    each member's top-k hits on one batch through the plain eval
    conversation (population.py:238-275). ``uniforms`` are the members'
    ``(N, T, B, dim)`` ``fz``/``fw`` under ``flipout_dev``, else None."""

    def correct(params, data, target, desc, u, ctx, dsp, dsm):
        return torch.func.functional_call(
            modules, params, (_member_correct, data, target, desc, u, ctx,
                              dsp, dsm, top_k))

    def batch_correct(pop_params: PopParams, data, target, desc,
                      uniforms=None, data_context=None, desc_set_padded=None,
                      desc_set_mask=None) -> torch.Tensor:
        fn = torch.func.vmap(correct, in_dims=(
            0, None, None, None, None if uniforms is None else 0, None, None,
            None))
        with torch.no_grad():
            return fn(pop_params, data, target.long(), desc, uniforms,
                      data_context, desc_set_padded, desc_set_mask)

    return batch_correct
