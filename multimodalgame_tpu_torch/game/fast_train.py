"""Fast training path: sequential sampling, batched differentiation.

Port of ``multimodalgame_tpu/game/fast_train.py``. Every tensor that
crosses between the agents is a detached sample, so the only dependency
through time that the backward pass needs is the Receiver's GRU chain:

1. **Phase A (sample)** runs the conversation under ``torch.no_grad``:
   with ``sampler="kernel"`` as one launch of the train-mode CUDA kernel
   (``ops/cuda_exchange.py:fused_train_forward``), else through the plain
   ``exchange(train=True, score_baselines=False)``. It keeps the sampled
   bits ``z``, ``w``, ``s`` and the stop-mask chain.
2. **Phase B (recompute)** rebuilds every loss-bearing quantity from
   those bits with autograd on: the sender's logits for all T turns in
   one batch (under visual attention each turn's ``h_x`` too, which the
   Sender baseline reads), a GRU-only loop for the hidden chain, the heads
   and both baselines batched over T. It is plain PyTorch.

Configs the kernel does not cover (``supports_config``: attention, ``mou``,
``flipout_dev`` with flipout) sample on the plain exchange, as the JAX
package's phase A does (fast_train.py:96-106), and so do bfloat16 games:
the kernel samples in float32 only (fast_train.py:87-89). Under
``compute_dtype="bfloat16"`` both phases run on bfloat16 copies of the
parameters, and the record is cast back to float32 for the losses.

The losses see the same values as the scan path's: the recomputed
probabilities are the same functions of the same inputs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.exchange import (ExchangeOutputs,
                                                    exchange,
                                                    finalize_stop_masks)
from multimodalgame_tpu_torch.game.train import (TrainMetrics,
                                                 in_compute_dtype,
                                                 losses_from_exchange)
from multimodalgame_tpu_torch.ops.cuda_exchange import (fused_train_forward,
                                                        kernel_params)
from multimodalgame_tpu_torch.ops.philox import philox_uniforms

SAMPLERS = ("plain", "kernel")


class Sampled(NamedTuple):
    """Phase A's record: the sampled bits and the stop-mask chain."""
    z_bits: torch.Tensor       # (T, B, sender_out_dim)
    w_bits: torch.Tensor       # (T, B, rec_w_dim)
    s_bits: torch.Tensor       # (T, B, 1)
    stop_masks: torch.Tensor   # (T+1, B, 1)
    n_steps: torch.Tensor      # () int32


@torch.no_grad()
def sample_conversation(modules: AgentModules, data: torch.Tensor,
                        desc: torch.Tensor, sampler: str = "plain",
                        uniforms: Optional[Dict[str, torch.Tensor]] = None,
                        seed: Optional[int] = None,
                        step: Optional[int] = None, row_base: int = 0,
                        key: Optional[torch.Tensor] = None,
                        **inputs) -> Sampled:
    """Phase A: ``(z_bits, w_bits, s_bits, stop_masks, n_steps)``.

    The kernel sampler takes ``uniforms``, ``(seed, step)`` or ``key``,
    the Philox key as an int64 tensor ``[seed, step, row_base]`` on the
    data's device (a captured step's, which the step advances on the
    device), with ``row_base`` the global row of ``data``'s first row
    under Philox (a data-parallel shard); the plain sampler takes
    ``uniforms`` or ``key`` (it draws the kernel's numbers from it,
    ``ops/philox.py``) and the attention ``inputs``
    (``data_context``, ``desc_set_padded``, ``desc_set_mask``). The
    kernel-layout weights are packed from the modules on every call, so a
    step always samples with the weights that the previous update left."""
    cfg = modules.cfg
    if sampler == "kernel":
        f = fused_train_forward(cfg, kernel_params(modules), data, desc,
                                uniforms=uniforms, seed=seed, step=step,
                                row_base=row_base, key=key)
        stop_masks, n_steps = finalize_stop_masks(f.masks,
                                                  cfg.fixed_exchange)
        return Sampled(f.sen_feats, f.rec_feats, f.stop_feats, stop_masks,
                       n_steps)
    if sampler != "plain":
        raise ValueError(f"sampler must be one of {SAMPLERS}")
    if uniforms is None and key is not None:
        uniforms = philox_uniforms(cfg, data.shape[0], key[0], key[1],
                                   data.device, row_base=key[2])
    ex = exchange(modules, data, desc, train=True, uniforms=uniforms,
                  score_baselines=False, **inputs)
    return Sampled(ex.sen_feats, ex.rec_feats, ex.stop_feats, ex.stop_masks,
                   ex.n_steps)


def compute_losses_fast(modules: AgentModules, data: torch.Tensor,
                        target: torch.Tensor, desc: torch.Tensor,
                        top_k: int, batch_denom: int,
                        sampler: str = "plain",
                        uniforms: Optional[Dict[str, torch.Tensor]] = None,
                        seed: Optional[int] = None,
                        step: Optional[int] = None,
                        data_context: Optional[torch.Tensor] = None,
                        desc_set_padded: Optional[torch.Tensor] = None,
                        desc_set_mask: Optional[torch.Tensor] = None,
                        row_base: int = 0, reduce=None,
                        sample_modules: Optional[AgentModules] = None,
                        key: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, TrainMetrics]:
    """The summed loss and the metrics of one training step, by the
    sample-then-recompute path (fast_train.py:73-172). Under
    ``compute_dtype="bfloat16"`` both phases run in bfloat16 and the loss
    algebra in float32 (``game/train.py:in_compute_dtype``); the kernel
    sampler is float32-only and refuses it. On a data-parallel mesh the
    rows are a shard whose first row is global row ``row_base`` and
    ``reduce`` makes the losses' batch statistics global
    (``game/losses.py``). ``sample_modules`` runs phase A in place of
    ``modules`` (tensor parallelism: the whole agents sample, the shards
    recompute). ``key`` is :func:`sample_conversation`'s."""
    cfg = modules.cfg
    if cfg.compute_dtype == "bfloat16" and sampler == "kernel":
        raise ValueError("the kernel sampler is float32-only; use the "
                         "plain sampler with bfloat16")
    inputs = dict(data_context=data_context, desc_set_padded=desc_set_padded,
                  desc_set_mask=desc_set_mask)
    sampled = None
    if sample_modules is not None:
        sampled = in_compute_dtype(sample_modules, sample_conversation, data,
                                   desc, sampler=sampler, uniforms=uniforms,
                                   seed=seed, step=step, row_base=row_base,
                                   key=key, **inputs)
    ex = in_compute_dtype(modules, fast_exchange, data, desc,
                          sampler=sampler, uniforms=uniforms, seed=seed,
                          step=step, row_base=row_base, sampled=sampled,
                          key=key, **inputs)
    return losses_from_exchange(cfg, ex, target, top_k, batch_denom, reduce)


def fast_exchange(modules: AgentModules, data: torch.Tensor,
                  desc: torch.Tensor, sampler: str = "plain",
                  uniforms: Optional[Dict[str, torch.Tensor]] = None,
                  seed: Optional[int] = None, step: Optional[int] = None,
                  data_context: Optional[torch.Tensor] = None,
                  desc_set_padded: Optional[torch.Tensor] = None,
                  desc_set_mask: Optional[torch.Tensor] = None,
                  row_base: int = 0, sampled: Optional[Sampled] = None,
                  key: Optional[torch.Tensor] = None
                  ) -> ExchangeOutputs:
    """Phases A and B: the differentiable conversation record that the
    losses read, in the dtype of ``data`` and the parameters. A phase A
    already run elsewhere comes in as ``sampled``; ``key`` is
    :func:`sample_conversation`'s."""
    cfg = modules.cfg
    T = cfg.max_exchange
    batch = data.shape[0]
    descs = dict(desc_set_padded=desc_set_padded,
                 desc_set_mask=desc_set_mask)
    if sampled is None:
        sampled = sample_conversation(modules, data, desc, sampler, uniforms,
                                      seed, step, row_base, key,
                                      data_context=data_context, **descs)
    z_bits, w_bits, s_bits, stop_masks = (
        x.to(data.dtype) for x in sampled[:4])
    n_steps = sampled.n_steps

    # The query each sender turn saw (model.py:786-787, 803).
    w_prev = torch.cat(
        [torch.full((1, batch, cfg.rec_w_dim), cfg.first_rec,
                    dtype=w_bits.dtype, device=w_bits.device),
         w_bits[:-1]], dim=0)

    sender, receiver = modules.sender, modules.receiver
    sen_cache = sender.precompute(data, data_context)
    rec_cache = receiver.precompute(desc, **descs)

    # Sender turns, batched over T, with each turn's h_x.
    z_logits, h_x, attn = sender.step_all(w_prev, sen_cache)
    z_probs = (torch.sigmoid(z_logits) if cfg.use_binary
               else torch.zeros_like(z_logits))

    # GRU-only hidden chain over the recorded messages.
    h = torch.zeros((batch, cfg.rec_hidden), dtype=data.dtype,
                    device=data.device)
    hs = []
    for t in range(T):
        h = receiver.rnn(z_bits[t], h)
        hs.append(h)
    h_stack = torch.stack(hs)                                 # (T, B, R)

    # Every head batched over T.
    s_logits, y, w_logits = receiver.heads(
        h_stack.reshape(T * batch, -1), rec_cache)
    s_probs = torch.sigmoid(s_logits).reshape(T, batch, -1)
    y = y.reshape(T, batch, -1)
    w_probs = (torch.sigmoid(w_logits).reshape(T, batch, -1)
               if cfg.use_binary else torch.zeros_like(w_bits))

    # Baselines batched over T, on detached inputs (model.py:831-843).
    bs = modules.baseline_sen(h_x.detach(), w_prev, None)
    br = modules.baseline_rec(None, z_bits, h_stack.detach())

    return ExchangeOutputs(
        stop_masks=stop_masks, stop_feats=s_bits, stop_probs=s_probs,
        sen_feats=z_bits, sen_probs=z_probs, rec_feats=w_bits,
        rec_probs=w_probs, y=y, bs=bs, br=br, n_steps=n_steps,
        attn_scores=attn)
