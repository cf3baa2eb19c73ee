"""Philox4x32-10, the train-mode kernel's generator, in its plain torch
version (``ops/philox.py``), on the CPU.

Known answers are Random123's (kat_vectors for philox4x32_10). The layout
properties are what the trainer relies on: a row's numbers do not depend
on the batch size, and a step's numbers depend only on its global index,
so a run split into chunks takes the same trajectory. Every set (training
streams, eval slots, population members) is the generator's word at the
counter the module's docstring gives.
"""

import pathlib

import numpy as np
import pytest
import torch

from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_multistep_train_step_indexed,
    make_train_step_indexed)
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    fused_train_forward, fused_train_forward_reference, kernel_params)
from multimodalgame_tpu_torch.ops.philox import (
    EVAL_SLOT_STRIDE, MEMBER_SHIFT, STREAMS, member_uniforms,
    philox4x32_10, philox_eval_uniforms, philox_uniforms, uniforms_for)
from multimodalgame_tpu_torch.ops.sampling import uniform_widths

SMALL = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=10, rec_w_dim=10,
             rec_hidden=14, wv_dim=16, max_exchange=4, baseline_hid_dim=12,
             fixed_exchange=False, entropy_s=0.08, entropy_sen=0.01,
             entropy_rec=0.01, learning_rate=1e-3)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_known_answers(counter, key, want):
    got = philox4x32_10(counter, key)
    assert tuple(int(x) for x in got) == want


def test_kernel_source_uses_the_same_constants():
    src = (pathlib.Path(__file__).resolve().parents[1]
           / "multimodalgame_tpu_torch" / "csrc" / "fused_exchange.cu"
           ).read_text()
    for const in ("0xD2511F53u", "0xCD9E8D57u", "0x9E3779B9u",
                  "0xBB67AE85u", "1.0f / 16777216.0f"):
        assert const in src
    for name, index in STREAMS.items():
        assert f"S_{name.upper()} = {index}" in src


def test_rows_do_not_depend_on_the_batch_size():
    cfg = GameConfig(**SMALL, flipout_sen=0.1, flipout_rec=0.2)
    big = philox_uniforms(cfg, 100, seed=3, step=9)
    small = philox_uniforms(cfg, 7, seed=3, step=9)
    assert set(big) == {"s", "z", "w", "fz", "fw"}
    for k in big:
        assert small[k].shape == (4, 7, big[k].shape[-1])
        assert torch.equal(small[k], big[k][:, :7])


def test_uniforms_are_24_bit_and_look_uniform():
    u = uniforms_for(STREAMS["z"], 10, 64, 32, seed=1, step=0).numpy()
    assert u.dtype == np.float32 and u.shape == (10, 64, 32)
    assert u.min() >= 0.0 and u.max() < 1.0
    scaled = u.astype(np.float64) * 2 ** 24
    np.testing.assert_array_equal(scaled, np.round(scaled))
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.std() - 12 ** -0.5) < 0.01
    # Neighbouring columns, rows and turns are not correlated.
    flat = u.reshape(-1, 32)
    assert abs(np.corrcoef(flat[:, 0], flat[:, 1])[0, 1]) < 0.1
    assert abs(np.corrcoef(u[0].ravel(), u[1].ravel())[0, 1]) < 0.1
    # Another seed, step or stream gives other numbers.
    for other in (uniforms_for(STREAMS["z"], 10, 64, 32, seed=2, step=0),
                  uniforms_for(STREAMS["z"], 10, 64, 32, seed=1, step=1),
                  uniforms_for(STREAMS["w"], 10, 64, 32, seed=1, step=0)):
        assert (other.numpy() != u).mean() > 0.99


@pytest.mark.parametrize("kind", ["train", "eval_slot", "member",
                                  "member_eval_slot"])
def test_sets_are_the_generators_words_at_their_counters(kind):
    """Uniform ``(t, r, c)`` of stream ``k`` (of member ``m``) is word
    ``c % 4`` of ``philox4x32_10((c // 4 [+ (m + 1) << 16], r, t, k),
    (seed, step))``, shifted to 24 bits."""
    cfg = GameConfig(**SMALL, flipout_sen=0.1, flipout_rec=0.2,
                     flipout_dev=True)
    seed, step, batch, members, slot = 0xFFFFFFFF, 77, 5, 3, 2
    if kind == "train":
        sets = {k: v[None] for k, v in
                philox_uniforms(cfg, batch, seed, step).items()}
    elif kind == "eval_slot":
        sets = {k: v[None] for k, v in philox_eval_uniforms(
            cfg, batch, seed, step, slot).items()}
    else:
        sets = member_uniforms(cfg, batch, seed, step, members,
                               slot=slot if kind == "member_eval_slot"
                               else None)
    base = EVAL_SLOT_STRIDE * (1 + slot) if "eval" in kind else 0
    assert set(sets) == set(uniform_widths(cfg, train=base == 0))
    for name, u in sets.items():
        assert u.shape[1:3] == (cfg.max_exchange, batch)
        m, t, r, c = torch.meshgrid(*(torch.arange(n) for n in u.shape),
                                    indexing="ij")
        word0 = c // 4
        if kind.startswith("member"):
            word0 = word0 + ((m + 1) << MEMBER_SHIFT)
        words = torch.stack(philox4x32_10(
            (word0, r, t, base + STREAMS[name]), (seed, step)), dim=-1)
        want = torch.gather(words, -1, (c % 4)[..., None])[..., 0]
        assert torch.equal(u, (want >> 8).float() * 2.0 ** -24), name


@pytest.mark.parametrize("kw", [{}, dict(flipout_sen=0.1),
                                dict(flipout_rec=0.1), dict(use_binary=False),
                                dict(flipout_sen=0.1, flipout_dev=True)],
                         ids=["plain", "flip_sen", "flip_rec", "continuous",
                              "flip_dev"])
def test_kernel_draws_what_a_training_conversation_needs(kw):
    """Philox's sets are the training exchange's; every stream has a
    number the kernel knows."""
    cfg = GameConfig(**SMALL, **kw)
    u = philox_uniforms(cfg, 3, seed=0, step=0)
    assert set(u) == set(uniform_widths(cfg, train=True))
    assert set(u) <= set(STREAMS)
    for k, v in u.items():
        assert v.shape == (cfg.max_exchange, 3, uniform_widths(cfg, True)[k])


def _agents(seed=0, **kw):
    return init_params(AgentModules(GameConfig(**SMALL, **kw)), seed=seed)


def test_kernel_wrapper_on_cpu_draws_philox():
    """On the CPU, ``seed``/``step`` give the plain version fed
    ``philox_uniforms``; ``uniforms`` and ``seed`` together, or neither,
    raise."""
    mods = _agents(flipout_sen=0.1)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(9, 24).astype(np.float32))
    desc = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    params = kernel_params(mods)
    before = fused_train_forward.launches
    got = fused_train_forward(mods.cfg, params, data, desc, seed=5, step=2)
    want = fused_train_forward_reference(
        mods.cfg, params, data, desc, philox_uniforms(mods.cfg, 9, 5, 2))
    assert fused_train_forward.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    u = philox_uniforms(mods.cfg, 9, 5, 2)
    with pytest.raises(ValueError):
        fused_train_forward(mods.cfg, params, data, desc, uniforms=u, seed=5,
                            step=2)
    with pytest.raises(ValueError):
        fused_train_forward(mods.cfg, params, data, desc)
    with pytest.raises(ValueError):
        fused_train_forward(mods.cfg, params, data, desc, seed=-1, step=0)
    with pytest.raises(ValueError):
        fused_train_forward(mods.cfg, params, data, desc,
                            uniforms={k: v for k, v in u.items() if k != "fz"})


@pytest.mark.parametrize("fast", [True, "kernel"])
def test_chunking_does_not_change_the_trajectory(fast):
    """Two chunks of 2 steps, or 1 + 3 through the single-step trainer
    and a chunk, take the same trajectory as one chunk of 4."""
    rng = np.random.RandomState(1)
    feats = torch.from_numpy(rng.randn(30, 24).astype(np.float32))
    targets = torch.from_numpy(rng.randint(0, 5, 30))
    desc = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    idx = np.stack([rng.permutation(30)[:6] for _ in range(4)])

    def run(split):
        mods = _agents(seed=2)
        kw = dict(fast=fast, seed=11, device="cpu")
        chunk = make_multistep_train_step_indexed(mods, 2, 6, **kw)
        one = make_train_step_indexed(mods, 2, 6, **kw)
        opts = init_opt_states(mods.cfg, mods)
        losses, step0 = [], 0
        for n in split:
            if n == "one":
                losses.append(one(opts, feats, targets, idx[step0], desc,
                                  step0).loss_rec[None])
                step0 += 1
                continue
            losses.append(chunk(opts, feats, targets, idx[step0:step0 + n],
                                desc, step0).loss_rec)
            step0 += n
        return torch.cat(losses), mods.state_dict()

    want_loss, want_state = run([4])
    for split in ([2, 2], ["one", 3]):
        loss, state = run(split)
        assert torch.equal(loss, want_loss), split
        for k in want_state:
            assert torch.equal(state[k], want_state[k]), (split, k)
    # A different seed gives a different run.
    mods = _agents(seed=2)
    chunk = make_multistep_train_step_indexed(mods, 2, 6, fast=fast, seed=12,
                                              device="cpu")
    other = chunk(init_opt_states(mods.cfg, mods), feats, targets, idx,
                  desc, 0).loss_rec
    assert not torch.equal(other, want_loss)
