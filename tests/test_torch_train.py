"""The port's training path against the JAX package's, on the CPU.

One step of ``make_train_step`` for ``fast`` in {False, True, "kernel"}
against JAX's ``make_train_step`` (``fast=False`` / ``"auto"``), for the
Adaptive and Fixed presets and each optimizer, and a four-step trajectory
of ``make_multistep_train_step_indexed`` against JAX's: losses, each
agent's gradients and the parameters after each update. Both run in
float64 (JAX under ``enable_x64``, as tests/test_train_oracle_parity.py
does) from the same weights (``params_to_torch_state``), and the port is
handed the uniforms JAX's exchange draws (tests/jax_uniforms.py), so the
sampled bits are equal and every other number agrees to ~1e-9 relative.
``fast="kernel"`` runs the plain version of the train-mode kernel here
(CPU tensors).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.data.device_dataset import (
    DeviceDataset as JaxDeviceDataset)
from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.fast_train import (
    compute_losses_fast as jax_compute_losses_fast)
from multimodalgame_tpu.game.train import compute_losses as jax_compute_losses
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.game.train import make_train_step as jax_train_step
from multimodalgame_tpu.game.train import (
    make_multistep_train_step_indexed as jax_multistep)
from multimodalgame_tpu.utils.torch_interop import (
    load_reference_checkpoint as jax_load_checkpoint)
from multimodalgame_tpu.utils.torch_interop import (
    save_reference_checkpoint as jax_save_checkpoint)
from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_multistep_train_step_indexed, make_train_step,
    make_train_step_indexed)
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_reference_checkpoint, load_torch_state, params_to_torch_state,
    save_reference_checkpoint)
from tests.jax_uniforms import jax_step_provider, jax_uniforms

BASE = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=10, rec_w_dim=10,
            rec_hidden=14, wv_dim=16, max_exchange=4, baseline_hid_dim=12,
            entropy_s=0.08, entropy_sen=0.01, entropy_rec=0.01,
            learning_rate=1e-3)
PRESETS = {"Fixed": dict(fixed_exchange=True),
           "Adaptive": dict(fixed_exchange=False)}
OPTIMS = ("RMSprop", "Adam", "SGD")
NUM_CLASSES, BATCH, TOP_K = 5, 6, 2
LOSSES = ("loss_rec", "loss_sen", "nll_loss", "loss_binary_rec",
          "loss_binary_s", "loss_bas_rec", "loss_bas_sen")
RTOL, ATOL = 1e-9, 1e-12
# Parameters whose gradient is analytically zero (y2.bias under
# log_softmax) carry ~1e-16 of rounding that RMSprop and Adam scale by up
# to lr / eps = 1e5, so deltas are held at atol 3e-11 (as
# tests/test_train_oracle_parity.py holds them).
DELTA_RTOL, DELTA_ATOL = 1e-8, 3e-11


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_agents(kw, params_np):
    mods = AgentModules(GameConfig(**kw)).double()
    state = {a: {k: torch.from_numpy(np.array(v, np.float64))
                 for k, v in sd.items()}
             for a, sd in params_to_torch_state(params_np).items()}
    return load_torch_state(mods, state)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    data = rng.randn(BATCH, BASE["img_feat_dim"])
    target = rng.randint(0, NUM_CLASSES, size=BATCH)
    desc = rng.randn(NUM_CLASSES, BASE["wv_dim"])
    return data, target, desc


@functools.lru_cache(maxsize=None)
def _jax_step(preset, optim, jax_fast):
    """JAX's losses, gradients and updated parameters for one step, with
    the uniforms its exchange drew, all as numpy (float64)."""
    kw = {**BASE, **PRESETS[preset], "optim_type": optim}
    with jax.enable_x64(True):
        mods = JaxModules(JaxConfig(**kw))
        params = _f64(jax_init_params(mods, jax.random.PRNGKey(0),
                                      num_classes=NUM_CLASSES))
        params_np = _np_tree(params)
        data, target, desc = _inputs(11)
        key = jax.random.PRNGKey(42)
        args = (jnp.asarray(data), jnp.asarray(target), jnp.asarray(desc),
                key)

        def loss_fn(p):
            if jax_fast is False:
                return jax_compute_losses(mods, p, *args, None, None, None,
                                          TOP_K, BATCH)
            return jax_compute_losses_fast(mods, p, *args, TOP_K, BATCH)

        grads, m = jax.grad(loss_fn, has_aux=True)(params)
        step = jax_train_step(mods, top_k=TOP_K, batch_denom=BATCH,
                              fast=jax_fast)
        new_params, _, _ = step(_f64(params_np),
                                jax_init_opt_states(mods.cfg, params),
                                *args)
        uniforms = jax_uniforms(mods.cfg, key, BATCH, dtype=jnp.float64)
        return dict(kw=kw, params=params_np, grads=_np_tree(grads),
                    new_params=_np_tree(new_params), data=data,
                    target=target, desc=desc, uniforms=uniforms,
                    losses={k: float(getattr(m, k)) for k in LOSSES},
                    accuracy=float(m.accuracy),
                    ex={k: np.asarray(getattr(m.exchange, k))
                        for k in ("sen_feats", "rec_feats", "stop_feats",
                                  "stop_masks", "n_steps")})


def _assert_params(mods, want_np, base_np, what):
    want = params_to_torch_state(want_np)
    base = params_to_torch_state(base_np)
    for agent in AGENT_NAMES:
        for name, p in getattr(mods, agent).named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy() - base[agent][name],
                want[agent][name] - base[agent][name], rtol=DELTA_RTOL,
                atol=DELTA_ATOL, err_msg=f"{what} {agent}.{name}")


@pytest.mark.parametrize("fast", [False, True, "kernel"],
                         ids=["plain", "fast", "kernel"])
@pytest.mark.parametrize("optim", OPTIMS)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_train_step_matches_jax(preset, optim, fast):
    want = _jax_step(preset, optim, False if fast is False else "auto")
    mods = _port_agents(want["kw"], want["params"])
    step = make_train_step(mods, TOP_K, BATCH, fast=fast,
                           uniforms=lambda s: want["uniforms"], device="cpu")
    opts = init_opt_states(mods.cfg, mods)
    m = step(opts, want["data"], want["target"], want["desc"], 0)

    for k in ("sen_feats", "rec_feats", "stop_feats", "stop_masks"):
        np.testing.assert_array_equal(getattr(m.exchange, k).numpy(),
                                      want["ex"][k], err_msg=k)
    assert int(m.exchange.n_steps) == int(want["ex"]["n_steps"])
    for k in LOSSES:
        np.testing.assert_allclose(float(getattr(m, k)), want["losses"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(m.accuracy) == want["accuracy"]
    grads = params_to_torch_state(want["grads"])
    for agent in AGENT_NAMES:
        for name, p in getattr(mods, agent).named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[agent][name],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"grad {agent}.{name}")
    _assert_params(mods, want["new_params"], want["params"], "update")


@pytest.mark.parametrize("fast", [True, "kernel"], ids=["fast", "kernel"])
def test_four_step_trajectory_matches_jax(fast):
    """Four steps of the indexed multi-step trainer, each with the
    uniforms of ``fold_in(key, step)``, against JAX's chunk: per-step
    losses and the parameters after each step. A sampler that kept
    sampling with stale weights would part from JAX at step 2."""
    kw = {**BASE, **PRESETS["Adaptive"], "optim_type": "Adam",
          "flipout_sen": 0.1, "flipout_rec": 0.1}
    K, N = 4, 20
    rng = np.random.RandomState(5)
    feats = rng.randn(N, kw["img_feat_dim"])
    targets = rng.randint(0, NUM_CLASSES, N)
    desc = rng.randn(NUM_CLASSES, kw["wv_dim"])
    idx = np.stack([np.sort(rng.permutation(N)[:BATCH]) for _ in range(K)])
    key = jax.random.PRNGKey(8)
    with jax.enable_x64(True):
        jmods = JaxModules(JaxConfig(**kw))
        params = _f64(jax_init_params(jmods, jax.random.PRNGKey(1),
                                      num_classes=NUM_CLASSES))
        params0 = _np_tree(params)
        chunk = jax_multistep(jmods, top_k=TOP_K, batch_denom=BATCH,
                              fast="auto")
        opts = jax_init_opt_states(jmods.cfg, params)
        jax_losses, jax_params = [], []
        cur = params
        for i in range(K):
            cur, opts, jm = chunk(cur, opts, jnp.asarray(feats),
                                  jnp.asarray(targets),
                                  jnp.asarray(idx[i:i + 1]),
                                  jnp.asarray(desc), key, step0=i)
            jax_losses.append({k: float(getattr(jm, k)[0])
                               for k in ("loss_rec", "loss_sen",
                                         "loss_bas_rec", "loss_bas_sen")})
            jax_params.append(_np_tree(cur))
        provider = jax_step_provider(jmods.cfg, key, BATCH,
                                     dtype=jnp.float64)
        for i in range(K):
            provider(i)

    mods = _port_agents(kw, params0)
    port_chunk = make_multistep_train_step_indexed(
        mods, TOP_K, BATCH, fast=fast, uniforms=provider, device="cpu")
    one = make_train_step_indexed(mods, TOP_K, BATCH, fast=fast,
                                  uniforms=provider, device="cpu")
    opts = init_opt_states(mods.cfg, mods)
    f, t, d = torch.from_numpy(feats), torch.from_numpy(targets), \
        torch.from_numpy(desc)
    for i in range(K):
        if i == 1:       # one step alone, the others through the chunk
            m = one(opts, f, t, idx[i], d, i)
            got = {k: float(getattr(m, k)) for k in jax_losses[i]}
        else:
            sm = port_chunk(opts, f, t, idx[i:i + 1], d, i)
            got = {k: float(getattr(sm, k)[0]) for k in jax_losses[i]}
        for k, v in jax_losses[i].items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
        _assert_params(mods, jax_params[i], params0, f"step {i}")


def _small_agents(seed=0, **kw):
    cfg = GameConfig(**{**BASE, **PRESETS["Adaptive"], **kw})
    return init_params(AgentModules(cfg), seed=seed)


def test_one_turn_gives_receiver_no_z_loss():
    mods = _small_agents(max_exchange=1)
    data, target, desc = _inputs(3)
    step = make_train_step(mods, TOP_K, BATCH, fast=True, device="cpu")
    m = step(init_opt_states(mods.cfg, mods), data.astype(np.float32),
             target, desc.astype(np.float32), 0)
    assert m.loss_binary_rec.item() == 0.0
    assert m.ent_binary_rec.shape == (0,)
    assert np.isfinite(m.loss_sen.item())


@pytest.mark.parametrize("fast", [False, True])
def test_continuous_channel_trains_only_the_receiver(fast):
    mods = _small_agents(use_binary=False)
    before = {k: v.clone() for k, v in mods.state_dict().items()}
    data, target, desc = _inputs(4)
    step = make_train_step(mods, TOP_K, BATCH, fast=fast, device="cpu")
    m = step(init_opt_states(mods.cfg, mods), data.astype(np.float32),
             target, desc.astype(np.float32), 0)
    assert m.loss_sen.item() == 0.0
    for k, v in mods.state_dict().items():
        if k.startswith("receiver."):
            continue
        assert torch.equal(v, before[k]), k
    assert not torch.equal(mods.receiver.y1.weight,
                           before["receiver.y1.weight"])


def test_kernel_sampler_rejects_what_it_does_not_cover():
    with pytest.raises(ValueError):
        make_train_step(_small_agents(use_binary=False), TOP_K, BATCH,
                        fast="kernel", device="cpu")
    with pytest.raises(ValueError):
        make_train_step(_small_agents(), TOP_K, BATCH, fast="pallas",
                        device="cpu")
    # The train kernel samples in float32 only; bfloat16 takes the plain
    # sampler.
    with pytest.raises(ValueError, match="float32"):
        make_train_step(_small_agents(compute_dtype="bfloat16"), TOP_K,
                        BATCH, fast="kernel", device="cpu")
    make_train_step(_small_agents(compute_dtype="bfloat16"), TOP_K, BATCH,
                    device="cpu")


def test_four_agent_checkpoint_round_trips_with_jax(tmp_path):
    """A ``.pt`` written by the port is read by the JAX package's
    ``load_reference_checkpoint``, and one written by JAX by the port's."""
    kw = {**BASE, **PRESETS["Adaptive"]}
    mods = _small_agents(seed=4)
    path = str(tmp_path / "port.pt")
    save_reference_checkpoint(path, {"step": 3}, mods)
    jmods = JaxModules(JaxConfig(**kw))
    template = jax_init_params(jmods, jax.random.PRNGKey(0),
                               num_classes=NUM_CLASSES)
    data, params = jax_load_checkpoint(path, template)
    assert data["step"] == 3
    got = params_to_torch_state(_np_tree(params))
    for agent in AGENT_NAMES:
        sd = getattr(mods, agent).state_dict()
        assert set(got[agent]) == set(sd)
        for name, v in sd.items():
            np.testing.assert_array_equal(got[agent][name], v.numpy())

    path = str(tmp_path / "jax.pt")
    jax_save_checkpoint(path, {"step": 9}, template)
    data, loaded = load_reference_checkpoint(path, GameConfig(**kw))
    assert data["step"] == 9
    want = params_to_torch_state(_np_tree(template))
    for agent in AGENT_NAMES:
        for name, v in getattr(loaded, agent).state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[agent][name])


def test_checkpoint_without_baselines_still_loads(tmp_path):
    mods = _small_agents(seed=5)
    payload = {"data": {}, "models": {
        a: getattr(mods, a).state_dict() for a in ("sender", "receiver")},
        "optimizers": {}}
    path = str(tmp_path / "serve.pt")
    torch.save(payload, path)
    _, loaded = load_reference_checkpoint(path, mods.cfg)
    assert torch.equal(loaded.sender.code_bias, mods.sender.code_bias)
    with pytest.raises(KeyError):
        load_torch_state(AgentModules(mods.cfg),
                         {"sender": mods.sender.state_dict()})


@pytest.mark.parametrize("shuffle,truncate", [(True, False), (False, False),
                                              (True, True)])
def test_device_dataset_matches_jax(synthetic_dataset, shuffle, truncate):
    """The staged set and its batch plan, the reference loader's order."""
    jds = JaxDeviceDataset.from_hdf5(synthetic_dataset["train"],
                                     "avgpool_512")
    ds = DeviceDataset.from_hdf5(synthetic_dataset["train"], "avgpool_512",
                                 device="cpu")
    assert ds.size == jds.size
    np.testing.assert_array_equal(ds.feats.numpy(), np.asarray(jds.feats))
    np.testing.assert_array_equal(ds.targets.numpy(),
                                  np.asarray(jds.targets))
    for epoch in (0, 3):
        np.testing.assert_array_equal(
            ds.epoch_indices(epoch, shuffle, 5, truncate),
            jds.epoch_indices(epoch, shuffle, 5, truncate))
