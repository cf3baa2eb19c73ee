"""The PyTorch port's modules against the JAX package's, on the CPU.

Weights are made by the JAX package's ``init_params`` and carried across
with the port's ``params_to_torch_state``; inputs come from a seeded
numpy generator. Tolerance: atol 1e-5 on f32 activations (the two
frameworks sum the same products in different orders).
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.losses import get_rec_outp as jax_get_rec_outp
from multimodalgame_tpu.game.masks import (
    assemble_loss_masks as jax_assemble_loss_masks)
from multimodalgame_tpu.game.masks import build_mask as jax_build_mask
from multimodalgame_tpu.ops.sampling import hard_round as jax_hard_round
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.losses import get_rec_outp
from multimodalgame_tpu_torch.game.masks import (assemble_loss_masks,
                                                 build_mask, corrupt_message)
from multimodalgame_tpu_torch.ops.sampling import hard_round
from multimodalgame_tpu_torch.utils.device import resolve_device
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)

B, D, FEAT, W, HID, WV, T = 8, 5, 64, 16, 32, 24, 4
ATOL = 1e-5


def _dims(**kw):
    base = dict(img_feat_dim=FEAT, img_h_dim=32, sender_out_dim=W,
                rec_w_dim=W, rec_hidden=HID, wv_dim=WV, max_exchange=T,
                baseline_hid_dim=16, fixed_exchange=False)
    base.update(kw)
    return base


def _carry(**kw):
    """JAX modules and params, and the port's agents at the same weights."""
    jm = JaxModules(JaxConfig(**_dims(**kw)))
    jp = jax_init_params(jm, jax.random.PRNGKey(0), num_classes=D)
    mods = load_torch_state(AgentModules(GameConfig(**_dims(**kw))),
                            params_to_torch_state(jp))
    return jm, jp, mods


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def test_gru_matches_jax():
    jm, jp, mods = _carry()
    rng = np.random.RandomState(0)
    z = (rng.rand(B, W) < 0.5).astype(np.float32)
    h = rng.randn(B, HID).astype(np.float32)
    want = jm.receiver.apply({"params": jp["receiver"]}, jnp.asarray(z),
                             jnp.asarray(h), method="gru")
    got = mods.receiver.rnn(torch.from_numpy(z), torch.from_numpy(h))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


@pytest.mark.parametrize("variant", [dict(), dict(sender_mix="prod"),
                                     dict(ignore_code=True)],
                         ids=["sum", "prod", "ignore_code"])
@pytest.mark.parametrize("t", [0, 2])
def test_sender_step_matches_jax(variant, t):
    jm, jp, mods = _carry(**variant)
    rng = np.random.RandomState(1)
    x = rng.randn(B, FEAT).astype(np.float32)
    w = (rng.rand(B, W) < 0.5).astype(np.float32)

    def japply(method, *a):
        return jm.sender.apply({"params": jp["sender"]}, *a, method=method)

    cache = japply("precompute", jnp.asarray(x), None)
    want_logits, want_hx, _ = japply("step", jnp.asarray(x), jnp.asarray(w),
                                     jnp.int32(t), cache)
    pc = mods.sender.precompute(torch.from_numpy(x))
    logits, h_x, attn = mods.sender.step(torch.from_numpy(w), t, pc)
    assert attn is None
    np.testing.assert_allclose(_np(pc["h_x"]), _np(want_hx), atol=ATOL)
    np.testing.assert_allclose(_np(h_x), _np(want_hx), atol=ATOL)
    np.testing.assert_allclose(_np(logits), _np(want_logits), atol=ATOL)
    np.testing.assert_allclose(_np(pc["h_w_first"]),
                               _np(cache["h_w_first"]), atol=ATOL)


def test_receiver_step_and_heads_match_jax():
    jm, jp, mods = _carry()
    rng = np.random.RandomState(2)
    z = (rng.rand(B, W) < 0.5).astype(np.float32)
    h = rng.randn(B, HID).astype(np.float32)
    desc = rng.randn(D, WV).astype(np.float32)

    def japply(method, *a):
        return jm.receiver.apply({"params": jp["receiver"]}, *a,
                                 method=method)

    cache = japply("precompute", jnp.asarray(desc))
    want = japply("step", jnp.asarray(z), jnp.asarray(h), cache)
    pc = mods.receiver.precompute(torch.from_numpy(desc))
    got = mods.receiver.step(torch.from_numpy(z), torch.from_numpy(h), pc)
    for g, w_ in zip(got, want):          # h_z_new, s_logits, y, w_logits
        np.testing.assert_allclose(_np(g), _np(w_), atol=ATOL)
    np.testing.assert_allclose(_np(pc["desc_proj"]), _np(cache["desc_proj"]),
                               atol=ATOL)
    heads = mods.receiver.heads(torch.from_numpy(h), pc)
    want_heads = japply("heads", jnp.asarray(h), cache)
    for g, w_ in zip(heads, want_heads):
        np.testing.assert_allclose(_np(g), _np(w_), atol=ATOL)


def test_init_matches_jax_in_distribution():
    """Xavier-normal weights (stacked-GRU fan), zero biases, std-normal
    code_bias: the port's init and the JAX init agree in per-tensor std
    (within sampling noise) and in which tensors are zero."""
    kw = dict(img_feat_dim=512, img_h_dim=256, sender_out_dim=32,
              rec_w_dim=32, rec_hidden=64, wv_dim=100, baseline_hid_dim=16)
    jp = jax_init_params(JaxModules(JaxConfig(**kw)), jax.random.PRNGKey(3),
                         num_classes=30)
    want = params_to_torch_state(jp)
    mods = init_params(AgentModules(GameConfig(**kw)), seed=3)
    for agent in ("sender", "receiver"):
        got = getattr(mods, agent).state_dict()
        assert set(got) == set(want[agent])
        for name, v in got.items():
            ref = want[agent][name]
            assert tuple(v.shape) == ref.shape, name
            if not ref.any():
                assert not v.any(), name
                continue
            ratio = float(v.std()) / float(ref.std())
            tol = 0.35 if v.numel() < 100 else 0.1
            assert abs(ratio - 1.0) < tol, (name, ratio)
    # Different seeds give different weights; the same seed the same.
    again = init_params(AgentModules(GameConfig(**kw)), seed=3)
    other = init_params(AgentModules(GameConfig(**kw)), seed=4)
    w0 = mods.sender.image_layer.weight
    assert torch.equal(w0, again.sender.image_layer.weight)
    assert not torch.equal(w0, other.sender.image_layer.weight)


def test_hard_round_rounds_half_up():
    p = np.asarray([0.0, 0.25, 0.4999, 0.5, 0.5001, 0.75, 1.0],
                   np.float32)
    got = _np(hard_round(torch.from_numpy(p)))
    np.testing.assert_array_equal(got, _np(jax_hard_round(jnp.asarray(p))))
    np.testing.assert_array_equal(got, [0, 0, 0, 1, 1, 1, 1])
    # The trap: torch.round rounds half to even.
    assert float(torch.round(torch.tensor(0.5))) == 0.0


@pytest.mark.parametrize("spec", ["0:3,7", "5", "0:16", "2:4,9:12"])
def test_build_mask_and_corruption_match_jax(spec):
    mask = build_mask(spec, W)
    np.testing.assert_array_equal(mask, jax_build_mask(spec, W))
    z = (np.random.RandomState(4).rand(B, W) < 0.5).astype(np.float32)
    got = corrupt_message(torch.from_numpy(z), torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(got), np.abs(z - mask[None]))
    z_t = torch.from_numpy(z)
    assert corrupt_message(z_t, None) is z_t


def test_loss_masks_and_rec_outp_match_jax():
    rng = np.random.RandomState(5)
    masks = np.minimum.accumulate(
        (rng.rand(T, B, 1) < 0.7).astype(np.float32), axis=0)
    stop_masks = np.concatenate([np.ones((1, B, 1), np.float32), masks])
    stop_masks[-1] = 0.0
    y = rng.randn(T, B, D).astype(np.float32)
    got = assemble_loss_masks(torch.from_numpy(stop_masks))
    want = jax_assemble_loss_masks(jnp.asarray(stop_masks))
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(_np(getattr(got, f.name)),
                                      _np(getattr(want, f.name)))
    for y_masks in (got.y, None):
        out, neg = get_rec_outp(torch.from_numpy(y), y_masks)
        w_out, w_neg = jax_get_rec_outp(
            jnp.asarray(y), None if y_masks is None else want.y)
        np.testing.assert_allclose(_np(out), _np(w_out), atol=ATOL)
        np.testing.assert_allclose(_np(neg), _np(w_neg), atol=ATOL)


def test_game_config_copies_jax_fields_and_check():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(GameConfig)}
    assert pf == jf
    with pytest.raises(ValueError):
        GameConfig(sender_out_dim=8, rec_w_dim=16)


@pytest.mark.parametrize("kw", [dict(rec_out_dim=2), dict(rec_s_dim=2)],
                         ids=["rec_out_dim", "rec_s_dim"])
def test_unported_variants_raise(kw):
    with pytest.raises(NotImplementedError):
        AgentModules(GameConfig(**_dims(**kw)))


def test_resolve_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


_BANNED = ("jax", "flax", "msgpack", "optax", "sklearn", "orbax",
           "tensorstore", "zstandard", "numcodecs", "zarr",
           "multimodalgame_tpu")


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in _BANNED


def test_port_imports_nothing_of_jax():
    """Every module of the port, walked with ``ast``: no import of jax,
    flax, msgpack (the port keeps its own codec), optax, sklearn, or the
    JAX package ``multimodalgame_tpu`` (exact name or
    ``multimodalgame_tpu.*`` — the port's own name shares the prefix), nor
    of orbax, tensorstore, zstandard, numcodecs or zarr (the port keeps
    its own Orbax, OCDBT and zstd codecs)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "multimodalgame_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    port = root / "multimodalgame_tpu_torch"
    for module in ("sweep.py", "parallel/population.py", "data/cifar.py",
                   "parallel/tensor.py", "models/resnet.py",
                   "package_data.py", "utils/msgpack.py", "utils/zstd.py",
                   "utils/ocdbt.py", "utils/orbax.py"):
        assert port / module in files, module
    seen = set()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                seen.add(name)
                assert not _banned(name), f"{path}: imports {name}"
    assert "multimodalgame_tpu_torch.game.config" in seen
    assert not _banned("multimodalgame_tpu_torch.serve")
    assert _banned("multimodalgame_tpu.serve") and _banned("jax.numpy")
    assert _banned("sklearn.metrics")
