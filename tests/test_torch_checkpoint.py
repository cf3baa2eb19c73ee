"""The port's checkpoints with optimizer state, in both formats, against
the JAX package's ``utils/checkpoint.py`` (msgpack) and
``utils/torch_interop.py`` (the reference ``.pt``), on the CPU.

* The port's ``.pt``, written after a few steps, read by JAX's
  ``load_reference_checkpoint(path, params, opt_states, optim_type)``, and
  the port's msgpack file restored by JAX's strict ``load_checkpoint(path,
  params, opt_states)``: weights and SGD/RMSprop/Adam slots (Adam's count
  too) equal to the port's, bit for bit; JAX writes the same state back
  to the same bytes.
* The files JAX wrote after three steps of its trainer (its msgpack and
  its ``.pt``), resumed by the port's ``load_checkpoint``: the same
  weights and slots bit for bit from either, and the port's next three
  steps (JAX's uniforms, float64) continue JAX's trajectory to ~1e-9.
* A malformed Orbax directory, a truncated file, and a file of another
  config (a shape, a missing or an extra key) raise ``ValueError`` naming
  the path; ``-ckpt_format orbax`` writes a directory the port reads back,
  and a file where a directory is asked for, or the reverse, raises JAX's
  error; a failed write leaves the previous file whole, in either format.
  (The Orbax format against JAX's: tests/test_torch_orbax.py.)
* The attention presets' entries and their slots round-trip both ways in
  both formats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu.game.train import (
    make_multistep_train_step_indexed as jax_multistep)
from multimodalgame_tpu.utils import checkpoint as jax_checkpoint
from multimodalgame_tpu.utils import torch_interop as jax_interop
from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_multistep_train_step_indexed)
from multimodalgame_tpu_torch.utils import checkpoint as port_checkpoint
from multimodalgame_tpu_torch.utils import torch_interop
from multimodalgame_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       read_checkpoint,
                                                       save_checkpoint)
from multimodalgame_tpu_torch.utils.torch_interop import (
    params_to_torch_state)
from tests.jax_uniforms import jax_step_provider

BASE = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=10, rec_w_dim=10,
            rec_hidden=14, wv_dim=16, max_exchange=4, baseline_hid_dim=12,
            entropy_s=0.08, entropy_sen=0.01, entropy_rec=0.01,
            learning_rate=1e-3, fixed_exchange=False)
NUM_CLASSES, BATCH, TOP_K, N = 5, 6, 2, 20
RTOL, ATOL = 1e-9, 1e-12
DELTA_RTOL, DELTA_ATOL = 1e-8, 3e-11   # as tests/test_torch_train.py


def _data(seed=5):
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, BASE["img_feat_dim"])
    targets = rng.randint(0, NUM_CLASSES, N)
    desc = rng.randn(NUM_CLASSES, BASE["wv_dim"])
    idx = np.stack([np.sort(rng.permutation(N)[:BATCH]) for _ in range(6)])
    return feats, targets, desc, idx


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_port_parameter_order_is_the_references():
    """Optimizer slots are indexed by ``Module.parameters()`` position;
    the port registers its parameters in the reference's order, the one
    JAX's ``_torch_param_entries`` writes."""
    cfg = BASE
    jmods = JaxModules(JaxConfig(**cfg))
    params = jax_init_params(jmods, jax.random.PRNGKey(0),
                             num_classes=NUM_CLASSES)
    mods = AgentModules(GameConfig(**cfg))
    for agent in AGENT_NAMES:
        want = [e[0] for e in jax_interop._torch_param_entries(
            agent, params[agent])]
        assert [n for n, _ in getattr(mods, agent).named_parameters()] == \
            want, agent


@pytest.mark.parametrize("optim", ["RMSprop", "Adam", "SGD"])
def test_port_checkpoint_read_by_jax(tmp_path, optim):
    cfg = GameConfig(**BASE, optim_type=optim)
    mods = init_params(AgentModules(cfg), seed=2)
    chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH,
                                              fast="kernel", device="cpu")
    opts = init_opt_states(cfg, mods)
    feats, targets, desc, idx = _data()
    chunk(opts, torch.tensor(feats, dtype=torch.float32),
          torch.tensor(targets), idx[:2], torch.tensor(desc,
                                                       dtype=torch.float32))
    path = str(tmp_path / "port.pt")
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts,
                    fmt="pt")

    jmods = JaxModules(JaxConfig(**BASE, optim_type=optim))
    template = jax_init_params(jmods, jax.random.PRNGKey(0),
                               num_classes=NUM_CLASSES)
    data, params, jopts = jax_interop.load_reference_checkpoint(
        path, template, jax_init_opt_states(jmods.cfg, template), optim)
    assert data == {"step": 2, "best_dev_acc": 0.5}
    got = params_to_torch_state(_np_tree(params))
    for agent in AGENT_NAMES:
        for name, v in getattr(mods, agent).state_dict().items():
            np.testing.assert_array_equal(got[agent][name], v.numpy())
        # JAX's slots, written back in torch's layout, are the port's.
        back = jax_interop.opt_state_to_torch(
            agent, params[agent], jopts[agent], optim, step=2)["state"]
        mine = torch_interop.opt_states_to_torch(
            mods, opts, optim, 2)[agent]["state"]
        assert back.keys() == mine.keys()
        assert (len(mine) > 0) == (optim != "SGD")
        for i, slots in mine.items():
            assert back[i].keys() == slots.keys()
            for k, v in slots.items():
                np.testing.assert_array_equal(np.asarray(back[i][k]),
                                              np.asarray(v), err_msg=k)
    if optim == "Adam":
        assert opts["sender"]["count"] == 2


def _assert_jax_state_is_ports(params, jopts, mods, opts, optim, step):
    """JAX's trees hold the port's weights and slots, bit for bit."""
    got = params_to_torch_state(_np_tree(params))
    for agent in AGENT_NAMES:
        for name, v in getattr(mods, agent).state_dict().items():
            np.testing.assert_array_equal(got[agent][name], v.numpy())
        theirs = jax_interop.opt_state_to_torch(
            agent, params[agent], jopts[agent], optim, step=step)["state"]
        mine = torch_interop.opt_states_to_torch(
            mods, opts, optim, step)[agent]["state"]
        assert theirs.keys() == mine.keys()
        assert (len(mine) > 0) == (optim != "SGD")
        for i, slots in mine.items():
            assert theirs[i].keys() == slots.keys()
            for k, v in slots.items():
                np.testing.assert_array_equal(np.asarray(theirs[i][k]),
                                              np.asarray(v), err_msg=k)


@pytest.mark.parametrize("optim", ["RMSprop", "Adam", "SGD"])
def test_port_msgpack_restored_by_jax_strictly(tmp_path, optim):
    """The port's msgpack file after two steps, restored by JAX's
    ``load_checkpoint`` into its templates: the port's weights and slots
    bit for bit, Adam's count 2; JAX writes the restored state back to the
    port's bytes."""
    cfg = GameConfig(**BASE, optim_type=optim)
    mods = init_params(AgentModules(cfg), seed=2)
    chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH,
                                              fast="kernel", device="cpu")
    opts = init_opt_states(cfg, mods)
    feats, targets, desc, idx = _data()
    chunk(opts, torch.tensor(feats, dtype=torch.float32),
          torch.tensor(targets), idx[:2], torch.tensor(desc,
                                                       dtype=torch.float32))
    path = str(tmp_path / "port.msgpack")
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts)
    assert port_checkpoint.checkpoint_format(path) == "msgpack"

    jmods = JaxModules(JaxConfig(**BASE, optim_type=optim))
    template = jax_init_params(jmods, jax.random.PRNGKey(0),
                               num_classes=NUM_CLASSES)
    data, params, jopts = jax_checkpoint.load_checkpoint(
        path, template, jax_init_opt_states(jmods.cfg, template))
    assert data == {"step": 2, "best_dev_acc": 0.5}
    assert type(data["step"]) is int and type(data["best_dev_acc"]) is float
    _assert_jax_state_is_ports(params, jopts, mods, opts, optim, 2)
    if optim == "Adam":
        for agent in AGENT_NAMES:
            assert int(jopts[agent][1][0].count) == 2
    again = str(tmp_path / "jax.msgpack")
    jax_checkpoint.save_checkpoint(again, data, params, jopts)
    with open(again, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _jax_three_then_three(tmp_path, optim):
    """JAX's trainer in float64 for three steps, its state saved as its
    msgpack file (``jax.msgpack``) and as a ``.pt`` (``jax.pt``), then
    three more steps; returns the paths and what the port must match."""
    kw = {**BASE, "optim_type": optim}
    feats, targets, desc, idx = _data()
    key = jax.random.PRNGKey(8)
    paths = {f: str(tmp_path / f"jax.{f}") for f in ("msgpack", "pt")}
    with jax.enable_x64(True):
        jmods = JaxModules(JaxConfig(**kw))
        params = _f64(jax_init_params(jmods, jax.random.PRNGKey(1),
                                      num_classes=NUM_CLASSES))
        opts = jax_init_opt_states(jmods.cfg, params)
        chunk = jax_multistep(jmods, top_k=TOP_K, batch_denom=BATCH,
                              fast="auto")
        args = (jnp.asarray(feats), jnp.asarray(targets))
        params, opts, _ = chunk(params, opts, *args, jnp.asarray(idx[:3]),
                                jnp.asarray(desc), key, step0=0)
        params3 = _np_tree(params)
        data = {"step": 3, "best_dev_acc": 0.0}
        jax_checkpoint.save_checkpoint(paths["msgpack"], data, params, opts)
        jax_interop.save_reference_checkpoint(
            paths["pt"], data, params3, _np_tree(opts), optim)
        params, opts, jm = chunk(params, opts, *args, jnp.asarray(idx[3:]),
                                 jnp.asarray(desc), key, step0=3)
        want_losses = np.asarray(jm.loss_rec), np.asarray(jm.loss_sen)
        params6 = _np_tree(params)
        provider = jax_step_provider(jmods.cfg, key, BATCH,
                                     dtype=jnp.float64)
        for s in range(3, 6):
            provider(s)
    return dict(kw=kw, paths=paths, params3=params3, params6=params6,
                want_losses=want_losses, provider=provider,
                data=(feats, targets, desc, idx))


def _resume_on_jax_trajectory(run, path, optim):
    """The port loads ``path`` into float64 agents and takes JAX's next
    three steps: losses to ~1e-9 and the updates to JAX's."""
    feats, targets, desc, idx = run["data"]
    mods = AgentModules(GameConfig(**run["kw"])).double()
    port_opts = init_opt_states(mods.cfg, mods)
    assert load_checkpoint(path, mods, port_opts)["step"] == 3
    if optim == "Adam":
        assert port_opts["receiver"]["count"] == 3
    port_chunk = make_multistep_train_step_indexed(
        mods, TOP_K, BATCH, fast="kernel", uniforms=run["provider"],
        device="cpu")
    sm = port_chunk(port_opts, torch.from_numpy(feats),
                    torch.from_numpy(targets), idx[3:],
                    torch.from_numpy(desc), 3)
    np.testing.assert_allclose(sm.loss_rec.numpy(), run["want_losses"][0],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sm.loss_sen.numpy(), run["want_losses"][1],
                               rtol=RTOL, atol=ATOL)
    want = params_to_torch_state(run["params6"])
    base = params_to_torch_state(run["params3"])
    for agent in AGENT_NAMES:
        for name, p in getattr(mods, agent).named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy() - base[agent][name],
                want[agent][name] - base[agent][name], rtol=DELTA_RTOL,
                atol=DELTA_ATOL, err_msg=f"{agent}.{name}")


@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
def test_port_resumes_jax_checkpoint_on_jax_trajectory(tmp_path, optim):
    run = _jax_three_then_three(tmp_path, optim)
    _resume_on_jax_trajectory(run, run["paths"]["pt"], optim)


@pytest.mark.parametrize("optim", ["SGD", "RMSprop", "Adam"])
def test_port_resumes_jax_msgpack_on_jax_trajectory(tmp_path, optim):
    """JAX's msgpack file loads into the port bit for bit as its ``.pt``
    of the same state does, and the port resumes on JAX's trajectory."""
    run = _jax_three_then_three(tmp_path, optim)
    loaded = {}
    for fmt, path in run["paths"].items():
        assert port_checkpoint.checkpoint_format(path) == fmt
        mods = AgentModules(GameConfig(**run["kw"])).double()
        opts = init_opt_states(mods.cfg, mods)
        assert load_checkpoint(path, mods, opts) == {"step": 3,
                                                     "best_dev_acc": 0.0}
        loaded[fmt] = (mods, opts)
    (a, a_opts), (b, b_opts) = loaded["msgpack"], loaded["pt"]
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.float64 and torch.equal(p, q), name
    for agent in AGENT_NAMES:
        for slot in ("mu", "nu"):
            for x, y in zip(a_opts[agent].get(slot, []),
                            b_opts[agent].get(slot, [])):
                assert torch.equal(x, y), (agent, slot)
        if optim == "Adam":
            assert int(a_opts[agent]["count"]) == 3
    _resume_on_jax_trajectory(run, run["paths"]["msgpack"], optim)


def test_jax_native_formats_raise_clearly(tmp_path):
    """JAX's msgpack file loads; a malformed Orbax directory, a truncated
    msgpack file and a file of another config raise ``ValueError`` naming
    the path, before any weight changes; ``-ckpt_format orbax`` writes a
    directory that loads, and neither format is written over the
    other."""
    from flax import serialization
    kw = {**BASE}
    jmods = JaxModules(JaxConfig(**kw))
    params = jax_init_params(jmods, jax.random.PRNGKey(0),
                             num_classes=NUM_CLASSES)
    path = str(tmp_path / "native.msgpack")
    jax_checkpoint.save_checkpoint(path, {"step": 1, "best_dev_acc": 0.0},
                                   params,
                                   jax_init_opt_states(jmods.cfg, params))
    mods = AgentModules(GameConfig(**kw))
    opts = init_opt_states(mods.cfg, mods)
    assert load_checkpoint(path, mods, opts)["step"] == 1
    blob = open(path, "rb").read()

    def variant(name, edit):
        t = serialization.msgpack_restore(blob)
        edit(t)
        out = str(tmp_path / name)
        with open(out, "wb") as f:
            f.write(serialization.msgpack_serialize(t))
        return out

    orbax_dir = tmp_path / "orbax_ckpt"
    (orbax_dir / "models").mkdir(parents=True)
    (orbax_dir / "_METADATA").write_text("{}")
    truncated = str(tmp_path / "truncated.msgpack")
    with open(truncated, "wb") as f:
        f.write(blob[:len(blob) // 2])
    cases = {
        str(orbax_dir): "_METADATA lacks tree_metadata",
        truncated: "not a readable msgpack checkpoint: truncated",
        variant("missing.msgpack",
                lambda t: t["models"]["sender"].pop("code_bias")):
            r"models/sender lacks \['code_bias'\]",
        variant("extra.msgpack",
                lambda t: t["optimizers"]["receiver"]["1"].update(
                    {"3": {}})): r"has extra \['3'\]",
        variant("shape.msgpack", lambda t: t["models"]["receiver"][
            "w"].update(kernel=np.zeros((3, 3), np.float32))):
            "models/receiver/w/kernel is float32 \\(3, 3\\)",
        variant("no_data.msgpack", lambda t: t.pop("data")):
            "no {data, models, optimizers}",
    }
    other = GameConfig(**{**kw, "img_h_dim": 13})
    before = [p.clone() for p in mods.parameters()]
    for bad, match in cases.items():
        with pytest.raises(ValueError, match=match) as err:
            load_checkpoint(bad, mods, opts)
        assert bad in str(err.value)
    with pytest.raises(ValueError, match="image_layer/kernel is float32"):
        load_checkpoint(path, AgentModules(other),
                        init_opt_states(other, AgentModules(other)))
    assert all(torch.equal(p, q) for p, q in zip(mods.parameters(), before))
    orbax_path = str(tmp_path / "port_orbax")
    save_checkpoint(orbax_path, {"step": 2, "best_dev_acc": 0.0}, mods, opts,
                    fmt="orbax")
    assert load_checkpoint(orbax_path, mods, opts)["step"] == 2
    assert port_checkpoint.checkpoint_format(orbax_path) == "orbax"
    for target, fmt, match in ((path, "orbax", "is a msgpack checkpoint file"),
                               (orbax_path, "msgpack",
                                "is an orbax checkpoint directory")):
        with pytest.raises(ValueError, match=match):
            save_checkpoint(target, {"step": 3, "best_dev_acc": 0.0}, mods,
                            opts, fmt=fmt)


def test_failed_write_keeps_the_previous_file(tmp_path, monkeypatch):
    """A write that fails part way leaves the previous file whole, in
    either format."""
    mods = init_params(AgentModules(GameConfig(**BASE)), seed=3)
    opts = init_opt_states(mods.cfg, mods)

    def broken_save(obj, f):
        with open(f, "wb") as out:
            out.write(b"partial")
        raise OSError("disk full")

    def broken_replace(src, dst):
        raise OSError("disk full")

    for fmt, target, broken in (
            ("pt", torch_interop.torch, ("save", broken_save)),
            ("msgpack", port_checkpoint.os, ("replace", broken_replace))):
        path = str(tmp_path / f"ckpt.{fmt}")
        save_checkpoint(path, {"step": 1, "best_dev_acc": 0.0}, mods, opts,
                        fmt=fmt)
        monkeypatch.setattr(target, *broken)
        with pytest.raises(OSError):
            save_checkpoint(path, {"step": 2, "best_dev_acc": 0.0}, mods,
                            opts, fmt=fmt)
        monkeypatch.undo()
        fresh = AgentModules(GameConfig(**BASE))
        assert load_checkpoint(path, fresh, init_opt_states(
            fresh.cfg, fresh))["step"] == 1
        assert torch.equal(fresh.sender.code_bias, mods.sender.code_bias)
        assert port_checkpoint.checkpoint_format(path) == fmt


# ------------------------------------------------ attention, desc_attn, mou

ATTN_DIMS = dict(attn_dim=8, attn_context_dim=20, desc_attn_dim=6)
ATTN_VARIANTS = {
    "AdaptiveAttention": dict(visual_attn=True, attn_extra_context=True),
    "desc_attn": dict(desc_attn=True),
    "mou_ignore_code": dict(sender_mix="mou", ignore_code=True),
    "all": dict(visual_attn=True, attn_extra_context=True, desc_attn=True,
                sender_mix="mou"),
}
WORDS = (1, 3, 2, 4, 2)
# One entry each variant adds to the file.
NEW_ENTRY = {"AdaptiveAttention": "sender.attn_W_g.weight",
             "desc_attn": "receiver.d_attn.weight",
             "mou_ignore_code": "sender.code_bias_mou",
             "all": "receiver.d_h.bias"}


def _attn_kw(name, **kw):
    return {**BASE, **ATTN_DIMS, **ATTN_VARIANTS[name], **kw}


@pytest.mark.parametrize("name", list(ATTN_VARIANTS))
def test_attention_parameter_order_is_the_references(name):
    """The new layers' slots sit where JAX's ``_torch_param_entries``
    puts them: ``code_bias_mou`` after ``code_bias``, the attention layers
    after ``binary_layer``, ``d_d``/``d_h``/``d_attn`` last."""
    kw = _attn_kw(name)
    jmods = JaxModules(JaxConfig(**kw))
    params = jax_init_params(jmods, jax.random.PRNGKey(0),
                             num_classes=NUM_CLASSES, max_words=max(WORDS))
    mods = AgentModules(GameConfig(**kw))
    for agent in AGENT_NAMES:
        want = [e[0] for e in jax_interop._torch_param_entries(
            agent, params[agent])]
        assert [n for n, _ in getattr(mods, agent).named_parameters()] == \
            want, agent


def _attention_steps(name, optim, steps=2):
    """The port's agents after ``steps`` updates of ``name`` (CPU, f32),
    with their optimizer states."""
    cfg = GameConfig(**_attn_kw(name, optim_type=optim))
    mods = init_params(AgentModules(cfg), seed=2)
    chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH,
                                              device="cpu")
    opts = init_opt_states(cfg, mods)
    rng = np.random.RandomState(6)
    shape = ((N, cfg.img_feat_dim, 3, 3) if cfg.visual_attn
             else (N, cfg.img_feat_dim))
    mask = np.arange(max(WORDS))[None] < np.asarray(WORDS)[:, None]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    _, targets, desc, idx = _data()
    chunk(opts, f32(rng.randn(*shape)), torch.tensor(targets),
          idx[:steps], f32(desc),
          feats_context=(f32(rng.randn(N, cfg.attn_context_dim))
                         if cfg.attn_extra_context else None),
          desc_set_padded=(f32(rng.randn(NUM_CLASSES, max(WORDS),
                                         cfg.wv_dim) * mask[..., None])
                           if cfg.desc_attn else None),
          desc_set_mask=f32(mask) if cfg.desc_attn else None)
    return cfg, mods, opts


@pytest.mark.parametrize("name", list(ATTN_VARIANTS))
@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
def test_attention_checkpoint_round_trips(tmp_path, name, optim):
    """The port's ``.pt`` with the new entries and their slots: the port
    reads it back whole, and JAX's ``load_reference_checkpoint`` reads the
    same weights and slots."""
    cfg, mods, opts = _attention_steps(name, optim)
    path = str(tmp_path / "attn.pt")
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts,
                    fmt="pt")

    back = AgentModules(cfg)
    back_opts = init_opt_states(cfg, back)
    assert load_checkpoint(path, back, back_opts)["step"] == 2
    for agent in AGENT_NAMES:
        a = getattr(mods, agent).state_dict()
        b = getattr(back, agent).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (agent, k)
        for i, (x, y) in enumerate(zip(opts[agent]["nu"],
                                       back_opts[agent]["nu"])):
            assert torch.equal(x, y), (agent, i)
    agent, entry = NEW_ENTRY[name].split(".", 1)
    assert entry in torch_interop.read_reference_checkpoint(
        path)["models"][agent]

    jmods = JaxModules(JaxConfig(**_attn_kw(name, optim_type=optim)))
    template = jax_init_params(jmods, jax.random.PRNGKey(0),
                               num_classes=NUM_CLASSES,
                               max_words=max(WORDS))
    data, params, jopts = jax_interop.load_reference_checkpoint(
        path, template, jax_init_opt_states(jmods.cfg, template), optim)
    assert data == {"step": 2, "best_dev_acc": 0.5}
    got = params_to_torch_state(_np_tree(params))
    for agent in AGENT_NAMES:
        for k, v in getattr(mods, agent).state_dict().items():
            np.testing.assert_array_equal(got[agent][k], v.numpy())
        theirs = jax_interop.opt_state_to_torch(
            agent, params[agent], jopts[agent], optim, step=2)["state"]
        mine = torch_interop.opt_states_to_torch(
            mods, opts, optim, 2)[agent]["state"]
        assert theirs.keys() == mine.keys()
        for i, slots in mine.items():
            for k, v in slots.items():
                np.testing.assert_array_equal(np.asarray(theirs[i][k]),
                                              np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", list(ATTN_VARIANTS))
@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
def test_attention_msgpack_round_trips(tmp_path, name, optim):
    """Both ways in msgpack: the port's file with the new entries and their
    slots, restored by JAX's strict ``load_checkpoint`` (bit for bit) and
    read back by the port; JAX's file of its own weights and random slots
    for the variant, loaded by the port bit for bit."""
    cfg, mods, opts = _attention_steps(name, optim)
    path = str(tmp_path / "attn.msgpack")
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts)
    agent, entry = NEW_ENTRY[name].split(".", 1)
    assert entry in read_checkpoint(path)["models"][agent]
    back = AgentModules(cfg)
    back_opts = init_opt_states(cfg, back)
    assert load_checkpoint(path, back, back_opts)["step"] == 2
    for (k, p), q in zip(mods.named_parameters(), back.parameters()):
        assert torch.equal(p, q), k

    jmods = JaxModules(JaxConfig(**_attn_kw(name, optim_type=optim)))
    template = jax_init_params(jmods, jax.random.PRNGKey(0),
                               num_classes=NUM_CLASSES,
                               max_words=max(WORDS))
    data, params, jopts = jax_checkpoint.load_checkpoint(
        path, template, jax_init_opt_states(jmods.cfg, template))
    assert data == {"step": 2, "best_dev_acc": 0.5}
    _assert_jax_state_is_ports(params, jopts, mods, opts, optim, 2)

    rng = np.random.RandomState(9)
    jopts = jax.tree_util.tree_map(
        lambda x: (rng.randn(*x.shape).astype(np.float32)
                   if np.issubdtype(x.dtype, np.floating)
                   else np.asarray(4, x.dtype)),
        jax_init_opt_states(jmods.cfg, template))
    theirs = str(tmp_path / "jax.msgpack")
    jax_checkpoint.save_checkpoint(theirs, {"step": 4, "best_dev_acc": 0.0},
                                   template, jopts)
    port = AgentModules(cfg)
    port_opts = init_opt_states(cfg, port)
    assert load_checkpoint(theirs, port, port_opts)["step"] == 4
    _assert_jax_state_is_ports(template, jopts, port, port_opts, optim, 4)
