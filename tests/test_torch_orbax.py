"""The port's Orbax checkpoint directories (``utils/orbax.py`` and the
``orbax`` format of ``utils/checkpoint.py``) against the JAX package's
``save_checkpoint(fmt="orbax")``/``load_checkpoint``, on the CPU.

* The committed fixture ``tests/data/orbax_jax_adam`` (JAX's Orbax
  directory of a narrow Adam game after three steps, written by
  :func:`write_fixture`) is what JAX writes today: JAX restores it and
  writes it again in ``tmp_path``, and the port reads the same leaves,
  ``_METADATA`` and ``.zarray`` JSON from both.
* Port -> JAX: the port's directory after two steps, restored by JAX's
  ``load_checkpoint``, bit for bit (SGD, RMSprop, Adam, and the
  attention presets); JAX writes the restored state back with the port's
  ``_METADATA`` and ``.zarray`` JSON and the same array bytes.
* JAX -> port: JAX's directory of its float64 state after three steps
  loads bit for bit as its msgpack file does, and the port's next three
  steps continue JAX's trajectory at the msgpack resume's tolerance.
* A data-parallel mesh and a 1 x 2 grid of gloo ranks write a directory
  (rank 0, committed before the barriers) that JAX restores.
* Malformed directories raise ``ValueError`` naming the path before any
  weight changes; no format falls back to another.
* The asynchronous write: ``save_checkpoint`` returns before the commit,
  its snapshot is a finished host copy (a ``graph=True`` step run right
  after the save does not move it), and ``recover_orbax`` repairs the
  crash windows of JAX's tests/test_checkpoint.py:141.

Regenerate the fixture (JAX on the CPU) with
``JAX_PLATFORMS=cpu python -m tests.test_torch_orbax``.
"""

import json
import os
import shutil
import threading

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
from multimodalgame_tpu_torch.game.agents import (AGENT_NAMES, AgentModules,
                                                  init_params)
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import (
    init_opt_states, make_multistep_train_step_indexed)
from multimodalgame_tpu_torch.train import run
from multimodalgame_tpu_torch.utils import checkpoint as port_checkpoint
from multimodalgame_tpu_torch.utils import ocdbt, orbax
from multimodalgame_tpu_torch.utils.checkpoint import (
    checkpoint_format, load_checkpoint, read_checkpoint, recover_orbax,
    save_checkpoint, wait_for_checkpoints)
from tests.port_runs import jax_flags, port_flags, small_argv
from tests.test_torch_checkpoint import (BASE, BATCH, NUM_CLASSES, TOP_K,
                                         _assert_jax_state_is_ports,
                                         _attention_steps, _attn_kw, _data,
                                         _jax_three_then_three,
                                         _resume_on_jax_trajectory)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "orbax_jax_adam")
# The fixture's game: these flags (with -model_type Adaptive) and 6 classes.
FIXTURE_KW = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=8,
                  rec_w_dim=8, rec_hidden=12, baseline_hid_dim=12,
                  wv_dim=16, max_exchange=3, fixed_exchange=False,
                  optim_type="Adam")
FIXTURE_CLASSES = 6


def write_fixture(path):
    """JAX's Orbax directory of the fixture game after three steps of its
    trainer on seeded data, at step 3 with best dev accuracy 0.25."""
    cfg = JaxConfig(**FIXTURE_KW)
    mods = JaxModules(cfg)
    params = jax_init_params(mods, jax.random.PRNGKey(0),
                             num_classes=FIXTURE_CLASSES)
    opts = jax_init_opt_states(cfg, params)
    rng = np.random.RandomState(0)
    feats = rng.randn(16, cfg.img_feat_dim).astype(np.float32)
    targets = rng.randint(0, FIXTURE_CLASSES, 16)
    desc = rng.randn(FIXTURE_CLASSES, cfg.wv_dim).astype(np.float32)
    idx = np.stack([np.sort(rng.permutation(16)[:8]) for _ in range(3)])
    chunk = jax_multistep(mods, top_k=2, batch_denom=8, fast="auto")
    params, opts, _ = chunk(params, opts, jnp.asarray(feats),
                            jnp.asarray(targets), jnp.asarray(idx),
                            jnp.asarray(desc), jax.random.PRNGKey(1),
                            step0=0)
    jax_checkpoint.save_checkpoint(path, {"step": 3, "best_dev_acc": 0.25},
                                   params, opts, fmt="orbax")
    jax_checkpoint.wait_for_checkpoints()


def _jax_templates(kw, num_classes=NUM_CLASSES, **init):
    jmods = JaxModules(JaxConfig(**kw))
    params = jax_init_params(jmods, jax.random.PRNGKey(0),
                             num_classes=num_classes, **init)
    return params, jax_init_opt_states(jmods.cfg, params)


def _assert_same_tree(got, want, where=""):
    assert type(got) is type(want) or (isinstance(got, np.ndarray)
                                       and isinstance(want, np.ndarray)), \
        where
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where


def _assert_same_directory(a, b):
    """The same ``_METADATA`` text, ``.zarray`` JSON and decoded leaves."""
    with open(os.path.join(a, orbax.METADATA)) as f, \
            open(os.path.join(b, orbax.METADATA)) as g:
        assert f.read() == g.read()
    sa, sb = ocdbt.read_store(a), ocdbt.read_store(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        if k.endswith(b".zarray"):
            assert sa[k] == sb[k], k
    _assert_same_tree(orbax.read_orbax(a), orbax.read_orbax(b))


def test_fixture_is_what_jax_writes(tmp_path):
    params, opts = _jax_templates(FIXTURE_KW, FIXTURE_CLASSES)
    data, params, opts = jax_checkpoint.load_checkpoint(FIXTURE, params,
                                                        opts)
    assert data == {"step": 3, "best_dev_acc": 0.25}
    again = str(tmp_path / "rewritten")
    jax_checkpoint.save_checkpoint(again, data, params, opts, fmt="orbax")
    jax_checkpoint.wait_for_checkpoints()
    _assert_same_directory(again, FIXTURE)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 100_000
    # The port's own directory of the fixture's state is JAX's too.
    mine = str(tmp_path / "port")
    cfg = GameConfig(**FIXTURE_KW)
    mods = AgentModules(cfg)
    mods_opts = init_opt_states(cfg, mods)
    assert load_checkpoint(FIXTURE, mods, mods_opts)["step"] == 3
    save_checkpoint(mine, {"step": 3, "best_dev_acc": 0.25}, mods,
                    mods_opts, fmt="orbax")
    wait_for_checkpoints()
    _assert_same_directory(mine, FIXTURE)


def _port_steps(optim, steps=2):
    cfg = GameConfig(**BASE, optim_type=optim)
    mods = init_params(AgentModules(cfg), seed=2)
    chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH,
                                              fast="kernel", device="cpu")
    opts = init_opt_states(cfg, mods)
    feats, targets, desc, idx = _data()
    chunk(opts, torch.tensor(feats, dtype=torch.float32),
          torch.tensor(targets), idx[:steps],
          torch.tensor(desc, dtype=torch.float32))
    return cfg, mods, opts


@pytest.mark.parametrize("optim", ["SGD", "RMSprop", "Adam"])
def test_port_orbax_restored_by_jax(tmp_path, optim):
    _, mods, opts = _port_steps(optim)
    path = str(tmp_path / "port")
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts,
                    fmt="orbax")
    wait_for_checkpoints()
    assert checkpoint_format(path) == "orbax"
    params, jopts = _jax_templates({**BASE, "optim_type": optim})
    data, params, jopts = jax_checkpoint.load_checkpoint(path, params, jopts)
    assert data == {"step": 2, "best_dev_acc": 0.5}
    assert type(data["step"]) is int and type(data["best_dev_acc"]) is float
    _assert_jax_state_is_ports(params, jopts, mods, opts, optim, 2)
    again = str(tmp_path / "jax")
    jax_checkpoint.save_checkpoint(again, data, params, jopts, fmt="orbax")
    jax_checkpoint.wait_for_checkpoints()
    _assert_same_directory(path, again)


@pytest.mark.parametrize("optim", ["SGD", "RMSprop", "Adam"])
def test_port_resumes_jax_orbax_on_jax_trajectory(tmp_path, optim):
    """JAX's Orbax directory of its float64 state after three steps loads
    into the port bit for bit as its msgpack file of the same state does,
    and the port resumes on JAX's trajectory."""
    jrun = _jax_three_then_three(tmp_path, optim)
    with jax.enable_x64(True):
        params, jopts = _jax_templates(jrun["kw"])
        params, jopts = jax.tree_util.tree_map(
            lambda x: (jnp.asarray(x, jnp.float64)
                       if jnp.issubdtype(x.dtype, jnp.floating) else x),
            (params, jopts))
        data, params, jopts = jax_checkpoint.load_checkpoint(
            jrun["paths"]["msgpack"], params, jopts)
        path = str(tmp_path / "jax_orbax")
        jax_checkpoint.save_checkpoint(path, data, params, jopts,
                                       fmt="orbax")
        jax_checkpoint.wait_for_checkpoints()
    loaded = {}
    for fmt, p in (("orbax", path), ("msgpack", jrun["paths"]["msgpack"])):
        assert checkpoint_format(p) == fmt
        mods = AgentModules(GameConfig(**jrun["kw"])).double()
        opts = init_opt_states(mods.cfg, mods)
        assert load_checkpoint(p, mods, opts) == {"step": 3,
                                                  "best_dev_acc": 0.0}
        loaded[fmt] = (mods, opts)
    (a, a_opts), (b, b_opts) = loaded["orbax"], loaded["msgpack"]
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.float64 and torch.equal(p, q), name
    for agent in AGENT_NAMES:
        for slot in ("mu", "nu"):
            for x, y in zip(a_opts[agent].get(slot, []),
                            b_opts[agent].get(slot, [])):
                assert torch.equal(x, y), (agent, slot)
        assert a_opts[agent].get("count") == b_opts[agent].get("count")
    _resume_on_jax_trajectory(jrun, path, optim)


@pytest.mark.parametrize("name", ["AdaptiveAttention", "desc_attn",
                                  "mou_ignore_code", "all"])
def test_attention_orbax_round_trips(tmp_path, name):
    """Both ways: the port's directory with the variant's entries, restored
    by JAX bit for bit; JAX's directory of its weights and random slots,
    loaded by the port bit for bit."""
    cfg, mods, opts = _attention_steps(name, "Adam")
    path = str(tmp_path / "port")
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts,
                    fmt="orbax")
    wait_for_checkpoints()
    kw = _attn_kw(name, optim_type="Adam")
    template, topts = _jax_templates(kw, max_words=4)
    data, params, jopts = jax_checkpoint.load_checkpoint(path, template,
                                                         topts)
    assert data == {"step": 2, "best_dev_acc": 0.5}
    _assert_jax_state_is_ports(params, jopts, mods, opts, "Adam", 2)

    rng = np.random.RandomState(9)
    jopts = jax.tree_util.tree_map(
        lambda x: (rng.randn(*x.shape).astype(np.float32)
                   if np.issubdtype(x.dtype, np.floating)
                   else np.asarray(4, x.dtype)), topts)
    theirs = str(tmp_path / "jax")
    jax_checkpoint.save_checkpoint(theirs, {"step": 4, "best_dev_acc": 0.0},
                                   template, jopts, fmt="orbax")
    jax_checkpoint.wait_for_checkpoints()
    port = AgentModules(cfg)
    port_opts = init_opt_states(cfg, port)
    assert load_checkpoint(theirs, port, port_opts)["step"] == 4
    _assert_jax_state_is_ports(template, jopts, port, port_opts, "Adam", 4)


# ------------------------------------------------------ malformed input

def _rewrite_store(path, edit):
    """Apply ``edit`` to the directory's OCDBT items and write them back
    as a new store."""
    items = ocdbt.read_store(path)
    edit(items)
    os.remove(os.path.join(path, ocdbt.MANIFEST))
    shutil.rmtree(os.path.join(path, "d"))
    shutil.rmtree(os.path.join(path, "ocdbt.process_0"), ignore_errors=True)
    ocdbt.write_store(path, items)


def _set_dtype(items, name, dtype):
    key = f"{name}/.zarray".encode()
    meta = json.loads(items[key])
    meta["dtype"] = dtype
    items[key] = json.dumps(meta).encode()


def _cut_chunk(items, key):
    items[key] = items[key][:len(items[key]) // 2]


def _retree(path, edit):
    tree = orbax.read_orbax(path)
    edit(tree)
    shutil.rmtree(path)
    orbax.write_orbax(path, tree)


def _manifest_gone(path):
    os.remove(os.path.join(path, ocdbt.MANIFEST))


def _node_cut(path):
    d = os.path.join(path, "d")
    node = os.path.join(d, os.listdir(d)[0])
    with open(node, "rb") as f:
        data = f.read()
    with open(node, "wb") as f:
        f.write(data[:-3])


KERNEL = "models.sender.image_layer.kernel"
MALFORMED = {
    "no_metadata": (lambda p: os.remove(os.path.join(p, orbax.METADATA)),
                    "_METADATA: No such file"),
    "no_manifest": (_manifest_gone, "manifest.ocdbt"),
    "node_truncated": (_node_cut, "runs past"),
    "chunk_truncated": (lambda p: _rewrite_store(p, lambda i: _cut_chunk(
        i, f"{KERNEL}/0.0".encode())), f"array {KERNEL}: chunk 0.0"),
    "chunk_missing": (lambda p: _rewrite_store(p, lambda i: i.pop(
        f"{KERNEL}/0.0".encode())), "chunk 0.0 is missing"),
    "dtype_bfloat16": (lambda p: _rewrite_store(p, lambda i: _set_dtype(
        i, KERNEL, "bfloat16")), "dtype 'bfloat16'"),
    "dtype_complex": (lambda p: _rewrite_store(p, lambda i: _set_dtype(
        i, KERNEL, "<c8")), "not a number type"),
    "missing_key": (lambda p: _retree(p, lambda t: t["models"]["sender"].pop(
        "code_bias")), r"models/sender lacks \['code_bias'\]"),
    "extra_key": (lambda p: _retree(p, lambda t: t["optimizers"]["receiver"][
        "1"].update({"3": {}})), r"has extra \['3'\]"),
    "shape": (lambda p: _retree(p, lambda t: t["models"]["receiver"][
        "w"].update(kernel=np.zeros((3, 3), np.float32))),
        "models/receiver/w/kernel is float32 \\(3, 3\\)"),
    "a_file_is_no_directory": (None, "is a msgpack checkpoint file but"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_directories_raise_naming_the_path(tmp_path, case):
    edit, match = MALFORMED[case]
    _, mods, opts = _port_steps("Adam")
    path = str(tmp_path / case)
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts,
                    fmt="orbax")
    wait_for_checkpoints()
    if edit is None:       # a save in the other format refuses the path
        shutil.rmtree(path)
        save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts)
        with pytest.raises(ValueError, match=match) as err:
            save_checkpoint(path, {"step": 3, "best_dev_acc": 0.5}, mods,
                            opts, fmt="orbax")
        assert path in str(err.value)
        return
    edit(path)
    fresh = init_params(AgentModules(mods.cfg), seed=5)
    fresh_opts = init_opt_states(fresh.cfg, fresh)
    before = [p.clone() for p in fresh.parameters()]
    with pytest.raises(ValueError, match=match) as err:
        load_checkpoint(path, fresh, fresh_opts)
    assert path in str(err.value)
    assert all(torch.equal(p, q) for p, q in zip(fresh.parameters(),
                                                 before))


# ----------------------------------------------- the asynchronous write

class _HeldWriter:
    """``write_orbax`` held until :meth:`release`, so a test acts while a
    save is in flight."""

    def __init__(self, monkeypatch):
        self.go, self.started = threading.Event(), threading.Event()
        write = port_checkpoint.write_orbax

        def held(path, tree):
            self.started.set()
            assert self.go.wait(60)
            write(path, tree)
        monkeypatch.setattr(port_checkpoint, "write_orbax", held)

    def release(self):
        self.go.set()


def test_save_returns_before_the_commit(tmp_path, monkeypatch):
    _, mods, opts = _port_steps("Adam")
    path = str(tmp_path / "ckpt")
    held = _HeldWriter(monkeypatch)
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts,
                    fmt="orbax")
    assert held.started.wait(60)
    assert not os.path.exists(path)
    assert not os.path.exists(path + ".staging")
    held.release()
    wait_for_checkpoints()
    assert os.path.isdir(path) and not os.path.exists(path + ".staging")
    assert read_checkpoint(path)["data"]["step"] == 2


@pytest.mark.parametrize("optim", ["RMSprop", "Adam"])
def test_graph_step_after_a_save_leaves_the_snapshot(tmp_path, monkeypatch,
                                                     optim):
    """The snapshot is a finished host copy: a ``graph=True`` step (the
    body a CUDA graph captures, which updates the weights and slots in
    place) run while the write is in flight does not reach the
    checkpoint."""
    cfg = GameConfig(**BASE, optim_type=optim)
    mods = init_params(AgentModules(cfg), seed=2)
    chunk = make_multistep_train_step_indexed(mods, TOP_K, BATCH,
                                              fast="kernel", device="cpu",
                                              graph=True)
    opts = init_opt_states(cfg, mods)
    feats, targets, desc, idx = _data()
    args = (torch.tensor(feats, dtype=torch.float32), torch.tensor(targets))
    chunk(opts, *args, idx[:2], torch.tensor(desc, dtype=torch.float32))
    want = {k: v.clone() for k, v in mods.state_dict().items()}
    want_nu = [t.clone() for t in opts["sender"]["nu"]]
    held = _HeldWriter(monkeypatch)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.5}, mods, opts,
                    fmt="orbax")
    assert held.started.wait(60)
    chunk(opts, *args, idx[2:4], torch.tensor(desc, dtype=torch.float32),
          2)
    moved = [k for k, v in mods.state_dict().items()
             if not torch.equal(v, want[k])]
    assert moved
    held.release()
    back = AgentModules(cfg)
    back_opts = init_opt_states(cfg, back)
    assert load_checkpoint(path, back, back_opts)["step"] == 2
    for k, v in back.state_dict().items():
        assert torch.equal(v, want[k]), k
    for x, y in zip(back_opts["sender"]["nu"], want_nu):
        assert torch.equal(x, y)


def test_failed_write_keeps_the_previous_directory(tmp_path, monkeypatch):
    """A background write that fails part way raises at the next
    synchronization point and leaves the previous directory whole."""
    _, mods, opts = _port_steps("Adam")
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"step": 1, "best_dev_acc": 0.0}, mods, opts,
                    fmt="orbax")
    wait_for_checkpoints()

    def broken(staging, tree):
        os.makedirs(staging + orbax.TMP_INFIX + "1")
        raise OSError("disk full")
    monkeypatch.setattr(port_checkpoint, "write_orbax", broken)
    save_checkpoint(path, {"step": 2, "best_dev_acc": 0.0}, mods, opts,
                    fmt="orbax")
    with pytest.raises(OSError, match="disk full"):
        wait_for_checkpoints()
    monkeypatch.undo()
    wait_for_checkpoints()            # nothing left in flight
    fresh = init_params(AgentModules(mods.cfg), seed=5)
    assert load_checkpoint(path, fresh, init_opt_states(
        fresh.cfg, fresh))["step"] == 1
    assert torch.equal(fresh.sender.code_bias, mods.sender.code_bias)
    assert not os.path.exists(path + ".staging")
    # The next save sweeps the partial write.
    save_checkpoint(path, {"step": 3, "best_dev_acc": 0.0}, mods, opts,
                    fmt="orbax")
    wait_for_checkpoints()
    assert os.listdir(tmp_path) == ["ckpt"]
    assert read_checkpoint(path)["data"]["step"] == 3


def _save(path, mods, opts, step):
    save_checkpoint(path, {"step": step, "best_dev_acc": 0.0}, mods, opts,
                    fmt="orbax")


def _step(path, mods, opts):
    return load_checkpoint(path, mods, opts)["step"]


def _commit_without_swap():
    """Wait for the write in flight, then drop the swap: the process
    died after the commit."""
    pending = port_checkpoint._WRITER._pending
    for future, _, _ in pending:
        future.result()
    pending.clear()


def test_recover_orbax_repairs_every_crash_window(tmp_path):
    """JAX's tests/test_checkpoint.py:141 on the port: a loadable
    checkpoint holding the newest committed state survives a death at
    every stage of the staging protocol."""
    _, mods, opts = _port_steps("SGD")
    path = str(tmp_path / "ckpt.orbax")
    _save(path, mods, opts, 1)
    wait_for_checkpoints()
    assert _step(path, mods, opts) == 1
    # A: a partial write (Orbax's tmp sibling of the staging directory);
    # the checkpoint is intact and the next save sweeps the garbage.
    trash = path + ".staging" + orbax.TMP_INFIX + "12345"
    os.makedirs(trash)
    assert _step(path, mods, opts) == 1
    _save(path, mods, opts, 2)
    assert not os.path.exists(trash)
    wait_for_checkpoints()
    assert _step(path, mods, opts) == 2
    # B: the staging directory committed, the swap never ran.
    _save(path, mods, opts, 3)
    _commit_without_swap()
    assert os.path.isdir(path + ".staging")
    assert _step(path, mods, opts) == 3
    assert not os.path.exists(path + ".staging")
    # C: between the swap's renames: nothing at the path. train.run
    # repairs before its resume decision.
    _save(path, mods, opts, 4)
    _commit_without_swap()
    os.rename(path, path + ".old")
    assert not os.path.exists(path)
    recover_orbax(path)
    assert _step(path, mods, opts) == 4
    assert not os.path.exists(path + ".old")
    assert not os.path.exists(path + ".staging")
    # D: after the swap, before the .old removal.
    shutil.copytree(path, path + ".old")
    assert _step(path, mods, opts) == 4
    assert not os.path.exists(path + ".old")
    # E: a lone .old with nothing at the path is restored.
    os.rename(path, path + ".old")
    assert _step(path, mods, opts) == 4
    assert os.path.isdir(path) and not os.path.exists(path + ".old")


def test_train_run_recovers_before_its_resume_decision(synthetic_dataset,
                                                       tmp_path):
    """A run whose previous process died between the swap's renames
    (nothing at ``-checkpoint``, the new state in ``.staging``) resumes
    from it, logs JAX's adoption line, and writes Orbax."""
    argv = small_argv(synthetic_dataset, tmp_path, "rec", ["-max_epoch",
                                                           "1"])
    flags = port_flags(argv)
    cfg = GameConfig.from_flags(flags)
    mods = init_params(AgentModules(cfg), seed=1)
    opts = init_opt_states(cfg, mods)
    save_checkpoint(flags.checkpoint + ".staging",
                    {"step": 3, "best_dev_acc": 0.25}, mods, opts,
                    fmt="orbax")
    wait_for_checkpoints()
    run(flags, device="cpu")
    log = open(flags.log_file).read()
    assert "Loaded at step: 3 and best dev acc: 0.25" in log
    assert ("Checkpoint is an orbax directory; using -ckpt_format orbax "
            "for this run") in log
    assert checkpoint_format(flags.checkpoint) == "orbax"
    assert read_checkpoint(flags.checkpoint)["data"]["step"] == 8


# ------------------------------------------------------ a mesh, a grid

@pytest.mark.parametrize("grid", [["-mesh", "2"],
                                  ["-mesh", "2", "-mesh_model", "2"]],
                         ids=["mesh", "grid_1x2"])
def test_mesh_and_grid_write_orbax_that_jax_restores(synthetic_dataset,
                                                     tmp_path, grid):
    flags = port_flags(small_argv(synthetic_dataset, tmp_path, "m",
                                  grid + ["-ckpt_format", "orbax"]))
    out = run(flags, max_steps=8, device="cpu")
    assert out["step"] == 8
    jf = jax_flags(small_argv({"descr": "", "train": "", "dev": "",
                               "glove": ""}, tmp_path / "jax", "jax"))
    jmods = JaxModules(JaxConfig.from_flags(jf))
    for suffix in ("", "_best"):
        path = flags.checkpoint + suffix
        assert checkpoint_format(path) == "orbax"
        assert not os.path.exists(path + ".staging")
        template = jax_init_params(jmods, jax.random.PRNGKey(0),
                                   num_classes=6)
        data, params, jopts = jax_checkpoint.load_checkpoint(
            path, template, jax_init_opt_states(jmods.cfg, template))
        got = read_checkpoint(path)
        assert data == got["data"]
        mods = AgentModules(GameConfig.from_flags(flags))
        mods_opts = init_opt_states(mods.cfg, mods)
        load_checkpoint(path, mods, mods_opts)
        _assert_jax_state_is_ports(params, jopts, mods, mods_opts,
                                   flags.optim_type, int(data["step"]))
    # The periodic directory holds step 4's state, as the msgpack
    # file of a single-device run does (tests/test_torch_mesh_driver.py).
    assert read_checkpoint(flags.checkpoint)["data"]["step"] == 4


if __name__ == "__main__":
    if os.path.exists(FIXTURE):
        shutil.rmtree(FIXTURE)
    write_fixture(FIXTURE)
    print(FIXTURE, sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(FIXTURE) for f in fs), "bytes")
