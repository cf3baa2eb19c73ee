"""Checkpoint and resume for the training driver.

The port of ``multimodalgame_tpu/utils/checkpoint.py``. A checkpoint is
``{data: {step, best_dev_acc}, models: {4 agents}, optimizers: {4
agents}}`` (the reference's misc.py:58-92), written to ``-checkpoint``
(periodic) and ``-checkpoint`` + ``"_best"`` on dev improvement
(model.py:1569-1584), and read back on resume (model.py:1149-1156). Three
formats:

* ``msgpack`` (``-ckpt_format msgpack``, the default) — the JAX
  package's file: flax's msgpack encoding (``utils/msgpack.py``) of the
  flax state dicts of its parameter trees and optax states
  (``utils/torch_interop.py:models_tree``/``optimizers_tree``), ``data``
  as 0-d arrays (``step`` int64, accuracies float64), written by a
  temporary file and a rename;
* ``orbax`` (``-ckpt_format orbax``) — the JAX package's Orbax checkpoint
  directory of the same tree (``utils/orbax.py``: zarr v2 arrays in an
  OCDBT store, zstd-compressed), written asynchronously as JAX's
  ``AsyncCheckpointer`` writes it: :func:`save_checkpoint` returns once
  the tree is a finished host copy, and one background thread encodes
  and writes it into ``<path>.staging`` (through a temporary sibling
  renamed when complete). The staging directory replaces ``<path>`` at
  the next synchronization point, :func:`wait_for_checkpoints`, which
  runs before every save and load, at the end of the driver, the sweep
  and ``train.run``, and at exit; so the previous checkpoint survives a
  crash at any point, and :func:`recover_orbax` repairs what a crash
  leaves;
* ``pt`` — the reference's torch zip with torch optimizer
  ``state_dict``s (``utils/torch_interop.py:save_reference_checkpoint``),
  which the port wrote under ``-ckpt_format msgpack`` before it had a
  msgpack writer. A run resumed from one keeps writing it.

A checkpoint's format is read from what is at the path, not its name
(:func:`checkpoint_format`): a directory is Orbax, a torch zip a ``.pt``,
any other file msgpack; writing a file where a directory is, or the
reverse, raises JAX's error. Reading is strict, as flax's
``from_state_dict`` is and more: a malformed file or directory (a
truncated zstd frame or OCDBT node among them), a missing or extra key, a
dtype the port cannot map, or a leaf whose shape is not the config's
raises ``ValueError`` naming the path, before any weight changes, and no
format falls back to another.
"""

from __future__ import annotations

import atexit
import glob
import os
import shutil
import threading
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.utils import msgpack
from multimodalgame_tpu_torch.utils.orbax import (TMP_INFIX, read_orbax,
                                                  write_orbax)
from multimodalgame_tpu_torch.utils.profiling import span
from multimodalgame_tpu_torch.utils.torch_interop import (
    host_leaf, load_opt_states, load_torch_state, models_tree,
    optimizers_tree, read_reference_checkpoint, save_reference_checkpoint,
    shape_leaf, torch_payload)

FORMATS = ("msgpack", "orbax", "pt")


def checkpoint_format(path: str) -> str:
    """``"orbax"`` for a directory, ``"pt"`` for a torch zip,
    ``"msgpack"`` for another file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path):
        return "orbax"
    return "pt" if zipfile.is_zipfile(path) else "msgpack"


def snapshot_leaf(t: torch.Tensor) -> np.ndarray:
    """A finished host copy of ``t``: never a view of a tensor that a
    later step (or a CUDA graph's replay) writes in place. The copy from a
    card is synchronous."""
    return t.detach().to("cpu", copy=True).numpy()


def checkpoint_tree(data: Dict[str, Any], modules: AgentModules,
                    opt_states: Dict[str, Any], leaf=host_leaf
                    ) -> Dict[str, Any]:
    """The JAX package's ``{data, models, optimizers}`` tree."""
    return {"data": {k: np.asarray(v) for k, v in data.items()},
            "models": models_tree(modules, leaf),
            "optimizers": optimizers_tree(modules, opt_states, leaf)}


class AsyncOrbaxWriter:
    """Orbax directories written on one background thread, each swapped
    into its path at the next :meth:`wait` (JAX's ``AsyncCheckpointer``
    with its staging swap, utils/checkpoint.py:173-292)."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Tuple[Future, str, str]] = []
        self._lock = threading.Lock()

    def save(self, filename: str, tree: Dict[str, Any]) -> None:
        """Start writing ``tree`` (finished host arrays) for ``filename``
        and return."""
        self.wait()   # one in flight; its staging is swapped away first
        final = os.path.abspath(filename)
        staging = final + ".staging"
        if os.path.exists(staging):      # left by a crashed, unresumed run
            shutil.rmtree(staging)
        for tmp in glob.glob(glob.escape(staging) + TMP_INFIX + "*"):
            shutil.rmtree(tmp, ignore_errors=True)
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    1, thread_name_prefix="orbax-checkpoint")
                atexit.register(self.wait)
            self._pending.append(
                (self._pool.submit(write_orbax, staging, tree), staging,
                 final))

    def wait(self) -> None:
        """Block until every write started has committed, then swap each
        staging directory into its path (the previous checkpoint is
        replaced only after its successor is complete). A write that
        failed raises here."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                future, staging, final = self._pending.pop(0)
            future.result()
            _swap(staging, final)


def _swap(staging: str, final: str) -> None:
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(staging, final)
    if os.path.exists(old):
        shutil.rmtree(old)


_WRITER = AsyncOrbaxWriter()


def wait_for_checkpoints() -> None:
    """Commit every Orbax save in flight and swap it into place (a no-op
    when none was started)."""
    _WRITER.wait()


def recover_orbax(dirname: str) -> None:
    """Repair what a process that died inside the staging protocol left,
    so a loadable checkpoint survives every crash window (JAX
    utils/checkpoint.py:220-267):

    * during the write: the temporary sibling never became ``.staging``
      and the previous checkpoint is untouched; the next save sweeps it;
    * after the commit, before the swap: ``.staging`` is complete and
      newer than the path, so the swap is finished here;
    * between the swap's two renames: the path is missing and
      ``.staging`` present; the same branch finishes the swap;
    * after the swap, before ``.old`` is removed: the stale ``.old`` goes.

    A lone ``.old`` with nothing at the path is restored. Idempotent, a
    few ``stat`` calls when nothing crashed. Called by the loaders and by
    ``train.run`` before its resume decision (the mid-swap window leaves
    nothing at the path, so a resume gated on ``exists()`` would start
    over and the next save would sweep the only complete copy)."""
    final = os.path.abspath(os.path.expanduser(dirname))
    staging, old = final + ".staging", final + ".old"
    if os.path.isdir(staging):
        _swap(staging, final)
    if os.path.isdir(old):
        if os.path.exists(final):
            shutil.rmtree(old)
        else:
            os.rename(old, final)


def save_checkpoint(filename: str, data: Dict[str, Any],
                    modules: AgentModules, opt_states: Dict[str, Any],
                    mesh=None, tp=None, fmt: str = "msgpack") -> None:
    """Write ``{data, models, optimizers}`` to ``filename`` in ``fmt``.
    ``msgpack`` and ``pt`` go by a temporary file and a rename, so a crash
    never leaves a truncated checkpoint; ``orbax`` returns once the tree
    is a finished host copy and commits on the background writer (see
    the module's notes). Writing a file where a directory is, or the
    reverse, raises ``ValueError`` (JAX utils/checkpoint.py:118-135). On
    a data-parallel ``mesh`` (whose ranks hold equal parameters) rank 0
    writes, an Orbax directory to its commit, and every rank waits for
    the write, so none reads a half-written checkpoint. Under tensor
    parallelism (``tp``, ``modules`` its whole agents) the checkpoint is
    the single-device layout: every rank gathers the sharded optimizer
    slots over the model axis first.

    The writer's work runs in two spans (``utils/profiling.py:span``):
    ``mmg.checkpoint.snapshot``, the leaves' copies to the host, and
    ``mmg.checkpoint.write``, the encoding and the file's write and
    rename, or the Orbax hand-off and, on a mesh, its wait (a ``.pt``
    file is written in the second alone)."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown checkpoint format: {fmt!r}")
    if tp is not None:
        opt_states = tp.full_opt_states(opt_states)
    if mesh is None or mesh.writer:
        wait_for_checkpoints()
        if fmt == "orbax":
            if os.path.isfile(filename):
                raise ValueError(
                    f"{filename} is a msgpack checkpoint file but "
                    "-ckpt_format orbax was requested; pass -ckpt_format "
                    "msgpack (the resumed run's format) or remove the file")
            with span("checkpoint.snapshot"):
                tree = checkpoint_tree(data, modules, opt_states,
                                       snapshot_leaf)
            with span("checkpoint.write"):
                _WRITER.save(filename, tree)
                if mesh is not None:
                    wait_for_checkpoints()
        else:
            if os.path.isdir(filename):
                raise ValueError(
                    f"{filename} is an orbax checkpoint directory but the "
                    f"{fmt} format was requested; pass -ckpt_format orbax "
                    "(the resumed run's format) or remove the directory")
            if fmt == "pt":
                with span("checkpoint.write"):
                    save_reference_checkpoint(filename, data, modules,
                                              opt_states,
                                              modules.cfg.optim_type)
            else:
                with span("checkpoint.snapshot"):
                    tree = checkpoint_tree(data, modules, opt_states)
                with span("checkpoint.write"):
                    blob = msgpack.packb(tree)
                    tmp = filename + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, filename)
    if mesh is not None:
        # Data axis, then model axis: each model peer of a rank waits for
        # a rank that waited for the writer.
        mesh.barrier()
        if mesh.model is not None:
            mesh.model.barrier()


def _read_msgpack(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        blob = f.read()
    try:
        tree = msgpack.unpackb(blob)
    except msgpack.MsgpackError as e:
        raise ValueError(f"{path} is not a readable msgpack checkpoint: "
                         f"{e}") from None
    if not isinstance(tree, dict) or not isinstance(tree.get("data"), dict):
        raise ValueError(f"{path} holds no {{data, models, optimizers}} "
                         "checkpoint map")
    return tree


def _check_like(got, want, path: str, where: str) -> None:
    """``got`` (a file's tree) has exactly ``want``'s keys, and arrays of
    its shapes and kind (floating, or integer for Adam's count)."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"{path}: {where} is a {type(got).__name__}, "
                             "not a map")
        missing, extra = want.keys() - got.keys(), got.keys() - want.keys()
        if missing or extra:
            raise ValueError(
                f"{path}: {where} lacks {sorted(missing)} and has extra "
                f"{sorted(map(str, extra))}: not a checkpoint of this "
                "config")
        for k, v in want.items():
            _check_like(got[k], v, path, f"{where}/{k}")
    elif (not isinstance(got, np.ndarray) or got.shape != want.shape
          or (got.dtype.kind == "f") != (want.dtype.kind == "f")
          or got.dtype.kind not in "fiu"):
        found = (f"{got.dtype} {got.shape}" if isinstance(got, np.ndarray)
                 else type(got).__name__)
        raise ValueError(f"{path}: {where} is {found}; this config's is "
                         f"{want.dtype} {want.shape}")


def _payload(path: str, modules: Optional[AgentModules] = None,
             opt_states: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The checkpoint's payload in the ``.pt`` layout; a msgpack file or an
    Orbax directory is checked against ``modules`` and ``opt_states``,
    where given, first."""
    wait_for_checkpoints()   # a save just started must commit first
    recover_orbax(path)      # and a crash-interrupted swap be finished
    fmt = checkpoint_format(path)
    if fmt == "pt":
        return read_reference_checkpoint(path)
    tree = read_orbax(path) if fmt == "orbax" else _read_msgpack(path)
    if modules is not None:
        _check_like(tree.get("models"), models_tree(modules, shape_leaf),
                    path, "models")
    if opt_states is not None:
        _check_like(tree.get("optimizers"),
                    optimizers_tree(modules, opt_states, shape_leaf), path,
                    "optimizers")
    try:
        return torch_payload(tree)
    except (KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"{path} is not a checkpoint of the JAX package's "
                         f"layout: {e!r}") from None


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The payload ``{data, models, optimizers}`` of a checkpoint of
    any format, in the ``.pt`` layout (torch-layout state dicts and
    torch optimizer ``state_dict``s of CPU tensors, ``data`` as Python
    scalars)."""
    return _payload(path)


def load_checkpoint(filename: str, modules: AgentModules,
                    opt_states: Dict[str, Any]) -> Dict[str, Any]:
    """Restore the agents' weights and the optimizer slots from
    ``filename``, of any format, in place (reference misc.py:78-92);
    returns the file's ``data`` dict."""
    payload = _payload(filename, modules, opt_states)
    load_torch_state(modules, payload["models"])
    load_opt_states(payload.get("optimizers") or {}, opt_states,
                    modules.cfg.optim_type)
    return dict(payload["data"])


def load_agents(path: str, cfg: GameConfig,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[Dict[str, Any], AgentModules]:
    """New agents for ``cfg`` with the weights of the checkpoint at
    ``path``, of any format (serving: the optimizer slots are not
    read); returns ``(data, modules)``, the modules on ``device`` when
    given."""
    modules = AgentModules(cfg)
    payload = _payload(path, modules)
    load_torch_state(modules, payload["models"])
    if device is not None:
        modules.to(device)
    return dict(payload["data"]), modules
