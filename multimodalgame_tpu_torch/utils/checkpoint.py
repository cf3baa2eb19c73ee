"""Checkpoint and resume for the training driver.

The port of ``multimodalgame_tpu/utils/checkpoint.py``. A checkpoint is
``{data: {step, best_dev_acc}, models: {4 agents}, optimizers: {4
agents}}`` (the reference's misc.py:58-92), written to ``-checkpoint``
(periodic) and ``-checkpoint`` + ``"_best"`` on dev improvement
(model.py:1569-1584), and read back on resume (model.py:1149-1156). Two
file formats:

* ``msgpack`` (``-ckpt_format msgpack``, the default) — the JAX
  package's file: flax's msgpack encoding (``utils/msgpack.py``) of the
  flax state dicts of its parameter trees and optax states
  (``utils/torch_interop.py:models_tree``/``optimizers_tree``), ``data``
  as 0-d arrays (``step`` int64, accuracies float64). The JAX package's
  ``load_checkpoint`` restores it;
* ``pt`` — the reference's torch zip with torch optimizer
  ``state_dict``s (``utils/torch_interop.py:save_reference_checkpoint``),
  which the port wrote under ``-ckpt_format msgpack`` before it had a
  msgpack writer. A run resumed from one keeps writing it.

A file's format is read from its content, not its name
(:func:`checkpoint_format`): a torch zip is a ``.pt``, any other file
msgpack. A directory is an Orbax checkpoint, which the port does not read
(``-ckpt_format orbax`` raises too). Reading is strict, as flax's
``from_state_dict`` is and more: a malformed file, a missing or extra
key, or a leaf whose shape is not the config's raises ``ValueError``
naming the path, and neither format falls back to the other.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.utils import msgpack
from multimodalgame_tpu_torch.utils.torch_interop import (
    host_leaf, load_opt_states, load_torch_state, models_tree,
    optimizers_tree, read_reference_checkpoint, save_reference_checkpoint,
    shape_leaf, torch_payload)

ORBAX_NOT_PORTED = (
    "-ckpt_format orbax is not ported to PyTorch (Orbax needs orbax and "
    "tensorstore); the port writes the JAX package's msgpack file")


def checkpoint_format(path: str) -> str:
    """``"pt"`` for a torch zip, ``"msgpack"`` for another file; a
    directory (an Orbax checkpoint) raises ``ValueError``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an Orbax checkpoint: the port reads "
            "the JAX package's msgpack files and the reference's .pt, not "
            "Orbax")
    return "pt" if zipfile.is_zipfile(path) else "msgpack"


def save_checkpoint(filename: str, data: Dict[str, Any],
                    modules: AgentModules, opt_states: Dict[str, Any],
                    mesh=None, tp=None, fmt: str = "msgpack") -> None:
    """Write ``{data, models, optimizers}`` to ``filename`` in ``fmt``
    (``msgpack`` or ``pt``), by a temporary file and a rename, so a crash
    never leaves a truncated checkpoint. (``train.check_supported``
    refuses ``-ckpt_format orbax`` before a run starts.) On a
    data-parallel ``mesh`` (whose ranks hold equal parameters) rank 0
    writes, and every rank waits for the write, so none reads a
    half-written file. Under tensor parallelism (``tp``, ``modules`` its
    whole agents) the file is the single-device layout: every rank
    gathers the sharded optimizer slots over the model axis first."""
    if fmt not in ("msgpack", "pt"):
        raise ValueError(f"unknown checkpoint format: {fmt!r}")
    if tp is not None:
        opt_states = tp.full_opt_states(opt_states)
    if mesh is None or mesh.writer:
        if fmt == "pt":
            save_reference_checkpoint(filename, data, modules, opt_states,
                                      modules.cfg.optim_type)
        else:
            blob = msgpack.packb({
                "data": {k: np.asarray(v) for k, v in data.items()},
                "models": models_tree(modules, host_leaf),
                "optimizers": optimizers_tree(modules, opt_states,
                                              host_leaf)})
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
    """The file's payload in the ``.pt`` layout; a msgpack file is checked
    against ``modules`` and ``opt_states``, where given, first."""
    if checkpoint_format(path) == "pt":
        return read_reference_checkpoint(path)
    tree = _read_msgpack(path)
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
    either format, in the ``.pt`` layout (torch-layout state dicts and
    torch optimizer ``state_dict``s of CPU tensors, ``data`` as Python
    scalars)."""
    return _payload(path)


def load_checkpoint(filename: str, modules: AgentModules,
                    opt_states: Dict[str, Any]) -> Dict[str, Any]:
    """Restore the agents' weights and the optimizer slots from
    ``filename``, of either format, in place (reference misc.py:78-92);
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
    ``path``, of either format (serving: the optimizer slots are not
    read); returns ``(data, modules)``, the modules on ``device`` when
    given."""
    modules = AgentModules(cfg)
    payload = _payload(path, modules)
    load_torch_state(modules, payload["models"])
    if device is not None:
        modules.to(device)
    return dict(payload["data"]), modules
