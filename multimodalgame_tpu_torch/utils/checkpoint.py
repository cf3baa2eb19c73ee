"""Checkpoint and resume for the training driver.

The port of ``multimodalgame_tpu/utils/checkpoint.py``. A checkpoint is
the reference's single-file torch checkpoint (misc.py:58-92):
``{data: {step, best_dev_acc}, models: {4 state_dicts}, optimizers:
{4 state_dicts}}``, written to ``-checkpoint`` (periodic) and
``-checkpoint`` + ``"_best"`` on dev improvement (model.py:1569-1584),
and read back on resume (model.py:1149-1156).

``-ckpt_format msgpack``, the flag's default, writes this ``.pt``: the
port has no msgpack writer, and the ``.pt`` is the reference's own
single-file format, which the JAX package reads with
``utils/torch_interop.py:load_reference_checkpoint``. ``orbax`` raises.
A JAX msgpack file or Orbax directory at the path raises the clear
``ValueError`` of :func:`read_reference_checkpoint`.
"""

from __future__ import annotations

from typing import Any, Dict

from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_opt_states, load_torch_state, read_reference_checkpoint,
    save_reference_checkpoint)

ORBAX_NOT_PORTED = (
    "-ckpt_format orbax is not ported to PyTorch: the port writes the "
    "reference's .pt under -ckpt_format msgpack")


def save_checkpoint(filename: str, data: Dict[str, Any],
                    modules: AgentModules, opt_states: Dict[str, Any],
                    mesh=None, tp=None) -> None:
    """Write ``{data, models, optimizers}`` to ``filename`` as a
    reference-layout ``.pt``, by a temporary file and a rename.
    (``train.check_supported`` refuses ``-ckpt_format orbax`` before a
    run starts.) On a data-parallel ``mesh`` (whose ranks hold equal
    parameters) rank 0 writes, and every rank waits for the write, so
    none reads a half-written file. Under tensor parallelism (``tp``,
    ``modules`` its whole agents) the file is the single-device layout:
    every rank gathers the sharded optimizer slots over the model axis
    first."""
    if tp is not None:
        opt_states = tp.full_opt_states(opt_states)
    if mesh is None or mesh.writer:
        save_reference_checkpoint(filename, data, modules, opt_states,
                                  modules.cfg.optim_type)
    if mesh is not None:
        # Data axis, then model axis: each model peer of a rank waits for
        # a rank that waited for the writer.
        mesh.barrier()
        if mesh.model is not None:
            mesh.model.barrier()


def load_checkpoint(filename: str, modules: AgentModules,
                    opt_states: Dict[str, Any]) -> Dict[str, Any]:
    """Restore the agents' weights and the optimizer slots from
    ``filename`` in place (reference misc.py:78-92); returns the file's
    ``data`` dict."""
    payload = read_reference_checkpoint(filename)
    load_torch_state(modules, payload["models"])
    load_opt_states(payload.get("optimizers") or {}, opt_states,
                    modules.cfg.optim_type)
    return dict(payload["data"])
