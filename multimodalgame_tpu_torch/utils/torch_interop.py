"""The reference's ``.pt`` checkpoint layout, and the weight carry from the
JAX package's parameter trees.

The reference checkpoints four torch ``state_dict``s plus metadata into
one ``.pt`` file (misc.py:58-92): ``{"data", "models", "optimizers"}``.
The port's modules use the reference's parameter names, so its four
agents load those state dicts with ``strict=True``.

* :func:`params_to_torch_state` — the JAX package's parameter trees (any
  arrays numpy can read) to torch-layout numpy state dicts: a Linear
  ``weight`` is the transpose of a flax ``kernel``, GRU matrices are the
  transposed ``[r|z|n]`` stacks, ``y1`` is the reference's single matrix.
* :func:`load_reference_checkpoint` / :func:`save_reference_checkpoint` —
  read and write ``.pt`` files with the weights of all four agents. The
  optimizer entries are written empty; their slots are not carried yet.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.game.agents import AGENT_NAMES, AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig

_DENSE_KEYS = {
    "sender": ["image_layer", "code_layer", "binary_layer", "attn_W_x",
               "attn_W_w", "attn_U", "attn_W_g"],
    "receiver": ["w_h", "w_d", "w", "y2", "s", "d_d", "d_h", "d_attn"],
    "baseline_sen": ["linear1", "linear2"],
    "baseline_rec": ["linear1", "linear2"],
}

# Agents a checkpoint must hold: serving needs no baselines, so a file
# without them loads too (names as in the file, model.py:1141-1142).
REQUIRED_AGENTS = ("sender", "receiver")


def params_to_torch_state(params: Dict[str, Any]) -> Dict[str, Dict]:
    """The JAX package's four parameter trees -> torch-layout state dicts
    of numpy arrays."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for agent, tree in params.items():
        sd: Dict[str, np.ndarray] = {}
        for name in _DENSE_KEYS.get(agent, []):
            if name not in tree:
                continue
            sd[name + ".weight"] = np.asarray(tree[name]["kernel"]).T
            if "bias" in tree[name]:
                sd[name + ".bias"] = np.asarray(tree[name]["bias"])
        if agent == "sender":
            sd["code_bias"] = np.asarray(tree["code_bias"])
            if "code_bias_mou" in tree:
                sd["code_bias_mou"] = np.asarray(tree["code_bias_mou"])
        if agent == "receiver":
            sd["rnn.weight_ih"] = np.asarray(tree["rnn"]["w_ih"]).T
            sd["rnn.weight_hh"] = np.asarray(tree["rnn"]["w_hh"]).T
            sd["rnn.bias_ih"] = np.asarray(tree["rnn"]["b_ih"])
            sd["rnn.bias_hh"] = np.asarray(tree["rnn"]["b_hh"])
            sd["y1.weight"] = np.asarray(tree["y1_kernel"]).T
            sd["y1.bias"] = np.asarray(tree["y1_bias"])
        out[agent] = sd
    return out


def load_torch_state(modules: AgentModules,
                     state: Dict[str, Dict[str, Any]]) -> AgentModules:
    """Load torch-layout state dicts (numpy arrays or tensors) into the
    agents, each strictly. The Sender and Receiver must be in ``state``;
    a baseline that is absent keeps its weights."""
    for agent in AGENT_NAMES:
        if agent not in state:
            if agent in REQUIRED_AGENTS:
                raise KeyError(f"no {agent!r} weights in the state")
            continue
        getattr(modules, agent).load_state_dict(
            {k: v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in state[agent].items()}, strict=True)
    return modules


def load_reference_checkpoint(
        path: str, cfg: GameConfig,
        device: Optional[Union[str, torch.device]] = None
) -> Tuple[Dict[str, Any], AgentModules]:
    """Read a reference-layout ``.pt`` into new agents for ``cfg``.
    Returns ``(data, modules)``: the file's metadata dict and the agents,
    on ``device`` when given.

    Only torch's zip format is read. The JAX package's own checkpoints
    (msgpack files, Orbax directories) raise ``ValueError``: convert them
    with that package's ``save_reference_checkpoint`` first.
    """
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a reference-layout .pt (torch zip) checkpoint. "
            "The JAX package's msgpack/Orbax checkpoints are not readable "
            "by the PyTorch port yet; write a .pt with "
            "multimodalgame_tpu.utils.torch_interop.save_reference_"
            "checkpoint first")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    modules = AgentModules(cfg)
    load_torch_state(modules, payload["models"])
    if device is not None:
        modules.to(device)
    return payload["data"], modules


def save_reference_checkpoint(path: str, data: Dict[str, Any],
                              modules: AgentModules) -> None:
    """Write the four agents' weights as a reference-layout ``.pt``
    (``{data, models, optimizers}``, misc.py:58-76), in float32, with
    empty optimizer entries."""
    models = {agent: {k: v.detach().cpu().float().clone()
                      for k, v in getattr(modules, agent).state_dict()
                      .items()}
              for agent in AGENT_NAMES}
    torch.save({"data": dict(data), "models": models,
                "optimizers": {agent: {} for agent in AGENT_NAMES}}, path)
