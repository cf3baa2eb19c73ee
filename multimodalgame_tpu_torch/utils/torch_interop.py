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
  read and write ``.pt`` files with the weights of all four agents and,
  given the optimizer states, their slots in torch's optimizer
  ``state_dict`` layout, as the JAX package's
  ``utils/torch_interop.py:opt_state_to_torch`` writes them: RMSprop
  ``square_avg`` and ``step``, Adam ``exp_avg``, ``exp_avg_sq`` and
  ``step`` (the update count), SGD an empty ``state``. Slots are indexed
  by ``Module.parameters()`` position, and the port's modules register
  their parameters in the reference's order (model.py:56-87, 256-271,
  492-494), so position ``i`` is the same parameter in both.
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


# The port's slot -> torch's, per optimizer (JAX torch_interop.py:180-225).
_SLOTS = {"RMSprop": (("nu", "square_avg"),),
          "Adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq")),
          "SGD": ()}


def read_reference_checkpoint(path: str) -> Dict[str, Any]:
    """The payload ``{data, models, optimizers}`` of a reference-layout
    ``.pt``, tensors on the CPU.

    Only torch's zip format is read. The JAX package's own checkpoints
    (msgpack files, Orbax directories) raise ``ValueError``: convert them
    with that package's ``save_reference_checkpoint`` first.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path) or not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a reference-layout .pt (torch zip) checkpoint. "
            "The JAX package's msgpack/Orbax checkpoints are not readable "
            "by the PyTorch port yet; write a .pt with "
            "multimodalgame_tpu.utils.torch_interop.save_reference_"
            "checkpoint first")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(
        path: str, cfg: GameConfig,
        device: Optional[Union[str, torch.device]] = None
) -> Tuple[Dict[str, Any], AgentModules]:
    """Read a reference-layout ``.pt`` into new agents for ``cfg``.
    Returns ``(data, modules)``: the file's metadata dict and the agents,
    on ``device`` when given. Optimizer slots are not read here
    (``utils/checkpoint.py:load_checkpoint`` restores them)."""
    payload = read_reference_checkpoint(path)
    modules = AgentModules(cfg)
    load_torch_state(modules, payload["models"])
    if device is not None:
        modules.to(device)
    return payload["data"], modules


def opt_states_to_torch(modules: AgentModules,
                        opt_states: Dict[str, Dict[str, Any]],
                        optim_type: str, step: int = 0
                        ) -> Dict[str, Dict[str, Any]]:
    """The port's optimizer states (``game/train.py:init_opt_states``) as
    four torch optimizer ``state_dict``s, float32 on the CPU: RMSprop
    ``{step, square_avg}`` (``step`` is the checkpoint's step, as the JAX
    package writes it), Adam ``{step: count, exp_avg, exp_avg_sq}``, SGD
    no slots."""
    if optim_type not in _SLOTS:
        raise NotImplementedError(optim_type)
    out = {}
    for agent in AGENT_NAMES:
        n = len(list(getattr(modules, agent).parameters()))
        st = opt_states[agent]
        count = int(st["count"]) if optim_type == "Adam" else int(step)
        state = {i: {"step": count,
                     **{theirs: st[ours][i].detach().cpu().float().clone()
                        for ours, theirs in _SLOTS[optim_type]}}
                 for i in range(n)} if _SLOTS[optim_type] else {}
        out[agent] = {"state": state,
                      "param_groups": [{"params": list(range(n))}]}
    return out


@torch.no_grad()
def load_opt_states(optimizers: Dict[str, Dict[str, Any]],
                    opt_states: Dict[str, Dict[str, Any]],
                    optim_type: str) -> None:
    """Copy the slots of torch optimizer ``state_dict``s into the port's
    optimizer states in place (on their device). An agent whose entry is
    absent or has no slots keeps its state, as the JAX package's
    ``opt_state_from_torch`` does."""
    for agent in AGENT_NAMES:
        state = (optimizers.get(agent) or {}).get("state") or {}
        if not state:
            continue
        st = opt_states[agent]
        for ours, theirs in _SLOTS[optim_type]:
            for i, dst in enumerate(st[ours]):
                if i in state:
                    dst.copy_(torch.as_tensor(state[i][theirs]))
        if optim_type == "Adam":
            # In place: a captured step reads the count where it lies.
            count = max(int(v.get("step", 0)) for v in state.values())
            if isinstance(st["count"], torch.Tensor):
                st["count"].fill_(count)
            else:
                st["count"] = count


def save_reference_checkpoint(path: str, data: Dict[str, Any],
                              modules: AgentModules,
                              opt_states: Optional[Dict[str, Any]] = None,
                              optim_type: str = "RMSprop") -> None:
    """Write the four agents' weights as a reference-layout ``.pt``
    (``{data, models, optimizers}``, misc.py:58-76), in float32, with the
    optimizers' slots when ``opt_states`` is given, else empty entries.
    The file is written beside ``path`` and renamed into place, so a
    crash never leaves a truncated checkpoint."""
    models = {agent: {k: v.detach().cpu().float().clone()
                      for k, v in getattr(modules, agent).state_dict()
                      .items()}
              for agent in AGENT_NAMES}
    optimizers = ({agent: {} for agent in AGENT_NAMES} if opt_states is None
                  else opt_states_to_torch(modules, opt_states, optim_type,
                                           int(data.get("step", 0))))
    tmp = path + ".tmp"
    torch.save({"data": dict(data), "models": models,
                "optimizers": optimizers}, tmp)
    os.replace(tmp, path)
