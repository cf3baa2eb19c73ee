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
* :func:`params_from_torch_state`, :func:`models_tree`,
  :func:`optimizers_tree` and :func:`torch_payload` — the JAX package's
  own checkpoint layout (``multimodalgame_tpu/utils/checkpoint.py``'s
  ``{data, models, optimizers}`` of flax state dicts) and back: the
  models are the parameter trees above, the optimizers each agent's
  optax chain ``clip_by_global_norm`` -> rule as
  ``serialization.to_state_dict`` writes it, the slot trees shaped as
  the parameter trees (kernels ``(in, out)``).
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


def params_from_torch_state(state: Dict[str, Dict]) -> Dict[str, Any]:
    """Inverse of :func:`params_to_torch_state`: torch-layout state dicts
    (numpy arrays) -> the JAX package's four parameter trees, a kernel
    the transpose (a view) of its ``weight``."""
    out: Dict[str, Any] = {}
    for agent, sd in state.items():
        tree: Dict[str, Any] = {}
        for name in _DENSE_KEYS.get(agent, []):
            if name + ".weight" not in sd:
                continue
            tree[name] = {"kernel": sd[name + ".weight"].T}
            if name + ".bias" in sd:
                tree[name]["bias"] = sd[name + ".bias"]
        if agent == "sender":
            tree["code_bias"] = sd["code_bias"]
            if "code_bias_mou" in sd:
                tree["code_bias_mou"] = sd["code_bias_mou"]
        if agent == "receiver":
            tree["rnn"] = {"w_ih": sd["rnn.weight_ih"].T,
                           "w_hh": sd["rnn.weight_hh"].T,
                           "b_ih": sd["rnn.bias_ih"],
                           "b_hh": sd["rnn.bias_hh"]}
            tree["y1_kernel"] = sd["y1.weight"].T
            tree["y1_bias"] = sd["y1.bias"]
        out[agent] = tree
    return out


# The reference modules' parameter order (model.py:56-87, 256-271,
# 492-494): layers in this order, a GRU's four tensors, then weight before
# bias (the JAX package's torch_interop.py:_torch_param_entries).
_ORDER = {"sender": ("code_bias", "code_bias_mou", "image_layer",
                     "code_layer", "binary_layer", "attn_W_x", "attn_W_w",
                     "attn_U", "attn_W_g"),
          "receiver": ("rnn", "w_h", "w_d", "w", "y1", "y2", "s", "d_d",
                       "d_h", "d_attn"),
          "baseline_sen": ("linear1", "linear2"),
          "baseline_rec": ("linear1", "linear2")}
_TENSOR_ORDER = ("", "weight_ih", "weight_hh", "bias_ih", "bias_hh",
                 "weight", "bias")


def reference_order(agent: str, names) -> list:
    """``names`` (an agent's torch-layout parameter names) in the order of
    ``Module.parameters()``, which indexes torch's optimizer slots."""
    def key(name):
        layer, _, tensor = name.partition(".")
        return _ORDER[agent].index(layer), _TENSOR_ORDER.index(tensor)
    return sorted(names, key=key)


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

    Only torch's zip format is read here; anything else raises
    ``ValueError``. ``utils/checkpoint.py:read_checkpoint`` reads the JAX
    package's msgpack files too.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path) or not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a reference-layout .pt (torch zip) checkpoint; "
            "utils/checkpoint.py:read_checkpoint reads the JAX package's "
            "msgpack files too")
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


# --------------------------------------------- the JAX package's layout

def _agent_slots(modules: AgentModules, agent: str, st: Dict[str, Any],
                 leaf) -> Dict[str, Any]:
    """An agent's optimizer state as JAX's optax chain writes it
    (``serialization.to_state_dict(init_opt_states(cfg, params))``):
    ``clip_by_global_norm``'s empty state under ``"0"``, the rule's under
    ``"1"`` — SGD ``{'0': {}, '1': {}}``, Adam ``{'0': {count, mu, nu},
    '1': {}}``, RMSprop ``{'0': {nu}, '1': {}, '2': {}}`` — each slot tree
    shaped as the agent's parameter tree, each slot through ``leaf``."""
    names = [n for n, _ in getattr(modules, agent).named_parameters()]

    def tree(slot):
        return _leaf_tree(agent, dict(zip(names, st[slot])), leaf)

    optim_type = modules.cfg.optim_type
    if optim_type == "SGD":
        rule = {"0": {}, "1": {}}
    elif optim_type == "Adam":
        rule = {"0": {"count": np.asarray(int(st["count"]), np.int32),
                      "mu": tree("mu"), "nu": tree("nu")}, "1": {}}
    elif optim_type == "RMSprop":
        rule = {"0": {"nu": tree("nu")}, "1": {}, "2": {}}
    else:
        raise NotImplementedError(optim_type)
    return {"0": {}, "1": rule}


def _leaf_tree(agent: str, sd: Dict[str, torch.Tensor], leaf):
    """:func:`params_from_torch_state` of one agent, each tensor through
    ``leaf`` first."""
    return params_from_torch_state({agent: {k: leaf(v)
                                            for k, v in sd.items()}})[agent]


def models_tree(modules: AgentModules, leaf) -> Dict[str, Any]:
    """The JAX package's ``models`` entry for the four agents, each
    tensor through ``leaf`` (``host_leaf`` to write it, ``shape_leaf``
    for a template to check a file against)."""
    return {agent: _leaf_tree(agent, getattr(modules, agent).state_dict(),
                              leaf)
            for agent in AGENT_NAMES}


def optimizers_tree(modules: AgentModules,
                    opt_states: Dict[str, Dict[str, Any]],
                    leaf) -> Dict[str, Any]:
    """The JAX package's ``optimizers`` entry for the port's optimizer
    states, each slot through ``leaf``."""
    return {agent: _agent_slots(modules, agent, opt_states[agent], leaf)
            for agent in AGENT_NAMES}


def host_leaf(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array a checkpoint holds, in its dtype (the
    JAX package writes its parameters' own)."""
    return t.detach().cpu().numpy()


def shape_leaf(t: torch.Tensor) -> np.ndarray:
    """A float32 stand-in of ``t``'s shape that holds no memory."""
    return np.broadcast_to(np.float32(0), tuple(t.shape))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def torch_payload(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's checkpoint tree (numpy leaves) -> the reference
    ``.pt`` payload: ``data`` as Python scalars (JAX's ``load_checkpoint``
    reads them so), the models as torch-layout state dicts of CPU tensors
    in the file's dtype, and the optimizers as torch optimizer
    ``state_dict``s indexed by parameter position (``step`` Adam's count,
    else the checkpoint's step, as :func:`opt_states_to_torch` writes
    them). Raises ``KeyError``/``TypeError`` on a tree of another
    layout."""
    data = {k: v.item() if isinstance(v, np.ndarray) and v.ndim == 0
            else v for k, v in tree["data"].items()}
    state = params_to_torch_state(tree["models"])
    models, optimizers = {}, {}
    for agent, sd in state.items():
        names = reference_order(agent, sd)
        models[agent] = {k: _tensor(sd[k]) for k in names}
        rule = tree["optimizers"][agent]["1"]["0"]
        kind = ("Adam" if "count" in rule else "RMSprop" if "nu" in rule
                else "SGD")
        slots = {theirs: params_to_torch_state({agent: rule[ours]})[agent]
                 for ours, theirs in _SLOTS[kind]}
        step = int(rule["count"] if kind == "Adam" else data.get("step", 0))
        optimizers[agent] = {
            "state": {i: {"step": step, **{k: _tensor(v[name])
                                           for k, v in slots.items()}}
                      for i, name in enumerate(names)} if slots else {},
            "param_groups": [{"params": list(range(len(names)))}]}
    return {"data": data, "models": models, "optimizers": optimizers}
