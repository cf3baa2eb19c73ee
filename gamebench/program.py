"""What the benchmark takes from the program: its flags, its agents with
the benchmark's weights loaded into them, its sets and description pack
built from the benchmark's inputs, and its launch and graph counters.
The port is imported here and in the entries only."""

import re
from typing import Dict, List

import numpy as np
import torch


def argv_for(config: dict, extra: Dict[str, object]) -> List[str]:
    """The program's command-line flags: the configuration's, then
    ``extra``'s (booleans as ``-name`` or ``-noname``)."""
    argv = ["-model_type", config["model_type"]]
    for name, value in list(config["flags"].items()) + list(extra.items()):
        if isinstance(value, bool):
            argv.append(("-" if value else "-no") + name)
        else:
            argv += ["-" + name, str(value)]
    return argv


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_flags(config: dict, extra: Dict[str, object]):
    from multimodalgame_tpu_torch.config import flags_from_argv
    return flags_from_argv(argv_for(config, extra))


def agents(flags, weights: Dict[str, torch.Tensor], device):
    """The program's four agents, built from its flags, holding
    ``weights``."""
    from multimodalgame_tpu_torch.game.agents import AgentModules
    from multimodalgame_tpu_torch.game.config import GameConfig
    modules = AgentModules(GameConfig.from_flags(flags)).to(device)
    named = dict(modules.named_parameters())
    if set(named) != set(weights):
        raise RuntimeError("the program's leaves differ from the "
                           "benchmark's table: "
                           f"{sorted(set(named) ^ set(weights))}")
    with torch.no_grad():
        for k, p in named.items():
            if tuple(p.shape) != tuple(weights[k].shape):
                raise RuntimeError(f"{k}: the program's shape "
                                   f"{tuple(p.shape)}, the table's "
                                   f"{tuple(weights[k].shape)}")
            p.copy_(weights[k])
    return modules


def description_pack(desc: torch.Tensor):
    from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
    d = desc.cpu().numpy()
    n = d.shape[0]
    return DescriptionPack(d, d, [1] * n, {i: i for i in range(n)},
                           {i: f"class{i}" for i in range(n)})


def device_set(part: dict, device):
    from multimodalgame_tpu_torch.data.device_dataset import DeviceDataset
    ctx = None if part["ctx"] is None else part["ctx"].cpu().numpy()
    return DeviceDataset(part["feats"], part["labels"].cpu().numpy(),
                         context=ctx, device=device)


def counters() -> Dict[str, int]:
    """The kernels' launch counts and the CUDA graphs' captures and
    replays in this process so far."""
    from multimodalgame_tpu_torch.ops.cuda_exchange import (
        fused_eval_exchange, fused_train_forward)
    from multimodalgame_tpu_torch.utils.cuda_graph import Captured
    return {"train_kernel_launches": int(fused_train_forward.launches),
            "eval_kernel_launches": int(fused_eval_exchange.launches),
            "graph_captures": int(Captured.captures),
            "graph_replays": int(Captured.replays)}


class LogRecorder:
    """The driver's log: every line kept for the check, and written to
    the run's log file as the program's own logger writes it."""

    def __init__(self, path: str):
        from multimodalgame_tpu_torch.utils.logging import FileLogger
        self.inner = FileLogger(path, min_print_level=99)
        self.lines: List[str] = []
        self.watch = None   # called with each line, where set

    def Log(self, message: str, level: int = 1) -> None:
        self.lines.append(message)
        self.inner.Log(message, level)
        if self.watch is not None:
            self.watch(message)

    def value(self, marker: str) -> float:
        """The number after ``marker`` on the newest line holding it."""
        for line in reversed(self.lines):
            if marker in line:
                return float(line.split(marker)[1].split()[0])
        raise KeyError(marker)


DUMP_LINE = re.compile(r"^\s*(\d+) S: ([01]+) +\S+ +s=(\d) R: ([01]+)")


def train_dump_bits(lines: List[str], rows: int, device) -> Dict:
    """Every row's bits from a log window's training dump (the driver's
    ``Train:`` block with ``rows`` samples): ``z`` and ``w`` ``(n, rows,
    W)`` and the stop masks ``s`` ``(n, rows)``, over the ``n`` turns the
    step ran."""
    block = next(x for x in lines if x.startswith("Train:"))
    found = [DUMP_LINE.match(x) for x in block.splitlines()]
    found = [m for m in found if m]
    n = len(found) // rows
    if n * rows != len(found) or n == 0:
        raise RuntimeError(f"a dump of {len(found)} turn lines is not "
                           f"{rows} rows' turns")
    z = [[int(c) for c in m.group(2)] for m in found]
    w = [[int(c) for c in m.group(4)] for m in found]
    s = [int(m.group(3)) for m in found]

    def stack(v, *width):
        t = torch.tensor(v, dtype=torch.float32, device=device)
        return t.view(rows, n, *width).transpose(0, 1).contiguous()
    W = len(z[0])
    return {"z": stack(z, W), "w": stack(w, W), "s": stack(s)}


def rms_state(modules, opt_states) -> Dict[str, torch.Tensor]:
    """A copy of each leaf's RMSprop ``nu``, by the leaf's name."""
    out = {}
    for agent in ("sender", "receiver", "baseline_sen", "baseline_rec"):
        names = [n for n, _ in getattr(modules, agent).named_parameters()]
        for n, nu in zip(names, opt_states[agent]["nu"]):
            out[agent + "." + n] = nu.detach().clone()
    return out


def nu_norms(modules, opt_states, before: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
    """Each leaf's gradient norm worked out from its RMSprop state before
    and after one update, in float64: ``nu = decay * before + (1 - decay)
    g**2`` (a sum that rounding takes below 0 reads 0)."""
    from multimodalgame_tpu_torch.game.train import RMS_DECAY
    out = {}
    for k, nu in rms_state(modules, opt_states).items():
        g2 = (nu.double() - RMS_DECAY * before[k].double()).sum().item()
        out[k] = float(np.sqrt(max(g2, 0.0) / (1 - RMS_DECAY)))
    return out
