"""Processes of a data-parallel job over ``torch.distributed``.

The port of ``multimodalgame_tpu/parallel/distributed.py``. JAX runs one
process a host, each driving its local chips, and one SPMD program over
every chip of the job. The port runs one process a device ("rank"),
each dispatching its own kernels, since the training step is host-bound:

* ``-mesh N`` on one host (:func:`launch` with no coordinator) spawns N
  local ranks (``torch.multiprocessing``, the ``spawn`` method: never a
  fork after CUDA is initialised) that meet at a file in a temporary
  directory;
* a multi-host job (``-num_processes P -coordinator host:port
  -process_id i``) joins a ``tcp://`` process group, host ``i``'s ranks
  numbered after those of the hosts before it;
* NCCL between distinct CUDA devices, gloo on the CPU and where two
  ranks share one card (NCCL refuses that: "Duplicate GPU detected").

Every rank holds the same full host value (the same staged sets, seeds
and shuffle plans; JAX distributed.py:63-76), so no data is sent between
ranks: each takes its rows of each batch (``parallel/mesh.py``). Rank 0
writes the run's shared files; the others write their host logs to
``.p<rank>`` paths (JAX train.py:212-215).

``python -m multimodalgame_tpu_torch.parallel.distributed --coordinator
host:port --num-processes P --process-id i [--device cpu]`` runs one
data-parallel training step as one rank of a P-process job and prints
its metrics as one JSON line (JAX ``_main``, distributed.py:422-438):
the tests' two-process check, and a manual multi-host smoke test.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

# A collective waits this long for the other ranks before it fails.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(devices: Sequence) -> str:
    """``nccl`` for ranks on distinct CUDA devices, else ``gloo`` (the
    CPU, or ranks that share a card)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo", device=None) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (``jax.distributed.initialize``'s counterpart).
    ``coordinator`` is ``host:port`` (rank 0 listens there) or an
    ``init_method`` URL (``tcp://``, ``file://``)."""
    import torch.distributed as dist
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {}
    if backend == "nccl" and device is not None:
        kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=COLLECTIVE_TIMEOUT, **kw)


def rank_path(path: Optional[str], mesh) -> Optional[str]:
    """``path`` for the writer rank (``Mesh.writer``, which with
    ``Mesh.rank`` and ``Mesh.size`` stands for JAX's process accessors),
    ``path.p<rank>`` for the others."""
    if not path or mesh is None or mesh.writer:
        return path
    return f"{path}.p{mesh.global_rank}"


def host_view(x: torch.Tensor, mesh=None, sharded: bool = False
              ) -> np.ndarray:
    """``x`` on the host. A tensor that holds this rank's rows
    (``sharded``) is gathered in rank order along its first axis first, a
    collective that every rank calls in the same order; a replicated one
    (or any off the mesh) is read as it is."""
    return host_view_many([x], mesh, [sharded])[0]


def host_view_many(xs: Sequence[torch.Tensor], mesh=None,
                   sharded: Optional[Sequence[bool]] = None
                   ) -> List[np.ndarray]:
    """:func:`host_view` over a sequence: the sharded tensors gathered in
    one collective, then one copy to the host for all of them."""
    xs = list(xs)
    sharded = list(sharded or [False] * len(xs))
    pick = [i for i, s in enumerate(sharded) if s and mesh is not None]
    if pick:
        got = mesh.gather_rows([xs[i] for i in pick], [0] * len(pick))
        for i, g in zip(pick, got):
            xs[i] = g
    return [x.detach().cpu().numpy() for x in xs]


def _to_cpu(x):
    """A result with every tensor and module moved to the CPU."""
    if isinstance(x, (torch.Tensor, torch.nn.Module)):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _run_rank(local: int, fn: Callable, args: tuple, devices: List[str],
              init: str, world: int, base: int, backend: str,
              out_dir: Optional[str], threads: int):
    """One rank: join the group, call ``fn(mesh, *args)``, leave."""
    import torch.distributed as dist
    from multimodalgame_tpu_torch.parallel.mesh import Mesh
    device = torch.device(devices[local])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    initialize(init, world, base + local, backend, device)
    try:
        out = fn(Mesh(base + local, world, device, backend), *args)
        if out_dir is not None:
            torch.save(_to_cpu(out), os.path.join(out_dir, f"rank{local}.pt"))
        return out
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, args: tuple = (), *,
           coordinator: Optional[str] = None, num_processes: int = 1,
           process_id: int = 0, backend: Optional[str] = None,
           timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` as one rank on each of this host's
    ``devices`` (``parallel/mesh.py:Mesh``); returns the ranks' results
    in rank order, moved to the CPU. ``fn`` and ``args`` are pickled:
    ``fn`` is a module-level function and tensors in ``args`` lie on the
    CPU.

    Alone (``num_processes`` 1) the ranks are spawned and meet at a file
    in a temporary directory. In a multi-host job every host calls this
    with its own ``process_id`` and the same ``coordinator``; host ``i``'s
    ranks are ``i * len(devices)`` onwards, and a host with one device
    runs its rank in this process. ``backend`` defaults to
    :func:`backend_for`. A rank that fails ends the others and raises
    here; ``timeout`` (seconds) bounds the whole run."""
    import torch.multiprocessing as mp
    devices = [str(torch.device(d)) for d in devices]
    local = len(devices)
    world = local * int(num_processes)
    base = local * int(process_id)
    backend = backend or backend_for(devices)
    threads = max(1, torch.get_num_threads() // local)
    if coordinator is not None and local == 1:
        return [_to_cpu(_run_rank(0, fn, args, devices, coordinator, world,
                                  base, backend, None, threads))]
    with tempfile.TemporaryDirectory(prefix="mmg_mesh_") as tmp:
        init = (coordinator if coordinator is not None
                else "file://" + os.path.join(tmp, "rendezvous"))
        ctx = mp.start_processes(
            _run_rank, args=(fn, args, devices, init, world, base, backend,
                             tmp, threads),
            nprocs=local, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {local} ranks did not finish "
                                       f"in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{i}.pt"),
                           weights_only=False) for i in range(local)]


# ---------------------------------------------------------------- dryrun

def dryrun_setup():
    """The small game, batch and weights of the one-step dryrun, the
    same in every process (JAX distributed.py:_dryrun_setup)."""
    from multimodalgame_tpu_torch.game.agents import (AgentModules,
                                                      init_params)
    from multimodalgame_tpu_torch.game.config import GameConfig
    cfg = GameConfig(img_feat_dim=512, img_h_dim=32, sender_out_dim=32,
                     rec_w_dim=32, rec_hidden=16, wv_dim=100,
                     max_exchange=3, fixed_exchange=False, entropy_s=0.08,
                     entropy_sen=0.01, entropy_rec=0.01,
                     learning_rate=1e-4, optim_type="RMSprop")
    num_classes, batch = 5, 8
    rng = np.random.RandomState(0)
    data = rng.randn(batch, 512).astype(np.float32)
    target = rng.randint(0, num_classes, size=batch)
    desc = rng.randn(num_classes, 100).astype(np.float32)
    return (cfg, init_params(AgentModules(cfg), seed=0, device="cpu"),
            data, target, desc)


def dryrun_step(mesh) -> dict:
    """One data-parallel step of the dryrun game on ``mesh`` (``None``:
    one device): its metrics and the sum of its updated weights."""
    from multimodalgame_tpu_torch.game.train import (init_opt_states,
                                                     make_train_step)
    cfg, mods, data, target, desc = dryrun_setup()
    step = make_train_step(mods, top_k=3, batch_denom=len(data), seed=1,
                           device="cpu" if mesh is None else None,
                           mesh=mesh)
    opts = init_opt_states(cfg, mods)
    m = step(opts, data, target, desc, 0)
    return {"loss_rec": float(m.loss_rec), "loss_sen": float(m.loss_sen),
            "accuracy": float(m.accuracy),
            "weight_sum": float(sum(p.detach().double().sum()
                                    for p in mods.parameters()))}


def _main() -> None:
    """One rank of a multi-process dryrun; prints its metrics as JSON."""
    import argparse
    import json
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    out, = launch(dryrun_step, [a.device], coordinator=a.coordinator,
                  num_processes=a.num_processes, process_id=a.process_id)
    print(json.dumps({"process_id": a.process_id,
                      "num_processes": a.num_processes, **out}))


if __name__ == "__main__":
    _main()
