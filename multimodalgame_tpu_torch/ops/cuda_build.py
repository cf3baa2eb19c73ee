"""Build and load the port's CUDA sources (``multimodalgame_tpu_torch/csrc``).

Each ``.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, which :func:`load` opens with
``ctypes``. Libraries go to ``build/`` at the repository root, named by a
hash of the sources and flags, so a changed source is rebuilt and a built
one is reused. ``extra_flags`` (for example ``-DMMG_PHASE_CLOCKS``, the
kernel's per-phase clock stamps) give a library of its own name beside
the plain one. Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
    the ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(source: str, extra_flags: Sequence[str] = ()) -> Path:
    """Where the library built from ``csrc/<source>`` lives: the name
    carries a hash of every file in ``csrc/`` and of the flags."""
    h = hashlib.sha1(" ".join([*NVCC_FLAGS, *extra_flags]).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str], extra_flags: Sequence[str] = ()
          ) -> List[Tuple[Path, str]]:
    """Compile every source that is not built yet, one ``nvcc`` process
    each, all started together. Returns ``(library, compiler log)`` per
    source; the log holds ``ptxas``'s register and shared-memory report
    (empty for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        out = library_path(src, extra_flags)
        if out.exists():
            jobs.append((out, None, None))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((out, tmp, proc))
    results, failed = [], []
    for out, tmp, proc in jobs:    # wait for every nvcc before raising
        if proc is None:
            results.append((out, ""))
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {out.stem}:\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
        results.append((out, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(source: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The library built from ``csrc/<source>`` with ``extra_flags``,
    built on first use."""
    key = (source, tuple(extra_flags))
    lib = _LOADED.get(key)
    if lib is None:
        (path, _), = build([source], extra_flags)
        lib = _LOADED[key] = ctypes.CDLL(str(path))
    return lib
