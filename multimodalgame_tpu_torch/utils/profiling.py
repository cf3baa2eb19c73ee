"""The port's tracing: named host spans for ``torch.profiler``, and
wall-clock step timing for the training loops.

``span(name)`` marks a block of the program as ``mmg.<name>`` in any
running ``torch.profiler`` trace, on the profiler's one clock, so the
trace names what the host was doing while the card ran or sat idle. A
span records the host's side only: work it enqueues on the card runs
later, and shows in the same trace as the device's own operations. A
span that waits on the card (a copy to the host) lasts as long as the
work queued before it, not only its own.

The check is ``torch.autograd._profiler_enabled()``, the C++ profiler's
own state: a profiler enabled through ``torch.autograd._enable_profiler``,
as a benchmark's tracer may do, leaves the Python flag
``torch.autograd.profiler._is_profiler_enabled`` False. With the profiler
off a span is that one C call. With it on, a span is the profiler's C++
record function (``torch._C._profiler._RecordFunctionFast``, the one
``torch.fx`` graphs enter), a host event of the operator kind, at about a
tenth of ``torch.profiler.record_function``'s cost: a serving request's
spans would otherwise add about a sixth to its traced host time.

``StepTimer`` is the ``StepTimer`` of
``multimodalgame_tpu/utils/profiling.py``: the "step timing" lines of
the training log. CUDA work is launched asynchronously, so the callers
stop a span only after a host read of a device result or a
``torch.cuda.synchronize()``: a span stopped right after a launch would
time the launch, not the work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

# The prefix of every span's name in a trace.
SPAN_PREFIX = "mmg."

_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "into", "key", "mark", "t0")

    def __init__(self, name: str, into: Optional[Dict[str, float]],
                 key: Optional[str]):
        self.name, self.into, self.key = name, into, key
        self.mark = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.mark = torch._C._profiler._RecordFunctionFast(
                SPAN_PREFIX + self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            self.into[self.key] = (self.into.get(self.key, 0.0)
                                   + time.perf_counter() - self.t0)
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


def span(name: str, into: Optional[Dict[str, float]] = None,
         key: Optional[str] = None):
    """A context manager marking its block as ``mmg.<name>`` while the
    profiler runs; with ``into``, a dict, the block's host seconds are
    added to ``into[key]`` whether or not it runs."""
    if into is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, into, key)


class StepTimer:
    """Accumulates wall times and reports per-step summaries.

    Each ``start``/``stop`` pair records one span covering ``steps``
    optimizer updates, so throughput is reported per step, not per
    span."""

    def __init__(self):
        self._times: List[tuple] = []  # (seconds, steps)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, steps: int = 1) -> None:
        if self._t0 is not None:
            self._times.append((time.perf_counter() - self._t0, steps))
            self._t0 = None

    def cancel(self) -> None:
        """Discard the currently running span without recording it."""
        self._t0 = None

    @property
    def running(self) -> bool:
        return self._t0 is not None

    @property
    def count(self) -> int:
        return len(self._times)

    @property
    def seconds(self) -> float:
        """Wall seconds of the recorded spans."""
        return float(sum(t for t, _ in self._times))

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        import numpy as np
        secs = np.asarray([t for t, _ in self._times])
        steps = np.asarray([n for _, n in self._times])
        per_step = secs / np.maximum(steps, 1)
        total = float(secs.sum())
        n = int(steps.sum())
        return {
            "steps": n,
            "mean_ms": float(total / max(n, 1) * 1e3),
            "p50_ms": float(np.percentile(per_step, 50) * 1e3),
            "p95_ms": float(np.percentile(per_step, 95) * 1e3),
            "steps_per_sec": float(n / total) if total > 0 else 0.0,
        }

    def reset(self) -> None:
        self._times.clear()
