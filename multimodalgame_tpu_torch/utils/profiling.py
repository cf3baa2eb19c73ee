"""Wall-clock step timing for the training loops.

The ``StepTimer`` of ``multimodalgame_tpu/utils/profiling.py``. CUDA work
is launched asynchronously, so the callers stop a span only after a host
read of a device result or a ``torch.cuda.synchronize()``: a span stopped
right after a launch would time the launch, not the work.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


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
