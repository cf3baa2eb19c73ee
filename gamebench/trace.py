"""The traced window: ``torch.profiler`` over the card, read into the
numbers the per-layer metrics take.

The window is marked by a ``gamebench.window`` annotation; the harness
marks each request or call it makes inside it with annotations of its
own (``gamebench.request``). From the profiler's raw events this module
takes the device's operations (kernels, copies, sets), the host's calls
that put work on the card, and those annotations, all on the profiler's
one clock.
"""

import contextlib
from typing import Dict, List

import numpy as np

# The CUDA runtime and driver calls that put work on the card, as the
# profiler names them.
HOST_LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel",
                     "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaMemcpyAsync")
WINDOW = "gamebench.window"


class Tracer:
    """The profiler over the card (``on_card``) and the host, through its
    own interface (Kineto and CUPTI, as ``torch.profiler`` runs them, but
    without turning every event into a Python object), started and
    stopped where the caller chooses; the window between is marked
    ``gamebench.window``. ``events`` holds the raw events after
    :meth:`stop`."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self.events = None
        self.running = False

    def start(self) -> None:
        import torch
        from torch._C._profiler import (ProfilerActivity,
                                        _ExperimentalConfig)
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        acts = {ProfilerActivity.CPU} | (
            {ProfilerActivity.CUDA} if self.on_card else set())
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts)
        self.mark = torch.profiler.record_function(WINDOW)
        self.mark.__enter__()
        self.running = True

    def stop(self) -> None:
        import torch
        from torch.autograd import _disable_profiler
        if self.on_card:
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.events = _disable_profiler().events()
        self.running = False


@contextlib.contextmanager
def traced(tracer: Tracer):
    """``tracer`` running over the block."""
    tracer.start()
    try:
        yield tracer
    finally:
        if tracer.running:
            tracer.stop()


# Host events that are the profiler's own work, not the program's.
PROFILER_OWN = ("Activity Buffer Request",)


class Trace:
    """The numbers of one traced window, read once from its events."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        dev_s, dev_e, dev_n = [], [], []
        cpu_s, cpu_e, cpu_n = [], [], []
        self.calls: Dict[str, int] = {k: 0 for k in HOST_LAUNCH_CALLS}
        self.marks: Dict[str, List[tuple]] = {}
        for ev in events:
            name = ev.name()
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                if name.startswith("gamebench.") or ev.is_user_annotation():
                    continue   # the harness's marks, mirrored on the card
                dev_s.append(start)
                dev_e.append(start + dur)
                dev_n.append(name)
                continue
            if name in PROFILER_OWN:
                continue
            if name in self.calls:
                self.calls[name] += 1
            if name.startswith("gamebench."):
                self.marks.setdefault(name, []).append((start, start + dur))
            cpu_s.append(start)
            cpu_e.append(start + dur)
            cpu_n.append(name)
        win = self.marks.get(WINDOW)
        if not win:
            raise RuntimeError("the traced window has no gamebench.window "
                               "annotation")
        self.t0, self.t1 = win[0]
        order = np.argsort(np.asarray(dev_s, np.int64), kind="stable")
        self.dev_s = np.asarray(dev_s, np.int64)[order]
        self.dev_e = np.asarray(dev_e, np.int64)[order]
        self.dev_n = [dev_n[i] for i in order]
        self.cpu_s = np.asarray(cpu_s, np.int64)
        self.cpu_e = np.asarray(cpu_e, np.int64)
        self.cpu_n = cpu_n

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy(self):
        """The union of the device's operations inside the window, as
        merged ``(start, end)`` intervals."""
        s = np.clip(self.dev_s, self.t0, self.t1)
        e = np.clip(self.dev_e, self.t0, self.t1)
        keep = e > s
        s, e = s[keep], e[keep]
        merged = []
        for a, b in zip(s.tolist(), e.tolist()):
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1][1] = b
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took the most time in the window,
        summed by name: ``[name, seconds]``."""
        inside = (self.dev_s >= self.t0) & (self.dev_s < self.t1)
        tot: Dict[str, float] = {}
        for i in np.nonzero(inside)[0].tolist():
            tot[self.dev_n[i]] = tot.get(self.dev_n[i], 0.0) + (
                self.dev_e[i] - self.dev_s[i]) * 1e-9
        return [[k[:120], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def kernel_times(self, pattern: str) -> List[float]:
        """Seconds of each device operation of the trace whose name holds
        ``pattern``, in order. Every one counts, wherever its start falls:
        the profiler runs only across the window, and the card's clock,
        mapped onto the host's, drifts by milliseconds over a trace of
        seconds, so a launch made inside the window can read as starting
        past its end."""
        return [(self.dev_e[i] - self.dev_s[i]) * 1e-9
                for i, name in enumerate(self.dev_n) if pattern in name]

    def device_seconds_between(self, a: int, b: int) -> float:
        """Seconds of device operations that start in ``[a, b)``."""
        lo = np.searchsorted(self.dev_s, a)
        hi = np.searchsorted(self.dev_s, b)
        return float((self.dev_e[lo:hi] - self.dev_s[lo:hi]).sum()) * 1e-9

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest stretches of the window with no device operation,
        each named by what the host was doing in its middle: the
        innermost host event there (the harness's own marks first)."""
        busy = self.busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:top]:
            mid = (a + b) // 2
            hit = np.nonzero((self.cpu_s <= mid) & (self.cpu_e >= mid))[0]
            names = [self.cpu_n[i] for i in hit]
            marks = [n for n in names if n.startswith("gamebench.")
                     and n != WINDOW]
            inner = (self.cpu_n[hit[np.argmax(self.cpu_s[hit])]]
                     if len(hit) else WINDOW)
            if inner == WINDOW or inner in marks:
                inner = "host: Python, no traced call"
            label = " / ".join(marks[-1:] + [inner[:80]])
            out.append([label, length * 1e-9])
        return out

    def host_launch_calls(self) -> int:
        return sum(self.calls.values())


def request_annotation():
    import torch
    return torch.profiler.record_function("gamebench.request")
