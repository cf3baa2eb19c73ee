"""The program's own spans in a traced window, and the card's idle time
inside them.

``multimodalgame_tpu_torch/utils/profiling.py:span`` marks the port's
layers as ``mmg.<name>`` host events while a profiler runs, on the
profiler's one clock with the device's operations (``trace.Trace``'s
``cpu_*`` lists). A span the tracer's start or stop cuts is left out: it
is missing, or ends where the window ends. A program without these
spans gives none, and the readers built on them read nothing.
"""

from typing import Dict

import numpy as np

from gamebench.trace import Trace


def whole(tr: Trace, name: str) -> np.ndarray:
    """The spans named ``name`` that lie wholly inside the window, as an
    ``(n, 2)`` array of ``[start, end]`` nanoseconds in order of start."""
    got = [(s, e) for s, e, n in zip(tr.cpu_s.tolist(), tr.cpu_e.tolist(),
                                     tr.cpu_n)
           if n == name and tr.t0 < s and e < tr.t1]
    return np.asarray(sorted(got), np.int64).reshape(-1, 2)


def _busy_arrays(ctx: Dict) -> tuple:
    """``trace.Trace.busy``'s merged intervals as arrays of starts, ends
    and the busy time before each interval's end, read once a run."""
    if "busy_arrays" not in ctx:
        busy = np.asarray(ctx["trace"].busy(), np.int64).reshape(-1, 2)
        bs, be = busy[:, 0], busy[:, 1]
        ctx["busy_arrays"] = (bs, be, np.concatenate(
            [[0], np.cumsum(be - bs)]))
    return ctx["busy_arrays"]


def _busy_before(ctx: Dict, x: np.ndarray) -> np.ndarray:
    """The card's busy nanoseconds in the window before each of ``x``."""
    bs, be, cum = _busy_arrays(ctx)
    if not len(bs):
        return np.zeros_like(x)
    i = np.searchsorted(bs, x, side="right")
    # Every interval that starts at or before x ends before it, but the
    # last, which may run past x.
    past = np.where(i > 0, np.maximum(be[np.maximum(i - 1, 0)] - x, 0), 0)
    return cum[i] - past


def idle_inside(ctx: Dict, spans: np.ndarray) -> np.ndarray:
    """Nanoseconds of each span (``[start, end]`` rows inside the window)
    in which no operation ran on the card."""
    if not len(spans):
        return np.zeros(0, np.int64)
    a, b = spans[:, 0], spans[:, 1]
    return (b - a) - (_busy_before(ctx, b) - _busy_before(ctx, a))


def mean_idle_ms(ctx: Dict, name: str):
    """The mean time, over the whole spans named ``name``, in which the
    card sat idle inside the span; None where there is none."""
    spans = whole(ctx["trace"], name)
    if not len(spans):
        return None
    return float(idle_inside(ctx, spans).mean()) * 1e-6


def per_request_ms(ctx: Dict, child: str):
    """The mean time per request of the ``child`` spans inside the
    ``mmg.predict`` spans; None unless each ``mmg.predict`` lies inside
    its own ``gamebench.request`` mark, one to one."""
    tr = ctx["trace"]
    calls = whole(tr, "mmg.predict")
    marks = np.asarray(sorted(tr.marks.get("gamebench.request", [])),
                       np.int64).reshape(-1, 2)
    if not len(calls) or len(calls) != len(marks):
        return None
    if not ((marks[:, 0] <= calls[:, 0]) & (calls[:, 1] <= marks[:, 1])
            ).all():
        return None
    kids = whole(tr, child)
    # The call each child starts in, and whether it ends inside it.
    at = np.searchsorted(calls[:, 0], kids[:, 0], side="right") - 1
    inside = (at >= 0) & (kids[:, 1] <= calls[np.maximum(at, 0), 1])
    total = (kids[inside, 1] - kids[inside, 0]).sum()
    return float(total) * 1e-6 / len(calls)
