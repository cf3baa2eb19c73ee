"""The share of the traced training window in which no operation ran on
the card while the host was outside the driver's steps
(``mmg.driver.steps``: the launches or replays of the steps and their
plan rows): the stall of log windows, dev sweeps, checkpoints and the
driver's own Python. ``device_idle.train`` less this is the idle while
the host was enqueuing steps. None where the window holds no such
span."""

import numpy as np

from gamebench.spans import idle_inside, whole


def read(ctx):
    if ctx["kind"] != "train":
        return None
    tr = ctx["trace"]
    steps = whole(tr, "mmg.driver.steps")
    if not len(steps):
        return None
    window = np.asarray([[tr.t0, tr.t1]], np.int64)
    outside = idle_inside(ctx, window).sum() - idle_inside(ctx, steps).sum()
    return 100.0 * float(outside) / (tr.t1 - tr.t0)
