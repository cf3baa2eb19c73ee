"""The photo tower's device time per request: the device time of the
tower's operations in the trace (``counts_resnet.is_tower_op``: all but
the eval kernel, copies and memsets; the few small kernels of the eval
graph count with them), over the traced window's requests."""

from gamebench.counts_resnet import tower_times


def read(ctx):
    if ctx["kind"] != "serve_photos" or not ctx["batches"]:
        return None
    times = tower_times(ctx["trace"])
    if not times:
        return None
    return 1e3 * sum(times) / len(ctx["batches"])
