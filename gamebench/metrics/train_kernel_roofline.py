"""The train-mode exchange kernel (``fused_exchange_kernel<true>``) against
its roofline: the least time of every launch in the traced window at its
shapes (``counts.kernel_work``: all turns, Philox-drawn bits, every
training launch at the configured batch), summed, over the kernel's
device time, summed, by name from the trace. None where the window
launched it not at all (a configuration the kernel does not take)."""

from gamebench.counts import kernel_work
from gamebench.kernels import TRAIN_KERNEL, kernel_times


def read(ctx):
    if ctx["kind"] != "train":
        return None
    times = kernel_times(ctx["trace"], TRAIN_KERNEL)
    if not times:
        return None
    bound = kernel_work(ctx["cfg"], ctx["cfg"]["batch_size"])["bound_s"]
    return 100.0 * bound * len(times) / sum(times)
