"""The eval-mode exchange kernel (``fused_exchange_kernel<false>``)
against its roofline over the traced serving window: each request's
launch bounded at its batch over the turns that request's conversation
ran (``counts.kernel_work``; the eval conversation stops once every row
has, reference model.py:866-867, as ``mfu.serve`` counts it), summed,
over the kernel's device time, summed. The work a launch does past those
turns is not needed, so a kernel that stops early reads higher. None
where the launches do not match the requests one to one."""

from gamebench.counts import kernel_work
from gamebench.kernels import EVAL_KERNEL, kernel_times


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    times = kernel_times(ctx["trace"], EVAL_KERNEL)
    if not times or len(times) != len(ctx["batches"]):
        return None
    bound = sum(kernel_work(ctx["cfg"], b, turns=n)["bound_s"]
                for b, n in zip(ctx["batches"], ctx["n_steps"]))
    return 100.0 * bound / sum(times)
