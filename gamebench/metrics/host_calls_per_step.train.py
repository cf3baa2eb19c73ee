"""The host's calls that put work on the card (``cudaGraphLaunch``,
``cudaLaunchKernel``/``ExC``, ``cuLaunchKernel``/``Ex`` and
``cudaMemcpyAsync``, as the profiler counts them) in the traced window,
per update: about one on the graph route, thousands eager."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["updates"]:
        return None
    return ctx["trace"].host_launch_calls() / ctx["updates"]
