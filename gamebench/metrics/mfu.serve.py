"""The predictor's share of the card's float32 peak: the forward
operations of every request served in the traced window over the turns
its batch ran (the eval conversation breaks early, reference
model.py:866-867; ``counts.forward_flops``), over the window, over
67 TFLOP/s."""

from gamebench.counts import PEAK_F32_FLOPS, forward_flops


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["batches"]:
        return None
    flops = sum(forward_flops(ctx["cfg"], b, n, train=False)
                for b, n in zip(ctx["batches"], ctx["n_steps"]))
    return 100.0 * flops / (ctx["trace"].window_s * PEAK_F32_FLOPS)
