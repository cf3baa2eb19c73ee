"""The trainer's share of the card's float32 peak: the game's forward and
backward operations per update (``counts.train_flops``, every turn
counted) times the updates in the traced window, over the window, over
67 TFLOP/s."""

from gamebench.counts import PEAK_F32_FLOPS, train_flops


def read(ctx):
    if ctx["kind"] != "train" or not ctx["updates"]:
        return None
    tr = ctx["trace"]
    return 100.0 * train_flops(ctx["cfg"]) * ctx["updates"] / (
        tr.window_s * PEAK_F32_FLOPS)
