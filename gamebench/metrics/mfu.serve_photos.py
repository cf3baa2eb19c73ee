"""The photo predictor's share of the card's dense bfloat16 peak: each
request's operations, the tower's at its batch
(``counts_qwen_vision.tower_work``) and the eval conversation's over the
turns its batch ran (``counts.forward_flops``), summed over the traced
window's requests, over the window, over 989 TFLOP/s."""

from gamebench.counts import forward_flops
from gamebench.counts_qwen_vision import PEAK_BF16_FLOPS, tower_work


def read(ctx):
    if ctx["kind"] != "serve_photos" or not ctx["batches"]:
        return None
    cfg, (h, w) = ctx["cfg"], ctx["image_hw"]
    flops = sum(tower_work(b, ctx["vision_config"], h, w)["flops"]
                + forward_flops(cfg, b, n, train=False)
                for b, n in zip(ctx["batches"], ctx["n_steps"]))
    return 100.0 * flops / (ctx["trace"].window_s * PEAK_BF16_FLOPS)
