"""The pixel predictor's share of the card's float32 peak: each request's
operations, the tower's at its batch (``counts_resnet.tower_work``) and
the eval conversation's over the turns its batch ran
(``counts.forward_flops``), summed over the traced window's requests,
over the window, over 67 TFLOP/s."""

from gamebench.counts import PEAK_F32_FLOPS, forward_flops
from gamebench.counts_resnet import tower_work


def read(ctx):
    if ctx["kind"] != "serve_pixels" or not ctx["batches"]:
        return None
    cfg = ctx["cfg"]
    tap = cfg["img_feat"]
    flops = sum(tower_work(b, ctx["image_size"], tap)["flops"]
                + forward_flops(cfg, b, n, train=False)
                for b, n in zip(ctx["batches"], ctx["n_steps"]))
    return 100.0 * flops / (ctx["trace"].window_s * PEAK_F32_FLOPS)
