"""Qwen2.5-VL's vision tower (``models/qwen_vision.py:VisionTower``)
against its roofline over the traced photo-serving window: each
request's bound at its batch (``counts_qwen_vision.tower_work``: the
products' operations over the dense bfloat16 peak, or the bfloat16
weights and each counted layer's input and output over the HBM peak,
whichever is larger), summed, over the device time of the tower's
operations (every device operation but the eval kernel, copies and
memsets), summed. None where the trace holds none."""

from gamebench.counts_qwen_vision import tower_work
from gamebench.counts_resnet import tower_times


def read(ctx):
    if ctx["kind"] != "serve_photos" or not ctx["batches"]:
        return None
    times = tower_times(ctx["trace"])
    if not times:
        return None
    h, w = ctx["image_hw"]
    bound = sum(tower_work(b, ctx["vision_config"], h, w)["bound_s"]
                for b in ctx["batches"])
    return 100.0 * bound / sum(times)
