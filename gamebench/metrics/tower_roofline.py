"""The image tower (ResNet-34, ``models/resnet.py:PixelTower``) against
its roofline over the traced pixel-serving window: each request's bound
at its batch (``counts_resnet.tower_work``: the convolutions' operations
over the float32 peak, or the weights and each layer's input and output
over the HBM peak, whichever is larger), summed, over the device time of
the tower's operations, summed. The tower's operations are every device
operation of the trace except the eval kernel and the copies and
memsets (``counts_resnet.is_tower_op``); the few small kernels of the
eval graph count with them. None where the trace holds none."""

from gamebench.counts_resnet import tower_times, tower_work


def read(ctx):
    if ctx["kind"] != "serve_pixels" or not ctx["batches"]:
        return None
    times = tower_times(ctx["trace"])
    if not times:
        return None
    tap = ctx["cfg"]["img_feat"]
    bound = sum(tower_work(b, ctx["image_size"], tap)["bound_s"]
                for b in ctx["batches"])
    return 100.0 * bound / sum(times)
