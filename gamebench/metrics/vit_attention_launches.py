"""The photo tower's attention launches per request: the trace's
attention kernels (named as ``vit_attention_ms`` reads them) counted,
over the traced window's requests. The tower calls attention once a
window size in a windowed block and once in a full one (4 + 28 x 4 =
116 calls a request at 364 x 504), whatever the batch. None where the
trace holds none."""

from gamebench.counts_qwen_vision import attention_times


def read(ctx):
    if ctx["kind"] != "serve_photos" or not ctx["batches"]:
        return None
    times = attention_times(ctx["trace"])
    if not times:
        return None
    return len(times) / len(ctx["batches"])
