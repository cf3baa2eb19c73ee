"""The photo tower's attention per request: the device time of the
trace's attention kernels, windowed and full, over the traced window's
requests. A kernel is attention's when its name holds one of
``counts_qwen_vision.ATTENTION_KERNELS`` (FlashAttention-2's
``flash_fwd``, the memory-efficient ``fmha_cutlass``, cuDNN's ``sdpa``):
the kernels ``scaled_dot_product_attention`` launches. None where the
trace holds none."""

from gamebench.counts_qwen_vision import attention_times


def read(ctx):
    if ctx["kind"] != "serve_photos" or not ctx["batches"]:
        return None
    times = attention_times(ctx["trace"])
    if not times:
        return None
    return 1e3 * sum(times) / len(ctx["batches"])
