"""Operations and bytes of the photo tower, Qwen2.5-VL's vision encoder
(arXiv:2502.13923), from the shapes of its layers, and the rule by which
a traced serving window's device operations are its attention kernels.

Operations: the multiply-adds of every product, two operations each: the
patch embedding (the published ``Conv3d`` over the frame taken
``temporal_patch_size`` times), each block's qkv, output projection,
gate, up and down products, attention's two products over each window
(or each whole image in the blocks of ``fullatt_block_indexes``), and
the merger's two linear layers. RMSNorm, the rotation, softmax, SiLU,
GELU, the residual sums and the pool are not counted (a bfloat16
roofline of a transformer is its products'). Bytes: every weight once
(the published parameter count, bfloat16), and each counted layer's
bfloat16 input read once and output written once. The windows are the
reference's (``reference/qwen_vision.py:window_index``). At 364 x 504 an
image is 936 patches in 20 windows (12 of 64 tokens, 3 of 32, 4 of 16, 1
of 8) and 1,228.5 GFLOP: 2.82 the embedding, 1,179.3 the blocks' linear
layers, 17.9 full and 7.6 windowed attention, 20.9 the merger.
"""

from typing import Dict, List

from gamebench.counts import PEAK_BYTES
from gamebench.reference.qwen_vision import window_index

# The dense bfloat16 peak of one NVIDIA H100 SXM (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
BF16 = 2
# The attention kernels of ``scaled_dot_product_attention`` as the
# profiler names them: FlashAttention-2's (flash_fwd_kernel,
# flash_fwd_splitkv_kernel), the memory-efficient route's
# (fmha_cutlassF_*) and cuDNN's fused attention (*_sdpa_*).
ATTENTION_KERNELS = ("flash_fwd", "fmha_cutlass", "sdpa")


def parameters(vcfg: dict) -> int:
    """The published parameter count of the encoder."""
    C, I = vcfg["hidden_size"], vcfg["intermediate_size"]
    P, T = vcfg["patch_size"], vcfg["temporal_patch_size"]
    U = C * vcfg["spatial_merge_size"] ** 2
    block = (2 * C + (C * 3 * C + 3 * C) + (C * C + C)
             + 2 * (C * I + I) + (I * C + C))
    return (C * vcfg["in_channels"] * T * P * P + vcfg["depth"] * block
            + C + (U * U + U) + (U * vcfg["out_hidden_size"]
                                 + vcfg["out_hidden_size"]))


def layers(vcfg: dict, h: int, w: int) -> List[Dict]:
    """The counted layers of one image's forward: ``name``, ``flops``,
    ``inputs`` and ``outputs`` (elements)."""
    C, I = vcfg["hidden_size"], vcfg["intermediate_size"]
    P, T = vcfg["patch_size"], vcfg["temporal_patch_size"]
    m = vcfg["spatial_merge_size"]
    N = (h // P) * (w // P)
    M, U, O = N // (m * m), C * m * m, vcfg["out_hidden_size"]
    K = vcfg["in_channels"] * T * P * P
    out: List[Dict] = []

    def lin(name, rows, n_in, n_out):
        out.append({"name": name, "flops": 2 * rows * n_in * n_out,
                    "inputs": rows * n_in, "outputs": rows * n_out})

    lin("patch_embed", N, K, C)
    cu = window_index(vcfg, h // P, w // P)[1]
    wins = [b - a for a, b in zip(cu, cu[1:])]
    for i in range(vcfg["depth"]):
        pre = f"blocks.{i}."
        lin(pre + "qkv", N, C, 3 * C)
        seqs = [N] if i in vcfg["fullatt_block_indexes"] else wins
        out.append({"name": pre + "attention",
                    "flops": 4 * C * sum(s * s for s in seqs),
                    "inputs": 3 * N * C, "outputs": N * C})
        lin(pre + "proj", N, C, C)
        lin(pre + "gate", N, C, I)
        lin(pre + "up", N, C, I)
        lin(pre + "down", N, I, C)
    lin("merger.0", M, U, U)
    lin("merger.2", M, U, O)
    return out


def tower_work(batch: int, vcfg: dict, h: int, w: int) -> dict:
    """Operations and bytes of ``batch`` images' forward, and the bound:
    the larger of operations over the bfloat16 peak and bytes over the
    HBM peak."""
    table = layers(vcfg, h, w)
    flops = batch * sum(x["flops"] for x in table)
    nbytes = BF16 * (parameters(vcfg) + batch * sum(
        x["inputs"] + x["outputs"] for x in table))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def is_attention_op(name: str) -> bool:
    """Whether a device operation is one of the attention kernels: its
    name holds one of :data:`ATTENTION_KERNELS`."""
    return any(k in name for k in ATTENTION_KERNELS)


def attention_times(trace) -> List[float]:
    """Seconds of each of the trace's attention kernels (every one,
    wherever its start falls, as ``trace.Trace.kernel_times`` counts)."""
    return [(e - s) * 1e-9 for s, e, name in
            zip(trace.dev_s.tolist(), trace.dev_e.tolist(), trace.dev_n)
            if is_attention_op(name)]
