"""Operations and bytes of the image tower, torchvision's ResNet-34 (He et
al., arXiv:1512.03385), from the shapes of its layers, and the rule by
which a traced serving window's device operations are the tower's.

Operations: the multiply-adds of every convolution (and of ``fc`` where
the tap asks for it), two operations each; pooling, batch norm, ReLU and
the shortcut sums are not counted (a float32 roofline of a network is
its products'). Bytes: every weight once (convolutions, each batch
norm's scale and shift, ``fc``), and each counted layer's float32 input
read once and output written once; batch norm, ReLU and the sums are
taken as fused into the convolution before them. At 227x227 an image is
8.30 GFLOP: conv1 to 114x114, the max pool to 57x57, stages at 57, 29, 15
and 8.
"""

from typing import Dict, List

from gamebench.counts import PEAK_BYTES, PEAK_F32_FLOPS
from gamebench.kernels import EVAL_KERNEL

STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def layers(size: int, tap: str = "avgpool_512") -> List[Dict]:
    """The counted layers of one image's forward to ``tap``: ``name``,
    ``flops``, ``weights`` (floats), ``inputs`` and ``outputs`` (floats)."""
    out: List[Dict] = []

    def conv(name, c_in, c_out, n, k, s, p):
        m = _out(n, k, s, p)
        out.append({"name": name, "flops": 2 * c_out * m * m * c_in * k * k,
                    "weights": c_out * c_in * k * k + 2 * c_out,
                    "inputs": c_in * n * n, "outputs": c_out * m * m})
        return m

    n = conv("conv1", 3, 64, size, 7, 2, 3)
    m = _out(n, 3, 2, 1)
    out.append({"name": "maxpool", "flops": 0, "weights": 0,
                "inputs": 64 * n * n, "outputs": 64 * m * m})
    n, c_in = m, 64
    for i, (blocks, c, stride) in enumerate(STAGES, start=1):
        for b in range(blocks):
            s = stride if b == 0 else 1
            pre = f"layer{i}.{b}"
            m = conv(pre + ".conv1", c_in, c, n, 3, s, 1)
            conv(pre + ".conv2", c, c, m, 3, 1, 1)
            if s != 1 or c_in != c:
                conv(pre + ".downsample", c_in, c, n, 1, s, 0)
            n, c_in = m, c
    if tap != "layer4_2":   # the last block's sum, before the pool
        out.append({"name": "avgpool", "flops": 0, "weights": 0,
                    "inputs": 512 * n * n, "outputs": 512})
    if tap == "fc":
        out.append({"name": "fc", "flops": 2 * 512 * 1000,
                    "weights": 512 * 1000 + 1000, "inputs": 512,
                    "outputs": 1000})
    return out


def tower_work(batch: int, size: int, tap: str = "avgpool_512") -> dict:
    """Operations and bytes of ``batch`` images' forward to ``tap``, and
    the bound: the larger of operations over the float32 peak and bytes
    over the HBM peak."""
    table = layers(size, tap)
    flops = batch * sum(x["flops"] for x in table)
    nbytes = 4 * (sum(x["weights"] for x in table)
                  + batch * sum(x["inputs"] + x["outputs"] for x in table))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def is_tower_op(name: str) -> bool:
    """Whether a device operation of a traced pixel-serving window is the
    tower's: every one but the eval kernel and the copies and memsets
    (the input's staging and the answer's copies). The few small kernels
    of the eval graph around the kernel (the weight pack, the stop masks,
    the answer) count with the tower: a few hundredths of a millisecond
    a request against tens of milliseconds."""
    return not (name.startswith(("Memcpy", "Memset"))
                or any(k in name for k in EVAL_KERNEL))


def tower_times(trace) -> List[float]:
    """Seconds of each of the trace's tower operations (every one,
    wherever its start falls, as ``trace.Trace.kernel_times`` counts)."""
    return [(e - s) * 1e-9 for s, e, name in
            zip(trace.dev_s.tolist(), trace.dev_e.tolist(), trace.dev_n)
            if is_tower_op(name)]
