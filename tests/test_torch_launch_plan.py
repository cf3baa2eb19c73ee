"""The fused exchange kernel's launch plan, on the CPU.

``ops/cuda_exchange.py:launch_plan`` decides how ``csrc/fused_exchange.cu``
is launched: CTAs per cluster, which per-turn matrices live in shared
memory, and the carve (a tile is ``ROWS`` batch rows). The kernel recomputes the
carve from the int table and refuses a plan that disagrees; these tests
hold the Python side to the budget and to the C source's table orders,
without a GPU.
"""

import re
from pathlib import Path

import pytest

from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.ops import cuda_build
from multimodalgame_tpu_torch.ops.cuda_exchange import (
    CLUSTER_CHOICES, CTA_BARRIERS, DESC_CHUNK, DIM_ORDER, EXCHANGES,
    HX_WARPS, IH_WARPS, MATRIX_ORDER, PHASES, PTR_ORDER, ROWS,
    SMEM_OPTIN_BYTES, THREADS, TRAIN_DIM_ORDER, _dims, launch_plan,
    padded_ld, plan_for, smem_layout, split_lanes)
from multimodalgame_tpu_torch.ops.philox import STREAMS

SOURCE = Path(cuda_build.CSRC) / "fused_exchange.cu"

# (F, H, W, R, D, V): canonical Adaptive, the flags' defaults with 70 and
# 1,000 classes, the kernel tests' SMALL, and one whose weights do not all
# fit in the shared memory of 8 CTAs.
CANONICAL = (512, 256, 32, 64, 30, 100)
CONFIGS = {
    "canonical": CANONICAL,
    "defaults_70": (4096, 100, 50, 128, 70, 100),
    "defaults_1000": (4096, 100, 50, 128, 1000, 100),
    "small": (64, 32, 16, 32, 5, 24),
    "too_large_for_8": (512, 512, 128, 512, 30, 100),
}
CASES = ([("canonical", b) for b in (1, 7, 64, 100)]
         + [(name, 37) for name in CONFIGS if name != "canonical"])


def _enum(name: str):
    """The names of ``enum <name> {...}`` in the kernel source, in order."""
    text = SOURCE.read_text()
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [item.split("=")[0].strip() for item in body.split(",")
            if item.strip()]


@pytest.mark.parametrize("name,batch", CASES)
def test_plan_fits_and_tiles_cover_the_batch(name, batch):
    plan = launch_plan(*CONFIGS[name], batch)
    assert plan.smem_bytes <= SMEM_OPTIN_BYTES
    assert plan.cluster in CLUSTER_CHOICES and plan.cluster <= 8
    assert plan.tiles * ROWS >= batch > (plan.tiles - 1) * ROWS
    # The carve the plan carries is the one smem_layout gives.
    offsets, nbytes = smem_layout(*CONFIGS[name], plan.cluster,
                                  plan.resident, plan.pull, plan.compact)
    assert (offsets, nbytes) == (plan.offsets, plan.smem_bytes)


@pytest.mark.parametrize("name,batch", CASES)
def test_every_matrix_is_placed_exactly_once(name, batch):
    plan = launch_plan(*CONFIGS[name], batch)
    placed = plan.resident + plan.in_device_memory
    assert sorted(placed) == sorted(MATRIX_ORDER)
    assert len(set(placed)) == len(MATRIX_ORDER)
    for m in MATRIX_ORDER:
        assert (m in plan.offsets) == (m in plan.resident)
    assert plan.resident_mask == sum(
        1 << i for i, m in enumerate(MATRIX_ORDER) if m in plan.resident)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_regions_are_aligned_and_disjoint(name):
    plan = launch_plan(*CONFIGS[name], 37)
    starts = sorted(plan.offsets.values())
    assert starts[0] == 0 and len(set(starts)) == len(starts)
    assert all(o % 4 == 0 for o in starts)
    assert 4 * starts[-1] < plan.smem_bytes


def test_which_configs_keep_every_matrix_in_shared_memory():
    assert launch_plan(*CANONICAL, 64).in_device_memory == ()
    assert launch_plan(*CONFIGS["defaults_70"], 37).in_device_memory == ()
    for name in ("defaults_1000", "too_large_for_8"):
        plan = launch_plan(*CONFIGS[name], 37)
        assert plan.cluster == 8 and plan.pull and plan.in_device_memory


def test_a_plan_that_does_not_fit_is_refused():
    with pytest.raises(ValueError):
        launch_plan(*CANONICAL, 64, smem_limit=16 * 1024)
    with pytest.raises(ValueError):
        launch_plan(4096, 2048, 512, 1024, 100, 300, 64)
    with pytest.raises(ValueError):
        launch_plan(*CANONICAL, 0)


@pytest.mark.parametrize("batch", [1, 3, 4, 5, 63, 64, 65, 1000])
def test_tiles_cover_every_batch_size(batch):
    plan = launch_plan(*CANONICAL, batch)
    assert plan.tiles == -(-batch // ROWS)
    assert plan.cluster == CLUSTER_CHOICES[0]
    assert plan.in_device_memory == ()


# The flags' defaults (F 4096, H 100, W 50, R 128, wv 100) as the classes
# grow: 4 CTAs while they hold everything, then 8, then 8 with the score
# partials read remotely, then without bank padding, then matrices left
# in device memory.
@pytest.mark.parametrize("classes", [10, 70, 150, 300, 500, 1000])
def test_fallbacks_come_in_order(classes):
    plan = launch_plan(4096, 100, 50, 128, classes, 100, 37)
    rank = (plan.cluster > 4) + plan.pull + plan.compact + (
        len(plan.in_device_memory) > 0)
    smaller = launch_plan(4096, 100, 50, 128, classes // 2, 100, 37)
    rank_smaller = (smaller.cluster > 4) + smaller.pull + smaller.compact + (
        len(smaller.in_device_memory) > 0)
    assert rank >= rank_smaller
    # Each step is taken only when the one before it does not fit.
    assert not plan.pull or plan.cluster == 8
    assert not plan.compact or plan.pull
    assert not plan.in_device_memory or plan.compact
    assert plan.smem_bytes <= SMEM_OPTIN_BYTES


def test_tables_follow_the_kernel_source():
    ptrs = _enum("Ptr")
    assert ptrs[:ptrs.index("P_COUNT")] == ["P_" + p.upper()
                                            for p in PTR_ORDER]
    dims = _enum("Dim")
    assert dims[:dims.index("D_COUNT")] == ["D_" + d for d in DIM_ORDER]
    assert dims[dims.index("D_COUNT") + 1:-1] == ["D_" + d for d in
                                                  TRAIN_DIM_ORDER]
    assert _enum("Mat")[:-1] == ["M_" + m.upper() for m in MATRIX_ORDER]
    assert len(_enum("Exchange")) - 1 == EXCHANGES
    text = SOURCE.read_text()
    for name, value in (("THREADS", THREADS), ("ROWS", ROWS),
                        ("DESC_CHUNK", DESC_CHUNK), ("HX_WARPS", HX_WARPS),
                        ("IH_WARPS", IH_WARPS)):
        assert int(re.search(r"constexpr int %s = (\d+);" % name,
                             text).group(1)) == value
    # A turn's links: one wait per exchange, and CTA_BARRIERS CTA barriers
    # besides turn 0's wait for the staged weights.
    loop = text[text.index("for (int t = 0; t < a.T; ++t) {"):
                text.index("PHASE_MARK(PH_REPLY);")]
    loop = re.sub(r"if \(t == 0\) \{[^}]*\}", "", loop)
    assert len(set(re.findall(r"exchange_wait\(bars \+ (X_\w+)", loop))
               ) == EXCHANGES
    assert loop.count("__syncthreads();") == CTA_BARRIERS
    assert _enum("Phase")[:-1] == ["PH_" + p for p in (
        "SETUP", "SENDER", "BINARY", "GRU", "HEADS", "SCORES", "QUERY",
        "REPLY")] and len(PHASES) == 8
    streams = _enum("Stream")[:-1]
    assert [s.split()[0] for s in streams] == [
        "S_" + n.upper() for n in sorted(STREAMS, key=STREAMS.get)]


def test_int_table_carries_the_plan():
    cfg = GameConfig(img_feat_dim=512, img_h_dim=256, sender_out_dim=32,
                     rec_w_dim=32, rec_hidden=64, wv_dim=100,
                     max_exchange=10)
    plan = plan_for(cfg, 64, 30)
    dims = dict(zip(DIM_ORDER, _dims(cfg, 64, 30, plan)))
    assert (dims["B"], dims["D"], dims["T"]) == (64, 30, 10)
    assert (dims["CLUSTER"], dims["SMEM_BYTES"]) == (plan.cluster,
                                                     plan.smem_bytes)
    assert "ROWS" not in DIM_ORDER and plan.tiles == 64 // ROWS
    assert dims["RESIDENT"] == plan.resident_mask == 2 ** 7 - 1


@pytest.mark.parametrize("nc,k", [(128, 32), (32, 256), (96, 32), (32, 100),
                                  (13, 50), (50, 13), (1, 64), (300, 4)])
@pytest.mark.parametrize("nw", [3, 4, 5, 8])
def test_padded_rows_put_a_warp_on_32_banks(nc, k, nw):
    """A warp of a split-K product reads w[kk * ld + j] with lane =
    column * S + slice and kk = slice + S * i: with the padded stride its
    32 lanes hit 32 banks (or share one word). S gives every column its
    lanes in one pass over the nw warps where the lanes suffice."""
    s = split_lanes(nc, k, nw)
    assert s & (s - 1) == 0 and 1 <= s <= 32 and s <= max(k, 1)
    assert s == 1 or nc * s <= 32 * nw
    ld = padded_ld(nc, 32 // s)
    assert nc <= ld < nc + 32
    for base in (0, 32 // s):
        words = {((lane % s) * ld + base + lane // s) for lane in range(32)}
        banks = {w % 32 for w in words}
        assert len(banks) == len(words)
