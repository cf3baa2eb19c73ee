// Whole conversation of the MultimodalGame in one CUDA kernel, in its two
// modes, as multimodalgame_tpu/ops/pallas_exchange.py:_kernel shares one
// body between them through `train` (here the template parameter TRAIN).
//
// Eval mode replaces _kernel with train=False (reached through
// fused_eval_exchange, pallas_exchange.py:265): every turn rounds the
// sender's bits with floor(p + 0.5), flips the corrupt bits, steps the
// receiver's GRU, rounds the (cumulative) stop probability, scores every
// class, mixes the descriptions by the softmax of the scores and rounds the
// receiver's query.
//
// Train mode replaces _kernel with train=True (reached through
// fused_train_forward, pallas_exchange.py:278, phase A of every training
// step): the same products, with Bernoulli bits u < p for the message, the
// stop bit and the query, flipout (|bit - (u' < p_flip)|) on both channels
// when configured, ignore_receiver after flipout, and no cumulative stop
// product. The TPU kernel draws u from the core's own generator
// (_uniform01); this one takes u either as pre-drawn input streams (the
// tests' bit-exact parity with the plain exchange) or from Philox4x32-10
// keyed by (seed, step), with the counter (column / 4, global row, turn,
// stream) and word column % 4, so the numbers depend neither on the row
// tiling nor on the batch size (ops/philox.py is its plain version). A
// launch over a data-parallel shard of a batch numbers its row r as the
// global row row_base + r, so the shards draw the whole batch's numbers.
//
// What bounds it on an H100: not bytes and not FLOPs. At the canonical
// Adaptive dims (feat 512, sender hidden 256, 32-bit messages, receiver
// hidden 64, wv 100, 30 classes, 10 turns) a batch of 64 needs ~89 MFLOP
// and ~1.3 MB of traffic, about 1.4 us of either. The conversation is a
// serial chain (each turn feeds its bits to the next) of 11 links a turn:
// 7 products, each ended by a CTA barrier or an exchange between CTAs, and
// the element-wise steps between them. It is bound by the latency of that
// chain: loads, reductions and barriers, and the integer work of each
// link.
//
// The design, to shorten each link:
//
// * A thread-block cluster of C CTAs (4, or 8 where 4 do not hold the
//   weights; portable sizes) owns a tile of ROWS = 4 batch rows for the
//   whole conversation. CTA c owns the columns
//   [c*hc, (c+1)*hc) of the sender's hidden width H and [c*rc, (c+1)*rc)
//   of the receiver's R (hc = ceil(H/C), rc = ceil(R/C)).
// * Its slice of every per-turn matrix lives in shared memory for the
//   whole launch: the column slices of wcode, of the GRU's three gates of
//   wih/whh, of y1h and whk, the row (k) slices of wbin and wk, the biases,
//   y2k and all of sk. They are staged once at kernel start by cp.async
//   spread over the CTA's threads, 16 bytes a copy (4 where a row is not a
//   16-byte multiple, as with widths of 50 or 100 in some slices), in two
//   groups in the order of first use: the sender's, which turn 0 waits
//   for, then the rest. Each matrix sits at a padded row stride that puts
//   a warp's 32 lanes on 32 banks. (One bulk copy (TMA) a row, on an
//   mbarrier, took as long: a few hundred rows of 64-256 bytes each.)
// * Every product is split-K: S lanes of a warp share one output column,
//   each walks every S-th k, and the S partial sums meet through
//   __shfl_xor_sync. S is the largest that still gives every column its
//   lanes in one pass over the product's warps (split_lanes), fixed per
//   product at kernel start.
//   The row-local epilogue (bias, tanh mix, GRU gate inputs, tanh of the
//   query) runs in the lane that holds the sum. Independent products share
//   the CTA: z W_ih beside h W_hh, y1_h beside w_h, h_x beside desc_proj.
// * Products whose k is split over the cluster (wbin over the sender's
//   slice, the class scores over the receiver's, wk over the query's)
//   push their partial sums, and the GRU its new state, into every CTA's
//   shared memory with st.async, which counts the bytes on the receiving
//   CTA's mbarrier of that exchange; a CTA waits for its own mbarrier's
//   phase of the turn, then adds the C slots in rank order, so every CTA
//   computes the same sums and samples the bits itself. No cluster-wide
//   barrier and no device-wide fence in the turn loop. A turn has 4 such
//   exchanges and 7 CTA barriers (ops/cuda_exchange.py:EXCHANGES,
//   CTA_BARRIERS).
// * Set-up is spread over the cluster: CTA c computes its h_x columns
//   (data W_img + b, W_img read from device memory 16 bytes at a time) on
//   HX_WARPS warps, and beside them on the others its columns of desc_proj
//   = desc y1_d and of desc w_d (the query's description term is
//   p (desc w_d) instead of (p desc) w_d: the same sum, associated so that
//   a conversation-invariant product leaves the turn) from its [y1_d | w_d]
//   slices and DESC_CHUNK classes of desc at a time, both staged in shared
//   memory; and turn 0's code input sigmoid(code_bias) for every row.
//   Nothing moves to cuBLAS. The set-up moves ~250 KB into each SM (the
//   weight slices, W_img's slice, desc); that, not its arithmetic, sets
//   its time.
// * Train mode: each turn's uniforms are drawn (one Philox call per 4
//   columns) or copied (cp.async) into shared memory at the start of the
//   turn, off the chain; the compares read shared memory.
//
// The host computes the plan (ops/cuda_exchange.py:launch_plan: C, which
// matrices are resident, the carve) and passes it in the
// int table; make_layout here recomputes the carve, and the launch fails
// with cudaErrorInvalidValue when the two disagree or the carve exceeds
// the device's opt-in shared memory, and with
// cudaErrorInvalidConfiguration when no cluster of that size fits. A
// matrix that the plan leaves out is read from device memory through __ldg
// by the same code. Budget (ops/cuda_exchange.py:smem_layout): at the
// canonical dims 105,696 B a CTA at C = 4 (measured faster at batch 64 than
// clusters of 1, 2 and 8 CTAs and tiles of 8 and 16 rows); at the defaults
// (F 4096, H 100, W 50, R 128) with 70 classes 219,456 B at C = 4; with
// 1,000 classes only C = 8 with wih, whh, y1h and whk in device memory
// fits.
//
// Everything is f32 on CUDA cores: no TF32, no bf16. Split-K, the cluster
// sums, the reassociated query term and the reciprocal in the sigmoid and
// the softmax change the order of rounding; compare_outputs' tolerances
// hold it against the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 4;        // batch rows of a tile (ops/cuda_exchange.py:ROWS)
// Set-up: classes of the descriptions staged at a time, and the warps that
// compute h_x ([0, HX_WARPS)) beside desc_proj and desc w_d (the others).
constexpr int DESC_CHUNK = 16;
constexpr int HX_WARPS = 4;
// Warps of z W_ih in the GRU; h W_hh (twice the k) takes the others.
constexpr int IH_WARPS = 3;
constexpr int DESC_WARPS = NWARPS - HX_WARPS;
constexpr unsigned FULL = 0xffffffffu;

enum Mix { MIX_SUM = 0, MIX_PROD = 1, MIX_IGNORE_CODE = 2 };

// Order of the pointer table handed over by the Python wrapper
// (ops/cuda_exchange.py:PTR_ORDER, then in train mode the five uniform
// streams, null where absent).
enum Ptr {
  P_DATA, P_DESC, P_CORRUPT,
  P_WIMG, P_BIMG, P_WCODE, P_BCODE, P_CBIAS, P_WBIN, P_BBIN,
  P_WIH, P_WHH, P_BIH, P_BHH,
  P_Y1H, P_Y1D, P_Y1B, P_Y2K, P_Y2B,
  P_SK, P_SB, P_WHK, P_WHB, P_WDK, P_WK, P_WB,
  P_O_SFEAT, P_O_SPROB, P_O_ZFEAT, P_O_ZPROB, P_O_WFEAT, P_O_WPROB,
  P_O_Y, P_O_MASK,
  P_COUNT,
  P_U_FIRST = P_COUNT,
  // Train mode: the Philox key [seed, step, row_base] as three int64 in
  // device memory, or null for the key in the int table.
  P_KEY = P_U_FIRST + 5,
  P_TRAIN_COUNT
};

// Uniform streams, numbered as the JAX exchange orders its per-turn keys
// (game/exchange.py:155-180) and as ops/philox.py numbers them.
enum Stream { S_Z = 0, S_FZ = 1, S_S = 2, S_W = 3, S_FW = 4, S_COUNT = 5 };

// Order of the int table (ops/cuda_exchange.py:DIM_ORDER and
// TRAIN_DIM_ORDER): sizes, flags, the launch plan, then the train mode's
// entries.
enum Dim { D_B, D_F, D_H, D_W, D_R, D_D, D_V, D_T,
           D_MIX, D_IGNORE_RECEIVER, D_S_PROB_PROD,
           D_CLUSTER, D_RESIDENT, D_PULL, D_COMPACT, D_SMEM_BYTES,
           D_COUNT,
           D_PHILOX = D_COUNT, D_SEED, D_STEP, D_FLIP_SEN, D_FLIP_REC,
           D_ROW_BASE, D_TRAIN_COUNT };

// The per-turn matrices a plan may keep in shared memory: bit m of
// D_RESIDENT (ops/cuda_exchange.py:MATRIX_ORDER).
enum Mat { M_WCODE, M_WBIN, M_WIH, M_WHH, M_Y1H, M_WHK, M_WK, M_COUNT };

// The exchanges between the CTAs of a cluster, one mbarrier each.
enum Exchange { X_ZPART, X_H, X_SPART, X_WPART, X_COUNT };

// Per-phase clock stamps, compiled only with -DMMG_PHASE_CLOCKS: block 0's
// thread 0 sums clock64() deltas per phase over the turns, and every CTA
// folds its whole time into a max (read with mmg_phase_clocks).
enum Phase { PH_SETUP, PH_SENDER, PH_BINARY, PH_GRU, PH_HEADS, PH_SCORES,
             PH_QUERY, PH_REPLY, PH_COUNT };
#ifdef MMG_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[PH_COUNT + 1];
#define PHASE_START()                                  \
  long long ph_acc[PH_COUNT] = {};                      \
  const long long ph_first = clock64();                 \
  long long ph_prev = ph_first
#define PHASE_MARK(p)                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0) {           \
    const long long now = clock64();                   \
    ph_acc[p] += now - ph_prev;                        \
    ph_prev = now;                                     \
  }
#define PHASE_END()                                                     \
  if (threadIdx.x == 0) {                                               \
    atomicMax(g_phase_clocks + PH_COUNT,                                \
              static_cast<unsigned long long>(clock64() - ph_first));   \
    if (blockIdx.x == 0)                                                \
      for (int i = 0; i < PH_COUNT; ++i) g_phase_clocks[i] = ph_acc[i]; \
  }
#else
#define PHASE_START()
#define PHASE_MARK(p)
#define PHASE_END()
#endif

struct Args {
  const float* in[P_O_SFEAT];
  float* out[P_COUNT - P_O_SFEAT];
  const float* u[S_COUNT];     // train mode, pre-drawn uniforms (T, B, dim)
  const long long* key;        // train mode, device key [seed, step, row_base]
  int B, F, H, W, R, D, V, T, mix, ignore_receiver, s_prob_prod;
  int cluster, resident, pull, compact, smem_bytes;
  int philox, flip_sen, flip_rec;
  int row_base;                // global row of the launch's row 0 (Philox)
  unsigned seed, step;
  float p_flip_sen, p_flip_rec;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Lanes that share one output column of a split-K product on nw warps: the
// largest power of two up to 32 and up to k that still gives every column
// its lanes in one pass over the warps (1 when the columns outnumber the
// lanes) (ops/cuda_exchange.py:split_lanes).
__host__ __device__ inline int split_lanes(int nc, int k, int nw) {
  int s = 1;
  while (s < 32 && 2 * s <= k && nc * 2 * s <= 32 * nw) s *= 2;
  return s;
}

// Least row stride >= n that is m modulo 32 (n when m is 0 modulo 32)
// (ops/cuda_exchange.py:padded_ld).
__host__ __device__ inline int padded_ld(int n, int m) {
  m %= 32;
  if (m == 0) return n;
  return n + ((m - n % 32) % 32 + 32) % 32;
}

// Shared-memory carve of one CTA, in floats (-1: not resident).
// ops/cuda_exchange.py:smem_layout computes the same.
struct Layout {
  int hc, rc, bars;
  int mat[M_COUNT], ld[M_COUNT];
  int bcode, bbin, bih, bhh, y1b, whb, sk, y2k, wb, corrupt;
  int dp, ld_dp, dw, ld_dw, dstage, wd, ld_wd;
  int hx, mix, wbits, zbits, zpart, h, gi, gh, y1, wh, stop, spart, p, hq,
      wpart, mask, sprod, u;
  int total;
};

__host__ __device__ inline Layout make_layout(const Args& a) {
  Layout L;
  const int C = a.cluster, rows = ROWS;
  L.hc = ceil_div(a.H, C);
  L.rc = ceil_div(a.R, C);
  const int hc = L.hc, rc = L.rc, W = a.W, R = a.R, D = a.D;
  const int mk[M_COUNT] = {W, hc, W, R, R, R, rc};
  const int mn[M_COUNT] = {hc, W, 3 * rc, 3 * rc, rc, rc, W};
  const int mw[M_COUNT] = {NWARPS, NWARPS, IH_WARPS, NWARPS - IH_WARPS,
                           NWARPS / 2, NWARPS / 2, NWARPS};   // product warps
  int o = 0;
  auto take = [&o](int n) {
    const int at = o;
    o += ceil_div(n, 4) * 4;     // every region 16-byte aligned
    return at;
  };
  L.bars = take(2 * X_COUNT);              // 8-byte mbarriers
  for (int m = 0; m < M_COUNT; ++m) {
    L.ld[m] = padded_ld(mn[m], 32 / split_lanes(mn[m], mk[m], mw[m]));
    L.mat[m] = (a.resident >> m) & 1 ? take(mk[m] * L.ld[m]) : -1;
  }
  L.ld_dp = a.compact ? rc : padded_ld(rc, split_lanes(rows * D, rc, NWARPS));
  L.ld_dw = a.compact ? rc : padded_ld(rc, 32 / split_lanes(rc, D, NWARPS));
  L.ld_wd = a.compact ? 2 * rc
                      : padded_ld(2 * rc, 32 / split_lanes(2 * rc, a.V, DESC_WARPS));
  L.bcode = take(hc);
  L.bbin = take(W);
  L.bih = take(3 * rc);
  L.bhh = take(3 * rc);
  L.y1b = take(rc);
  L.whb = take(rc);
  L.sk = take(R);
  L.y2k = take(rc);
  L.wb = take(W);
  L.corrupt = take(W);
  L.dp = take(D * L.ld_dp);
  L.dw = take(D * L.ld_dw);
  L.dstage = take(DESC_CHUNK * a.V);
  L.wd = take(a.V * L.ld_wd);
  L.hx = take(rows * hc);
  L.mix = take(rows * hc);
  L.wbits = take(rows * W);
  L.zbits = take(rows * W);
  L.zpart = take(C * rows * W);
  L.h = take(2 * rows * R);
  L.gi = take(rows * 3 * rc);
  L.gh = take(rows * 3 * rc);
  L.y1 = take(rows * rc);
  L.wh = take(rows * rc);
  L.stop = take(rows);
  L.spart = take((a.pull ? 1 : C) * rows * D);
  L.p = take(rows * D);
  L.hq = take(rows * rc);
  L.wpart = take(C * rows * W);
  L.mask = take(rows);
  L.sprod = take(rows);
  L.u = take(rows * (4 * W + 1));
  L.total = o;
  return L;
}

// 1 / (1 + e^-|x|) through the correctly rounded reciprocal, mirrored for
// x < 0: no division subroutine on the chain.
__device__ __forceinline__ float sigmoid_f(float x) {
  const float r = __frcp_rn(1.f + expf(-fabsf(x)));
  return x >= 0.f ? r : 1.f - r;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ---- Exchanges between the CTAs of a cluster ----
//
// A value pushed to every CTA goes out as one st.async per CTA, which
// counts its 4 bytes on that CTA's mbarrier of the exchange; a CTA waits
// for the turn's phase of its own mbarrier, armed with the bytes the whole
// cluster sends it. No cluster-wide barrier, no device-wide fence.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void push_all(float* p, float v,
                                         unsigned long long* bar, int C) {
  const unsigned a = smem_addr(p), b = smem_addr(bar);
  for (int q = 0; q < C; ++q) {
    unsigned ra, rb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(ra) : "r"(a), "r"(q));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(rb) : "r"(b), "r"(q));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
        "[%0], %1, [%2];" :: "r"(ra), "f"(v), "r"(rb) : "memory");
  }
}

// Wait for phase `parity` of an mbarrier of this CTA.
__device__ __forceinline__ void wait_phase(unsigned long long* bar,
                                           int parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster."
        "shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void arrive(unsigned long long* bar,
                                       unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 "
               "_, [%0], %1;" :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void exchange_wait(unsigned long long* bar,
                                              int parity, unsigned bytes) {
  if (threadIdx.x == 0) arrive(bar, bytes);
  wait_phase(bar, parity);
}

// The set-up's barrier of the warps that compute the description products
// (named barrier 1; __syncthreads() is barrier 0).
__device__ __forceinline__ void desc_barrier() {
  asm volatile("bar.sync 1, %0;" :: "n"(32 * DESC_WARPS) : "memory");
}

// ---- Asynchronous copies into shared memory ----

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- Weight access: a CTA's slice of a (kg, n) row-major matrix ----

// In device memory: element (k, j) of the slice is row k0 + k and column
// c0 + j (GATES: column j of gate j / sub is g * gstride + c0 + j % sub,
// the GRU's [r | z | n] blocks). Indices past the matrix are clamped (the
// callers zero those inputs or drop those outputs).
template <bool GATES>
struct GlobalW {
  const float* p;
  int n, k0, kmax, c0, cmax, sub, gstride;
  __device__ __forceinline__ size_t index(int k, int j) const {
    int g = 0, jr = j;
    if (GATES) {
      g = j / sub;
      jr = j - g * sub;
    }
    const int kk = min(k0 + k, kmax - 1);
    const int col = g * gstride + min(c0 + jr, cmax - 1);
    return static_cast<size_t>(kk) * n + col;
  }
  __device__ __forceinline__ float operator()(int k, int j) const {
    return __ldg(p + index(k, j));
  }
};

__device__ __forceinline__ GlobalW<false> slice(const float* p, int n,
                                                int k0, int kmax, int c0,
                                                int cmax) {
  return GlobalW<false>{p, n, k0, kmax, c0, cmax, 1, 0};
}

// In shared memory, staged from a GlobalW at a padded row stride.
struct SharedW {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int k, int j) const {
    return p[k * ld + j];
  }
};

// Copy the (k_dim, nc) slice into dst at row stride ld, by cp.async in the
// calling thread's open group, spread over the CTA's threads: 16 bytes a
// copy where every row segment (of every gate block) is 16-byte aligned and
// a multiple of 16 bytes long, else 4 bytes; zeros past the matrix. Only
// threads [t0, t0 + nt) take part.
template <bool GATES>
__device__ void stage(float* dst, int ld, int k_dim, int nc,
                      const GlobalW<GATES>& g, int t0 = 0, int nt = THREADS) {
  const int me = static_cast<int>(threadIdx.x) - t0;
  if (me < 0 || me >= nt) return;
  const int sub = GATES ? g.sub : nc, gates = GATES ? nc / g.sub : 1;
  const int gstride = GATES ? g.gstride : 0;
  const int valid = max(0, min(sub, g.cmax - g.c0));   // columns in the matrix
  const bool wide = (ld | sub | valid | g.c0 | g.n | gstride) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(g.p) % 16 == 0 &&
                    smem_addr(dst) % 16 == 0;
  const int vw = wide ? 4 : 1;                         // floats a copy
  const int per_row = ceil_div(sub, vw);
  for (int i = me; i < k_dim * gates * per_row; i += nt) {
    const int row = i / per_row, c = (i - row * per_row) * vw;
    const int k = row / gates, gate = row - k * gates;
    float* d = dst + k * ld + gate * sub + c;
    if (g.k0 + k < g.kmax && c < valid) {
      const float* src = g.p + static_cast<size_t>(g.k0 + k) * g.n +
                         gate * gstride + g.c0 + c;
      if (wide) cp_async16(d, src);
      else cp_async4(d, src);
    } else {
      for (int e = 0; e < vw; ++e) d[e] = 0.f;
    }
  }
}

// A split-K product's lanes: S = 2^lg lanes share a column
// (split_lanes(nc, k, nw)), and this lane walks `steps` of the k. Computed
// once per product at kernel start, not in every turn.
struct Split {
  int lg, steps;
};

__device__ __forceinline__ Split make_split(int nc, int k, int nw) {
  const int S = split_lanes(nc, k, nw), lg = __ffs(S) - 1;
  const int s = threadIdx.x & (S - 1);
  return Split{lg, (k - s + S - 1) >> lg};
}

// out(r, j) = sum_k in[r * ldi + k] * w(k, j) for the rows r < nin of NR
// rows and the nc columns j, split-K: S = 2^sp.lg lanes
// (lane = column * S + slice) walk every S-th k and meet by
// __shfl_xor_sync; epi(r, j, sum) runs once per (r, j) < (NR, nc), in
// lane r % S of the column's group (rows >= nin repeat row nin - 1).
// Warps [w0, w0 + nw) take part; the others return at once, so two
// independent products can run side by side on two halves of the CTA.
template <int NR, class WF, class Epi>
__device__ __forceinline__ void product(const Split& sp, const float* in,
                                        int ldi, int nin, const WF& w,
                                        int nc, Epi epi, int w0 = 0,
                                        int nw = NWARPS) {
  const int lg = sp.lg, S = 1 << lg, steps = sp.steps;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0;
  if (warp < 0 || warp >= nw) return;
  const int s = lane & (S - 1), jj = lane >> lg, JW = 32 >> lg;
  for (int base = warp * JW; base < nc; base += nw * JW) {
    const int j = base + jj;
    float acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.f;
    if (j < nc) {
#pragma unroll 4
      for (int i = 0; i < steps; ++i) {
        const int k = s + (i << lg);
        const float wv = w(k, j);
        // Rows past nin repeat the last row (no branch between the loads).
#pragma unroll
        for (int r = 0; r < NR; ++r)
          acc[r] = fmaf(in[min(r, nin - 1) * ldi + k], wv, acc[r]);
      }
    }
    for (int o = 1; o < S; o <<= 1) {
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] += __shfl_xor_sync(FULL, acc[r], o);
    }
    // Lane s finishes rows s, s + S, ...: one copy of the epilogue, run by
    // all lanes at once.
    if (j < nc) {
#pragma unroll 1
      for (int r = s; r < NR; r += S) {
        float v = acc[0];
#pragma unroll
        for (int q = 1; q < NR; ++q)
          if (q == r) v = acc[q];
        epi(r, j, v);
      }
    }
  }
}

// h_x = data W_img + b_img for this CTA's hidden columns [h0, h0 + hc)
// (0 past H), on warps [w0, w0 + nw). Where W_img's slice is 16-byte
// aligned, a lane owns 4 adjacent columns and reads them in one 16-byte
// load per k (k split over S lanes, the partial sums met by shuffles),
// which keeps 4x the bytes in flight of one column per lane; else the
// scalar split-K product.
__device__ void image_projection(const Args& a, float* s_hx, int hc, int h0,
                                 int row0, int nrows, int w0, int nw) {
  const int F = a.F, H = a.H;
  const float* x = a.in[P_DATA] + static_cast<size_t>(row0) * F;
  const float* wimg = a.in[P_WIMG];
  const float* bimg = a.in[P_BIMG];
  auto epi = [&](int r, int j, float acc) {
    s_hx[r * hc + j] = h0 + j < H ? acc + __ldg(bimg + h0 + j) : 0.f;
  };
  if (H % 4 != 0 || hc % 4 != 0 ||
      reinterpret_cast<uintptr_t>(wimg) % 16 != 0) {
    product<ROWS>(make_split(hc, F, nw), x, F, nrows, slice(wimg, H, 0, F, h0, H),
                  hc, epi, w0, nw);
    return;
  }
  const int quads = hc / 4, H4 = H / 4;
  const int S = split_lanes(quads, F, nw), lg = __ffs(S) - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0;
  if (warp < 0 || warp >= nw) return;
  const int s = lane & (S - 1), jq = lane >> lg, QW = 32 >> lg;
  const int steps = (F - s + S - 1) >> lg;
  const float4* w4 = reinterpret_cast<const float4*>(wimg + h0);
  for (int base = warp * QW; base < quads; base += nw * QW) {
    const int q = base + jq;
    // Columns past H (the last CTA's slice) read a clamped quad; a CTA
    // whose slice starts past H reads nothing.
    const int qc = min(q, (H - h0) / 4 - 1);
    const bool load = q < quads && h0 < H;
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    if (load) {
#pragma unroll 8
      for (int i = 0; i < steps; ++i) {
        const int k = s + (i << lg);
        const float4 wv = __ldg(w4 + static_cast<size_t>(k) * H4 + qc);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv =
              __ldg(x + static_cast<size_t>(min(r, nrows - 1)) * F + k);
          acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
          acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
          acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
        }
      }
    }
    for (int o = 1; o < S; o <<= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += __shfl_xor_sync(FULL, acc[r][c], o);
    }
    if (q < quads) {
#pragma unroll 1
      for (int i = s; i < 4 * ROWS; i += S) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (r * 4 + c == i) v = acc[r][c];
        epi(i / 4, 4 * q + i % 4, v);
      }
    }
  }
}

// The product through the shared copy of matrix m where the plan made it
// resident, else through its device-memory slice.
template <bool GATES, class Epi>
__device__ __forceinline__ void product_of(const Layout& L, int m,
                                           const float* smem,
                                           const Split& sp,
                                           const float* in, int ldi,
                                           const GlobalW<GATES>& g, int nc,
                                           Epi epi, int w0 = 0,
                                           int nw = NWARPS) {
  if (L.mat[m] >= 0)
    product<ROWS>(sp, in, ldi, ROWS, SharedW{smem + L.mat[m], L.ld[m]}, nc,
                  epi, w0, nw);
  else
    product<ROWS>(sp, in, ldi, ROWS, g, nc, epi, w0, nw);
}

// Partial class scores over this CTA's rc receiver columns:
// epi(r, d, sum_k relu(y1[r, k] + dp[d, k]) * y2k[k]) for every (r, d) <
// (ROWS, D); S = split_lanes(ROWS * D, rc, NWARPS) lanes per pair.
template <class Epi>
__device__ __forceinline__ void scores_partial(const Split& sp,
                                               const float* y1,
                                               const float* dp, int ld_dp,
                                               const float* y2k, int rc,
                                               int D, Epi epi) {
  const int pairs = ROWS * D;
  const int lg = sp.lg, S = 1 << lg, steps = sp.steps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = lane & (S - 1), pg = lane >> lg, PW = 32 >> lg;
  for (int base = warp * PW; base < pairs; base += NWARPS * PW) {
    const int i = base + pg;
    const int r = i / D, d = i - r * D;
    float acc = 0.f;
    if (i < pairs) {
#pragma unroll 4
      for (int n = 0; n < steps; ++n) {
        const int k = s + (n << lg);
        acc = fmaf(fmaxf(y1[r * rc + k] + dp[d * ld_dp + k], 0.f), y2k[k],
                   acc);
      }
    }
    for (int o = 1; o < S; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (i < pairs && s == 0) epi(r, d, acc);
  }
}

// Philox4x32 with 10 rounds (Salmon et al., SC'11; Random123's constants).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// 24 random bits as a float in [0, 1), exact (as _uniform01 makes them).
__device__ __forceinline__ float unit24(unsigned bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// The uniforms of turn t for the tile's rows < nrows into shared memory,
// four blocks of (ROWS, W) (z, fz, w, fw) and one of ROWS (s): drawn by
// Philox (one call per 4 columns, the row counted from the row base) or
// copied from the given streams with cp.async (in the calling thread's
// open group). Streams the config does not use are skipped. The Philox
// key (seed, step, row base) is the int table's, or, with a.key, read
// from device memory, where the stream's earlier work wrote it (a
// captured training step's own step counter), and then the same for
// every turn of the launch.
__device__ void fill_uniforms(const Args& a, float* s_u, int t, int row0,
                              int nrows) {
  const int W = a.W, q4 = ceil_div(W, 4);
  const int stream_of[4] = {S_Z, S_FZ, S_W, S_FW};
  const bool used[4] = {true, a.flip_sen != 0, true, a.flip_rec != 0};
  if (a.philox) {
    const bool dev_key = a.key != nullptr;
    const uint2 key = dev_key ? make_uint2(static_cast<unsigned>(a.key[0]),
                                           static_cast<unsigned>(a.key[1]))
                              : make_uint2(a.seed, a.step);
    const int row_base = dev_key ? static_cast<int>(a.key[2]) : a.row_base;
    const unsigned grow0 = static_cast<unsigned>(row_base + row0);
    const int n = 4 * ROWS * q4 + ROWS;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      if (i >= 4 * ROWS * q4) {            // the stop stream, width 1
        const int r = i - 4 * ROWS * q4;
        if (r < nrows)
          s_u[4 * ROWS * W + r] = unit24(
              philox4x32_10(make_uint4(0u, grow0 + r, t, S_S), key).x);
        continue;
      }
      const int b = i / (ROWS * q4), rem = i - b * ROWS * q4;
      const int r = rem / q4, q = rem - r * q4;
      if (!used[b] || r >= nrows) continue;
      const uint4 x = philox4x32_10(
          make_uint4(q, grow0 + r, t, stream_of[b]), key);
      const unsigned words[4] = {x.x, x.y, x.z, x.w};
      float* dst = s_u + b * ROWS * W + r * W;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (4 * q + w < W) dst[4 * q + w] = unit24(words[w]);
    }
  } else {
    const int n = 4 * ROWS * W + ROWS;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      if (i >= 4 * ROWS * W) {
        const int r = i - 4 * ROWS * W;
        if (r < nrows)
          cp_async4(s_u + i, a.u[S_S] + static_cast<size_t>(t) * a.B + row0 + r);
        continue;
      }
      const int b = i / (ROWS * W), rem = i - b * ROWS * W;
      const int r = rem / W, j = rem - r * W;
      if (!used[b] || r >= nrows) continue;
      cp_async4(s_u + i, a.u[stream_of[b]] +
                (static_cast<size_t>(t) * a.B + row0 + r) * W + j);
    }
  }
}

template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
fused_exchange_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(a);
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster, rank = static_cast<int>(cluster.block_rank());
  const int F = a.F, H = a.H, W = a.W, R = a.R, D = a.D, V = a.V, B = a.B;
  const int hc = L.hc, rc = L.rc, h0 = rank * hc, r0 = rank * rc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = static_cast<int>(blockIdx.x) / C * ROWS;
  const int nrows = min(ROWS, B - row0);   // ragged last tile
  const bool writer = rank == 0;           // writes the tile's outputs

  float* s_bcode = smem + L.bcode;
  float* s_bbin = smem + L.bbin;
  float* s_bih = smem + L.bih;
  float* s_bhh = smem + L.bhh;
  float* s_y1b = smem + L.y1b;
  float* s_whb = smem + L.whb;
  float* s_sk = smem + L.sk;
  float* s_y2k = smem + L.y2k;
  float* s_wb = smem + L.wb;
  float* s_corrupt = smem + L.corrupt;
  float* s_dp = smem + L.dp;
  float* s_dw = smem + L.dw;
  float* s_dstage = smem + L.dstage;
  float* s_wd = smem + L.wd;
  float* s_hx = smem + L.hx;
  float* s_mix = smem + L.mix;
  float* s_wbits = smem + L.wbits;
  float* s_zbits = smem + L.zbits;
  float* s_zpart = smem + L.zpart;
  float* s_h = smem + L.h;
  float* s_gi = smem + L.gi;
  float* s_gh = smem + L.gh;
  float* s_y1 = smem + L.y1;
  float* s_wh = smem + L.wh;
  float* s_stop = smem + L.stop;
  float* s_spart = smem + L.spart;
  float* s_p = smem + L.p;
  float* s_hq = smem + L.hq;
  float* s_wpart = smem + L.wpart;
  float* s_mask = smem + L.mask;
  float* s_sprod = smem + L.sprod;
  float* s_u = smem + L.u;

  float* o_sfeat = a.out[P_O_SFEAT - P_O_SFEAT];
  float* o_sprob = a.out[P_O_SPROB - P_O_SFEAT];
  float* o_zfeat = a.out[P_O_ZFEAT - P_O_SFEAT];
  float* o_zprob = a.out[P_O_ZPROB - P_O_SFEAT];
  float* o_wfeat = a.out[P_O_WFEAT - P_O_SFEAT];
  float* o_wprob = a.out[P_O_WPROB - P_O_SFEAT];
  float* o_y = a.out[P_O_Y - P_O_SFEAT];
  float* o_mask = a.out[P_O_MASK - P_O_SFEAT];

  // This CTA's slices of the per-turn weights in device memory.
  const GlobalW<false> g_wcode = slice(a.in[P_WCODE], H, 0, W, h0, H);
  const GlobalW<false> g_wbin = slice(a.in[P_WBIN], W, h0, H, 0, W);
  const GlobalW<true> g_wih{a.in[P_WIH], 3 * R, 0, W, r0, R, rc, R};
  const GlobalW<true> g_whh{a.in[P_WHH], 3 * R, 0, R, r0, R, rc, R};
  const GlobalW<false> g_y1h = slice(a.in[P_Y1H], R, 0, R, r0, R);
  const GlobalW<false> g_whk = slice(a.in[P_WHK], R, 0, R, r0, R);
  const GlobalW<false> g_wk = slice(a.in[P_WK], W, r0, R, 0, W);
  const float sb = __ldg(a.in[P_SB]), y2b = __ldg(a.in[P_Y2B]);
  // This thread's first (row, column) of the (ROWS, W) and (ROWS, rc)
  // element loops, and each per-turn product's lane split, once.
  const int tid_rw = tid / W, tid_jw = tid % W;
  const int tid_rr = tid / rc, tid_jr = tid % rc;
  const Split sp_code = make_split(hc, W, NWARPS),
              sp_bin = make_split(W, hc, NWARPS),
              sp_ih = make_split(3 * rc, W, IH_WARPS),
              sp_hh = make_split(3 * rc, R, NWARPS - IH_WARPS),
              sp_head = make_split(rc, R, NWARPS / 2),
              sp_query = make_split(rc, D, NWARPS),
              sp_wk = make_split(W, rc, NWARPS),
              sp_scores = make_split(ROWS * D, rc, NWARPS);

  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + L.bars);
  if (tid == 0) {
    for (int x = 0; x < X_COUNT; ++x)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(bars + x)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  PHASE_START();
  // ---- Once per conversation ----
  // The set-up's own inputs first, by the warps that compute desc_proj and
  // desc w_d: this CTA's [y1_d | w_d] column slices and the first chunk of
  // the descriptions.
  const int dt0 = 32 * HX_WARPS, dtn = 32 * DESC_WARPS;   // their threads
  stage(s_wd, L.ld_wd, V, rc, slice(a.in[P_Y1D], R, 0, V, r0, R), dt0, dtn);
  stage(s_wd + rc, L.ld_wd, V, rc, slice(a.in[P_WDK], R, 0, V, r0, R), dt0,
        dtn);
  stage(s_dstage, V, DESC_CHUNK, V, slice(a.in[P_DESC], V, 0, D, 0, V), dt0,
        dtn);
  cp_async_commit();
  // Then the resident slices by cp.async in two groups: the sender's,
  // which turn 0 waits for, then the rest, which land while h_x is
  // computed.
  if (L.mat[M_WCODE] >= 0)
    stage(smem + L.mat[M_WCODE], L.ld[M_WCODE], W, hc, g_wcode);
  if (L.mat[M_WBIN] >= 0)
    stage(smem + L.mat[M_WBIN], L.ld[M_WBIN], hc, W, g_wbin);
  stage(s_bcode, hc, 1, hc, slice(a.in[P_BCODE], H, 0, 1, h0, H));
  stage(s_bbin, W, 1, W, slice(a.in[P_BBIN], W, 0, 1, 0, W));
  if (a.in[P_CORRUPT] != nullptr)
    stage(s_corrupt, W, 1, W, slice(a.in[P_CORRUPT], W, 0, 1, 0, W));
  else                                  // no corruption
    for (int i = tid; i < W; i += THREADS) s_corrupt[i] = 0.f;
  cp_async_commit();
  if (L.mat[M_WIH] >= 0)
    stage(smem + L.mat[M_WIH], L.ld[M_WIH], W, 3 * rc, g_wih);
  if (L.mat[M_WHH] >= 0)
    stage(smem + L.mat[M_WHH], L.ld[M_WHH], R, 3 * rc, g_whh);
  if (L.mat[M_Y1H] >= 0)
    stage(smem + L.mat[M_Y1H], L.ld[M_Y1H], R, rc, g_y1h);
  if (L.mat[M_WHK] >= 0)
    stage(smem + L.mat[M_WHK], L.ld[M_WHK], R, rc, g_whk);
  if (L.mat[M_WK] >= 0)
    stage(smem + L.mat[M_WK], L.ld[M_WK], rc, W, g_wk);
  stage(s_bih, 3 * rc, 1, 3 * rc,
        GlobalW<true>{a.in[P_BIH], 3 * R, 0, 1, r0, R, rc, R});
  stage(s_bhh, 3 * rc, 1, 3 * rc,
        GlobalW<true>{a.in[P_BHH], 3 * R, 0, 1, r0, R, rc, R});
  stage(s_y1b, rc, 1, rc, slice(a.in[P_Y1B], R, 0, 1, r0, R));
  stage(s_whb, rc, 1, rc, slice(a.in[P_WHB], R, 0, 1, r0, R));
  stage(s_sk, R, 1, R, slice(a.in[P_SK], R, 0, 1, 0, R));
  stage(s_y2k, rc, 1, rc, slice(a.in[P_Y2K], R, 0, 1, r0, R));
  stage(s_wb, W, 1, W, slice(a.in[P_WB], W, 0, 1, 0, W));
  cp_async_commit();

  for (int i = tid; i < 2 * ROWS * R; i += THREADS) s_h[i] = 0.f;
  for (int i = tid; i < ROWS; i += THREADS) {
    s_mask[i] = 1.f;
    s_sprod[i] = 1.f;
  }
  // Turn 0's code input: sigmoid(code_bias) in every row.
  for (int i = tid; i < ROWS * W; i += THREADS)
    s_wbits[i] = sigmoid_f(__ldg(a.in[P_CBIAS] + i % W));

  // h_x on warps [0, HX_WARPS); beside it desc_proj = desc y1_d and
  // desc w_d for this CTA's receiver columns (0 past R), as one product of
  // 2 rc columns over the staged [y1_d | w_d] slices, DESC_CHUNK staged
  // classes at a time.
  image_projection(a, s_hx, hc, h0, row0, nrows, 0, HX_WARPS);
  if (warp >= HX_WARPS) {
    const Split sp = make_split(2 * rc, V, DESC_WARPS);
    for (int d0 = 0; d0 < D; d0 += DESC_CHUNK) {
      const int nd = min(DESC_CHUNK, D - d0);
      if (d0 > 0) {              // the next chunk, once every warp is done
        desc_barrier();
        stage(s_dstage, V, DESC_CHUNK, V, slice(a.in[P_DESC], V, d0, D, 0, V),
              dt0, dtn);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<2>();      // chunk 0 and the [y1_d | w_d] slices
      }
      desc_barrier();
      product<DESC_CHUNK>(sp, s_dstage, V, nd, SharedW{s_wd, L.ld_wd},
                          2 * rc, [&](int r, int j, float acc) {
                            if (r >= nd) return;
                            if (j < rc)
                              s_dp[(d0 + r) * L.ld_dp + j] =
                                  r0 + j < R ? acc : 0.f;
                            else
                              s_dw[(d0 + r) * L.ld_dw + j - rc] =
                                  r0 + j - rc < R ? acc : 0.f;
                          }, HX_WARPS, DESC_WARPS);
    }
  }
  // Every CTA of the cluster has started and set up before any CTA
  // writes into another's shared memory.
  cluster.sync();
  PHASE_MARK(PH_SETUP);

  for (int t = 0; t < a.T; ++t) {
    const size_t out_row = static_cast<size_t>(t) * B + row0;
    float* h_new = s_h + (t & 1) * ROWS * R;        // written this turn
    const float* h_old = s_h + ((t & 1) ^ 1) * ROWS * R;
    float* u_z = s_u;
    float* u_fz = s_u + ROWS * W;
    float* u_w = s_u + 2 * ROWS * W;
    float* u_fw = s_u + 3 * ROWS * W;
    float* u_s = s_u + 4 * ROWS * W;

    if (TRAIN) fill_uniforms(a, s_u, t, row0, nrows);
    cp_async_commit();
    if (t == 0) {
      cp_async_wait<2>();       // the sender's weights
      __syncthreads();
    }

    // ---- Sender: code layer and mix, this CTA's hidden columns ----
    if (a.mix != MIX_IGNORE_CODE) {
      product_of(L, M_WCODE, smem, sp_code, s_wbits, W, g_wcode, hc,
                       [&](int r, int j, float acc) {
                         float m = 0.f;
                         if (h0 + j < H) {
                           const float hw = acc + s_bcode[j];
                           const float hx = s_hx[r * hc + j];
                           m = a.mix == MIX_PROD ? tanhf(hx * hw)
                                                 : tanhf(hx + hw);
                         }
                         s_mix[r * hc + j] = m;
                       });
    } else if (t == 0) {
      for (int i = tid; i < ROWS * hc; i += THREADS)
        s_mix[i] = h0 + i % hc < H ? tanhf(s_hx[i]) : 0.f;
    }
    cp_async_wait<0>();         // this turn's uniforms (turn 0: all weights)
    __syncthreads();
    PHASE_MARK(PH_SENDER);

    // ---- Binary layer, k split over the cluster; sample; corrupt ----
    product_of(L, M_WBIN, smem, sp_bin, s_mix, hc, g_wbin, W,
                     [&](int r, int j, float acc) {
                       push_all(s_zpart + (rank * ROWS + r) * W + j, acc,
                                bars + X_ZPART, C);
                     });
    exchange_wait(bars + X_ZPART, t & 1, 4u * C * ROWS * W);
    for (int i = tid, r = tid_rw, j = tid_jw; i < ROWS * W;
         i += THREADS, r = i / W, j = i - r * W) {
      float z = 0.f;
      for (int q = 0; q < C; ++q) z += s_zpart[(q * ROWS + r) * W + j];
      const float prob = sigmoid_f(z + s_bbin[j]);
      float bit;
      if (TRAIN) {
        bit = 0.f;    // padded rows of the last tile
        if (r < nrows) {
          bit = u_z[i] < prob ? 1.f : 0.f;
          if (a.flip_sen)
            bit = fabsf(bit - (u_fz[i] < a.p_flip_sen ? 1.f : 0.f));
        }
      } else {
        bit = floorf(prob + 0.5f);
      }
      bit = fabsf(bit - s_corrupt[j]);
      s_zbits[i] = bit;
      if (writer && r < nrows) {
        o_zprob[out_row * W + i] = prob;
        o_zfeat[out_row * W + i] = bit;
      }
    }
    __syncthreads();
    PHASE_MARK(PH_BINARY);

    // ---- Receiver GRU, torch gate order [r | z | n], this CTA's slice;
    // the new state is pushed to every CTA ----
    // z W_ih on the first IH_WARPS warps, h W_hh (twice the k) on the rest.
    product_of(L, M_WIH, smem, sp_ih, s_zbits, W, g_wih, 3 * rc,
                     [&](int r, int q, float acc) {
                       s_gi[r * 3 * rc + q] = acc + s_bih[q];
                     }, 0, IH_WARPS);
    product_of(L, M_WHH, smem, sp_hh, h_old, R, g_whh, 3 * rc,
                     [&](int r, int q, float acc) {
                       s_gh[r * 3 * rc + q] = acc + s_bhh[q];
                     }, IH_WARPS, NWARPS - IH_WARPS);
    __syncthreads();
    for (int i = tid, r = tid_rr, jr = tid_jr; i < ROWS * rc;
         i += THREADS, r = i / rc, jr = i - r * rc) {
      const int j = r0 + jr;
      if (j >= R) continue;
      const float* gi = s_gi + r * 3 * rc;
      const float* gh = s_gh + r * 3 * rc;
      const float rg = sigmoid_f(gi[jr] + gh[jr]);
      const float zg = sigmoid_f(gi[rc + jr] + gh[rc + jr]);
      const float ng = tanhf(gi[2 * rc + jr] + rg * gh[2 * rc + jr]);
      const float hn = (1.f - zg) * ng + zg * h_old[r * R + j];
      push_all(h_new + r * R + j, hn, bars + X_H, C);
    }
    exchange_wait(bars + X_H, t & 1, 4u * ROWS * R);
    PHASE_MARK(PH_GRU);

    // ---- Heads on h_z: y1's h_z block and w_h (this CTA's columns), the
    // stop logit (all of R, one warp a row) ----
    // y1_h on warps 0-3, w_h on warps 4-7, then the stop logits.
    product_of(L, M_Y1H, smem, sp_head, h_new, R, g_y1h, rc,
                     [&](int r, int j, float acc) {
                       s_y1[r * rc + j] = acc + s_y1b[j];
                     }, 0, NWARPS / 2);
    product_of(L, M_WHK, smem, sp_head, h_new, R, g_whk, rc,
                     [&](int r, int j, float acc) {
                       s_wh[r * rc + j] = acc + s_whb[j];
                     }, NWARPS / 2, NWARPS / 2);
    for (int r = warp; r < ROWS; r += NWARPS) {
      float acc = 0.f;
      for (int k = lane; k < R; k += 32)
        acc = fmaf(h_new[r * R + k], s_sk[k], acc);
      acc = warp_sum(acc);
      if (lane == 0) s_stop[r] = acc + sb;
    }
    __syncthreads();
    PHASE_MARK(PH_HEADS);

    // ---- Class scores y[r, d] = relu(h y1_h + y1_b + desc_proj[d]) . y2
    // + b2, k split over the cluster; softmax; stop bit ----
    scores_partial(sp_scores, s_y1, s_dp, L.ld_dp, s_y2k, rc, D,
                         [&](int r, int d, float acc) {
                           if (a.pull)
                             s_spart[r * D + d] = acc;
                           else
                             push_all(s_spart + (rank * ROWS + r) * D + d,
                                      acc, bars + X_SPART, C);
                         });
    if (a.pull) cluster.sync();
    else exchange_wait(bars + X_SPART, t & 1, 4u * C * ROWS * D);
    for (int r = warp; r < ROWS; r += NWARPS) {
      float* p = s_p + r * D;
      float m = -INFINITY;
      for (int d = lane; d < D; d += 32) {
        float y = 0.f;
        for (int q = 0; q < C; ++q)
          y += a.pull ? cluster.map_shared_rank(s_spart, q)[r * D + d]
                      : s_spart[(q * ROWS + r) * D + d];
        y += y2b;
        p[d] = y;
        m = fmaxf(m, y);
        if (writer && r < nrows) o_y[(out_row + r) * D + d] = y;
      }
      m = warp_max(m);
      float sum = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float e = expf(p[d] - m);
        p[d] = e;
        sum += e;
      }
      sum = __frcp_rn(warp_sum(sum));
      for (int d = lane; d < D; d += 32) p[d] *= sum;

      // Stop bit: sampled in train mode; in eval mode the (cumulative)
      // stop probability rounded. Then the running mask min(mask, s).
      if (lane == 0) {
        const float sp = sigmoid_f(s_stop[r]);
        float sbit;
        if (TRAIN) {
          sbit = r < nrows && u_s[r] < sp ? 1.f : 0.f;
        } else {
          const float sprod = a.s_prob_prod ? s_sprod[r] * sp : sp;
          s_sprod[r] = sprod;
          sbit = floorf(sprod + 0.5f);
        }
        const float mask = fminf(s_mask[r], sbit);
        s_mask[r] = mask;
        if (writer && r < nrows) {
          o_sfeat[out_row + r] = sbit;
          o_sprob[out_row + r] = sp;
          o_mask[out_row + r] = mask;
        }
      }
    }
    __syncthreads();
    PHASE_MARK(PH_SCORES);

    // ---- Query: tanh(h w_h + b + p (desc w_d)), this CTA's columns ----
    product<ROWS>(sp_query, s_p, D, ROWS, SharedW{s_dw, L.ld_dw}, rc,
                  [&](int r, int j, float acc) {
                    s_hq[r * rc + j] =
                        r0 + j < R ? tanhf(s_wh[r * rc + j] + acc) : 0.f;
                  });
    __syncthreads();
    PHASE_MARK(PH_QUERY);

    // ---- Reply: w logits, k split over the cluster; sample ----
    product_of(L, M_WK, smem, sp_wk, s_hq, rc, g_wk, W,
                     [&](int r, int j, float acc) {
                       push_all(s_wpart + (rank * ROWS + r) * W + j, acc,
                                bars + X_WPART, C);
                     });
    exchange_wait(bars + X_WPART, t & 1, 4u * C * ROWS * W);
    for (int i = tid, r = tid_rw, j = tid_jw; i < ROWS * W;
         i += THREADS, r = i / W, j = i - r * W) {
      float wl = 0.f;
      for (int q = 0; q < C; ++q) wl += s_wpart[(q * ROWS + r) * W + j];
      const float prob = sigmoid_f(wl + s_wb[j]);
      float bit;
      if (TRAIN) {
        bit = 0.f;
        if (r < nrows) {
          bit = u_w[i] < prob ? 1.f : 0.f;
          if (a.flip_rec)
            bit = fabsf(bit - (u_fw[i] < a.p_flip_rec ? 1.f : 0.f));
        }
      } else {
        bit = floorf(prob + 0.5f);
      }
      if (a.ignore_receiver) bit = 0.f;
      s_wbits[i] = bit;
      if (writer && r < nrows) {
        o_wprob[out_row * W + i] = prob;
        o_wfeat[out_row * W + i] = bit;
      }
    }
    __syncthreads();
    PHASE_MARK(PH_REPLY);
  }
  // No CTA leaves while a push to it or from it may be in flight.
  cluster.sync();
  PHASE_END();
}

#ifdef MMG_PHASE_CLOCKS
// The cost of one link of the conversation's chain, for the latency floor
// (stamped build only): a dependent shared-memory load, a 5-level warp
// reduction, and then a CTA barrier (C == 1) or a push of one value per
// warp to every CTA of the cluster and the wait for the cluster's pushes
// (C > 1), as the turn's phases end. Block 0's thread 0 writes the mean
// cycles a link to g_link_cycles.
__device__ unsigned long long g_link_cycles;

__global__ void __launch_bounds__(THREADS, 1) link_probe_kernel(int iters) {
  __shared__ float buf[64];
  __shared__ float part[8 * NWARPS];
  __shared__ unsigned long long bar;
  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 64) buf[threadIdx.x] = 0.f;
  if (threadIdx.x == 0 && C > 1) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cg::this_cluster().sync();
  float v = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    v = buf[(static_cast<int>(v) + lane) & 63];
    v = warp_sum(v);
    if (C == 1) {
      if (lane == 0) part[warp] = v;
      __syncthreads();
    } else {
      if (lane == 0) push_all(part + rank * NWARPS + warp, v, &bar, C);
      exchange_wait(&bar, it & 1, 4u * C * NWARPS);
    }
    v += part[warp];
  }
  const long long t1 = clock64();
  if (blockIdx.x == 0 && threadIdx.x == 0)
    g_link_cycles = static_cast<unsigned long long>((t1 - t0) / iters) +
                    (v != 0.f ? 1ull : 0ull);
  cg::this_cluster().sync();
}
#endif

// Fill the fields shared by both modes from the pointer and int tables.
void fill_args(Args& a, void* const* ptrs, const int* dims) {
  for (int i = 0; i < P_O_SFEAT; ++i) a.in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = P_O_SFEAT; i < P_COUNT; ++i)
    a.out[i - P_O_SFEAT] = static_cast<float*>(ptrs[i]);
  for (int i = 0; i < S_COUNT; ++i) a.u[i] = nullptr;
  a.key = nullptr;
  a.B = dims[D_B]; a.F = dims[D_F]; a.H = dims[D_H]; a.W = dims[D_W];
  a.R = dims[D_R]; a.D = dims[D_D]; a.V = dims[D_V]; a.T = dims[D_T];
  a.mix = dims[D_MIX];
  a.ignore_receiver = dims[D_IGNORE_RECEIVER];
  a.s_prob_prod = dims[D_S_PROB_PROD];
  a.cluster = dims[D_CLUSTER];
  a.resident = dims[D_RESIDENT];
  a.pull = dims[D_PULL];
  a.compact = dims[D_COMPACT];
  a.smem_bytes = dims[D_SMEM_BYTES];
  a.philox = a.flip_sen = a.flip_rec = a.row_base = 0;
  a.seed = a.step = 0u;
  a.p_flip_sen = a.p_flip_rec = 0.f;
}

// Launch settings per device and instance, made at the first launch
// there: the opt-in shared memory, the max-dynamic-smem attribute set to
// it (so any plan that fits needs no further call), and the (cluster,
// shared memory) pairs whose occupancy cudaOccupancyMaxActiveClusters
// has confirmed.
struct Prepared {
  int dev, train, optin;
  std::vector<std::pair<int, size_t>> fits;
};
std::mutex g_prepared_mu;
std::vector<Prepared> g_prepared;

template <bool TRAIN>
int launch(const Args& a, void* stream) {
  if (a.B <= 0) return 0;
  auto kernel = fused_exchange_kernel<TRAIN>;
  const int C = a.cluster;
  if (C < 2 || C > 8 || a.H < 1 || a.R < 1 || a.W < 1 || a.D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(make_layout(a).total);
  // The host's plan and this carve must agree.
  if (smem != static_cast<size_t>(a.smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(a.B, ROWS) * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> lock(g_prepared_mu);
    Prepared* p = nullptr;
    for (Prepared& q : g_prepared)
      if (q.dev == dev && q.train == TRAIN) p = &q;
    if (p == nullptr) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_prepared.push_back(Prepared{dev, TRAIN, optin, {}});
      p = &g_prepared.back();
    }
    // The carve must fit the device.
    if (smem > static_cast<size_t>(p->optin))
      return static_cast<int>(cudaErrorInvalidValue);
    bool known = false;
    for (const auto& f : p->fits) known |= f.first == C && f.second == smem;
    if (!known) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      p->fits.emplace_back(C, smem);
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the whole eval conversation on `stream`. `ptrs` holds P_COUNT
// device pointers (P_CORRUPT null: no corruption) and `dims` D_COUNT
// ints, in the orders above. Returns 0
// or a cudaError_t code (a plan that does not fit, a refused launch).
int mmg_fused_eval_exchange(void* const* ptrs, int n_ptrs, const int* dims,
                            int n_dims, void* stream) {
  if (n_ptrs != P_COUNT || n_dims != D_COUNT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  fill_args(a, ptrs, dims);
  return launch<false>(a, stream);
}

// Launch the whole sampled (train-mode) conversation on `stream`. `ptrs`
// holds P_TRAIN_COUNT pointers: the eval table, the uniform streams
// z, fz, s, w, fw, then the device key. `dims` holds D_TRAIN_COUNT ints;
// `probs` the two flipout probabilities (sender, receiver). With
// dims[D_PHILOX] == 0 the streams s, z, w (and fz, fw where flipout is on)
// must be given and the key null; with 1 every stream must be null and
// Philox keyed by (D_SEED, D_STEP) draws the numbers, row r of the launch
// as the global row D_ROW_BASE + r (0 with given streams). A non-null key
// (Philox only, with D_SEED, D_STEP and D_ROW_BASE 0) holds the three as
// int64 in device memory instead, read by the kernel when it runs.
// Returns 0 or a cudaError_t code.
int mmg_fused_train_forward(void* const* ptrs, int n_ptrs, const int* dims,
                            int n_dims, const float* probs, int n_probs,
                            void* stream) {
  if (n_ptrs != P_TRAIN_COUNT || n_dims != D_TRAIN_COUNT || n_probs != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  fill_args(a, ptrs, dims);
  for (int i = 0; i < S_COUNT; ++i)
    a.u[i] = static_cast<const float*>(ptrs[P_U_FIRST + i]);
  a.philox = dims[D_PHILOX] != 0;
  a.seed = static_cast<unsigned>(dims[D_SEED]);
  a.step = static_cast<unsigned>(dims[D_STEP]);
  a.flip_sen = dims[D_FLIP_SEN] != 0;
  a.flip_rec = dims[D_FLIP_REC] != 0;
  a.row_base = dims[D_ROW_BASE];
  a.key = static_cast<const long long*>(ptrs[P_KEY]);
  if (a.row_base < 0 || (!a.philox && a.row_base != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.key != nullptr &&
      (!a.philox || a.seed != 0u || a.step != 0u || a.row_base != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  a.p_flip_sen = probs[0];
  a.p_flip_rec = probs[1];
  const bool need[S_COUNT] = {true, static_cast<bool>(a.flip_sen), true, true,
                              static_cast<bool>(a.flip_rec)};
  for (int i = 0; i < S_COUNT; ++i) {
    const bool given = a.u[i] != nullptr;
    if (a.philox ? given : (need[i] && !given))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(a, stream);
}

// Cycles of one link (link_probe_kernel) with `cluster` CTAs, into *out;
// cudaErrorNotSupported without -DMMG_PHASE_CLOCKS.
int mmg_link_cycles(int cluster, int iters, unsigned long long* out) {
#ifdef MMG_PHASE_CLOCKS
  if (cluster < 1 || cluster > 8 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, link_probe_kernel, iters);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_link_cycles, sizeof(*out));
  return static_cast<int>(err);
#else
  (void)cluster; (void)iters; (void)out;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// Copy the last stamped launch's per-phase cycles of block 0 (PH_COUNT
// values) and the slowest CTA's whole cycles (one more) to host memory,
// and clear that maximum for the next launch; cudaErrorNotSupported in a
// library built without -DMMG_PHASE_CLOCKS.
int mmg_phase_clocks(unsigned long long* out, int n) {
#ifdef MMG_PHASE_CLOCKS
  if (n != PH_COUNT + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemcpyFromSymbol(
      out, g_phase_clocks, sizeof(unsigned long long) * (PH_COUNT + 1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(
      g_phase_clocks, &zero, sizeof(zero),
      sizeof(unsigned long long) * PH_COUNT));
#else
  (void)out; (void)n;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// Registers per thread and local memory (spill) bytes per thread of the
// eval (train == 0) or train instance, as the loaded module reports them.
int mmg_kernel_registers(int train, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, train ? reinterpret_cast<const void*>(fused_exchange_kernel<true>)
                   : reinterpret_cast<const void*>(fused_exchange_kernel<false>));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* mmg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
