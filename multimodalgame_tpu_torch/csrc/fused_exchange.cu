// Whole conversation of the MultimodalGame in one CUDA kernel, in its two
// modes, as multimodalgame_tpu/ops/pallas_exchange.py:_kernel shares one
// body between them through `train` (here the template parameter TRAIN).
//
// Eval mode replaces _kernel with train=False (reached through
// fused_eval_exchange): every turn rounds the sender's bits with
// floor(p + 0.5), flips the corrupt bits, steps the receiver's GRU, rounds
// the (cumulative) stop probability, scores every class, mixes the
// descriptions by the softmax of the scores and rounds the receiver's
// query.
//
// Train mode replaces _kernel with train=True (reached through
// fused_train_forward, phase A of every training step): the same products,
// with Bernoulli bits u < p for the message, the stop bit and the query,
// flipout (|bit - (u' < p_flip)|) on both channels when configured,
// ignore_receiver after flipout, and no cumulative stop product. The TPU
// kernel draws u from the core's own generator (_uniform01); this one takes
// u either as pre-drawn input streams (the tests' bit-exact parity with the
// plain exchange) or from Philox4x32-10 keyed by (seed, step), with the
// counter (column / 4, global row, turn, stream) and word column % 4, so
// the numbers depend neither on the row tiling nor on the batch size
// (ops/philox.py is its plain version).
//
// The once-per-conversation products (h_x = data W_img + b,
// desc_proj = desc y1_d and the first turn's code) are computed here too,
// as in _kernel.
//
// What bounds it on an H100: not bytes and not FLOPs. At the canonical
// Adaptive dims (feat 512, sender hidden 256, 32-bit messages, receiver
// hidden 64, wv 100, 30 classes, 10 turns) a batch of 64 needs ~89 MFLOP
// and ~1.3 MB of traffic, a few microseconds of either. The conversation is
// a serial chain of T x ~10 dependent small products (each turn feeds its
// bits to the next), so it is bound by the latency of that chain.
//
// What this design does about it: nothing beyond one launch per
// conversation. Batch rows are independent in both modes, so one block owns
// a tile of ROWS rows and runs all T turns; per-row state lives in shared
// memory, threads spread over the output columns of each product (each
// thread keeps all ROWS rows of its column, so a weight is read once per
// block), and weights are read from L2 through __ldg. Everything is f32 on
// CUDA cores: no TF32, no bf16.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 4;      // batch rows per block
constexpr int THREADS = 256;

enum Mix { MIX_SUM = 0, MIX_PROD = 1, MIX_IGNORE_CODE = 2 };

// Order of the pointer table handed over by the Python wrapper
// (ops/cuda_exchange.py: data, desc, corrupt, PARAM_ORDER, the outputs,
// and in train mode the five uniform streams, null where absent).
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
  P_TRAIN_COUNT = P_U_FIRST + 5
};

// Uniform streams, numbered as the JAX exchange orders its per-turn keys
// (game/exchange.py:155-180) and as ops/philox.py numbers them.
enum Stream { S_Z = 0, S_FZ = 1, S_S = 2, S_W = 3, S_FW = 4, S_COUNT = 5 };

// Order of the int table: sizes, flags, then the train mode's entries.
enum Dim { D_B, D_F, D_H, D_W, D_R, D_D, D_V, D_T,
           D_MIX, D_IGNORE_RECEIVER, D_S_PROB_PROD, D_COUNT,
           D_PHILOX = D_COUNT, D_SEED, D_STEP, D_FLIP_SEN, D_FLIP_REC,
           D_TRAIN_COUNT };

struct Args {
  const float* in[P_O_SFEAT];
  float* out[P_COUNT - P_O_SFEAT];
  const float* u[S_COUNT];     // train mode, pre-drawn uniforms (T, B, dim)
  int B, F, H, W, R, D, V, T, mix, ignore_receiver, s_prob_prod;
  int philox, flip_sen, flip_rec;
  unsigned seed, step;
  float p_flip_sen, p_flip_rec;
};

// Shared-memory carve, in floats. Used by the kernel and by the host to
// size the launch.
struct Layout {
  int x, hx, hwf, hw, z, w, h, gi, gh, dp, head, s, y, p, wd, hq, mask,
      sprod, total;
};

__host__ __device__ inline Layout make_layout(const Args& a) {
  Layout L;
  int o = 0;
  L.x = o;     o += ROWS * a.F;       // data rows (zero padded)
  L.hx = o;    o += ROWS * a.H;       // h_x
  L.hwf = o;   o += a.H;              // first turn's code projection
  L.hw = o;    o += ROWS * a.H;       // h_w, then the tanh mix in place
  L.z = o;     o += ROWS * a.W;       // sender logits, then bits
  L.w = o;     o += ROWS * a.W;       // receiver logits, then bits
  L.h = o;     o += ROWS * a.R;       // GRU state h_z
  L.gi = o;    o += ROWS * 3 * a.R;   // z W_ih + b_ih
  L.gh = o;    o += ROWS * 3 * a.R;   // h W_hh + b_hh
  L.dp = o;    o += a.D * a.R;        // desc_proj
  L.head = o;  o += ROWS * 2 * a.R;   // [h y1_h + y1_b | h w_h + w_hb]
  L.s = o;     o += ROWS;             // stop logits
  L.y = o;     o += ROWS * a.D;       // class scores
  L.p = o;     o += ROWS * a.D;       // softmax of the scores
  L.wd = o;    o += ROWS * a.V;       // softmax . desc
  L.hq = o;    o += ROWS * a.R;       // query hidden
  L.mask = o;  o += ROWS;
  L.sprod = o; o += ROWS;
  L.total = o;
  return L;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  if (x >= 0.f) return 1.f / (1.f + expf(-x));
  const float e = expf(x);
  return e / (1.f + e);
}

// out[r * ldo + j] = bias[j] + sum_k in[r * ldi + k] * wt[k * n + j]
// for every r < ROWS and j < n; wt is (k_dim, n) row-major in device
// memory, in/out are in shared memory. Threads own columns.
__device__ __forceinline__ void rows_matmul(
    const float* in, int ldi, int k_dim, const float* __restrict__ wt,
    const float* __restrict__ bias, int n, float* out, int ldo) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    // Unrolled so that several independent L2 loads are in flight.
#pragma unroll 8
    for (int k = 0; k < k_dim; ++k) {
      const float wv = __ldg(wt + static_cast<size_t>(k) * n + j);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(in[r * ldi + k], wv, acc[r]);
    }
    const float b = bias != nullptr ? __ldg(bias + j) : 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) out[r * ldo + j] = acc[r] + b;
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

// The uniform of (stream, turn t, global row, column) in [0, 1): read
// from the pre-drawn stream, or drawn from Philox with 24 bits, exact in
// f32 (as _uniform01 makes them).
__device__ __forceinline__ float uniform01(const Args& a, int stream, int t,
                                           int row, int col, int width) {
  if (!a.philox)
    return __ldg(a.u[stream] + (static_cast<size_t>(t) * a.B + row) * width +
                 col);
  const uint4 x = philox4x32_10(
      make_uint4(static_cast<unsigned>(col) >> 2, row, t, stream),
      make_uint2(a.seed, a.step));
  const int w = col & 3;
  const unsigned bits = w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool TRAIN>
__global__ void __launch_bounds__(THREADS)
fused_exchange_kernel(Args a) {
  extern __shared__ float smem[];
  const Layout L = make_layout(a);
  float* s_x = smem + L.x;
  float* s_hx = smem + L.hx;
  float* s_hwf = smem + L.hwf;
  float* s_hw = smem + L.hw;
  float* s_z = smem + L.z;
  float* s_w = smem + L.w;
  float* s_h = smem + L.h;
  float* s_gi = smem + L.gi;
  float* s_gh = smem + L.gh;
  float* s_dp = smem + L.dp;
  float* s_head = smem + L.head;
  float* s_s = smem + L.s;
  float* s_y = smem + L.y;
  float* s_p = smem + L.p;
  float* s_wd = smem + L.wd;
  float* s_hq = smem + L.hq;
  float* s_mask = smem + L.mask;
  float* s_sprod = smem + L.sprod;

  const float* data = a.in[P_DATA];
  const float* desc = a.in[P_DESC];
  const float* corrupt = a.in[P_CORRUPT];
  float* o_sfeat = a.out[P_O_SFEAT - P_O_SFEAT];
  float* o_sprob = a.out[P_O_SPROB - P_O_SFEAT];
  float* o_zfeat = a.out[P_O_ZFEAT - P_O_SFEAT];
  float* o_zprob = a.out[P_O_ZPROB - P_O_SFEAT];
  float* o_wfeat = a.out[P_O_WFEAT - P_O_SFEAT];
  float* o_wprob = a.out[P_O_WPROB - P_O_SFEAT];
  float* o_y = a.out[P_O_Y - P_O_SFEAT];
  float* o_mask = a.out[P_O_MASK - P_O_SFEAT];

  const int F = a.F, H = a.H, W = a.W, R = a.R, D = a.D, V = a.V;
  const int B = a.B;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);   // ragged last tile

  // ---- Once per conversation ----
  for (int i = tid; i < ROWS * F; i += nthreads) {
    const int r = i / F;
    s_x[i] = r < nrows ? __ldg(data + static_cast<size_t>(row0) * F + i) : 0.f;
  }
  for (int i = tid; i < ROWS * R; i += nthreads) s_h[i] = 0.f;
  for (int i = tid; i < ROWS; i += nthreads) {
    s_mask[i] = 1.f;
    s_sprod[i] = 1.f;
  }
  __syncthreads();

  rows_matmul(s_x, F, F, a.in[P_WIMG], a.in[P_BIMG], H, s_hx, H);
  // desc_proj = desc y1_d  (D, R)
  for (int i = tid; i < D * R; i += nthreads) {
    const int d = i / R, j = i % R;
    float acc = 0.f;
    for (int v = 0; v < V; ++v)
      acc = fmaf(__ldg(desc + d * V + v), __ldg(a.in[P_Y1D] + v * R + j), acc);
    s_dp[i] = acc;
  }
  // h_w_first = sigmoid(code_bias) W_code + b_code  (1, H)
  for (int j = tid; j < H; j += nthreads) {
    float acc = 0.f;
    for (int k = 0; k < W; ++k)
      acc = fmaf(sigmoid_f(__ldg(a.in[P_CBIAS] + k)),
                 __ldg(a.in[P_WCODE] + k * H + j), acc);
    s_hwf[j] = acc + __ldg(a.in[P_BCODE] + j);
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t out_row = static_cast<size_t>(t) * B + row0;

    // ---- Sender: mix -> tanh -> binary layer -> bits -> corrupt ----
    if (a.mix != MIX_IGNORE_CODE && t > 0) {
      rows_matmul(s_w, W, W, a.in[P_WCODE], a.in[P_BCODE], H, s_hw, H);
      __syncthreads();
    }
    for (int i = tid; i < ROWS * H; i += nthreads) {
      const float hx = s_hx[i];
      float m;
      if (a.mix == MIX_IGNORE_CODE) {
        m = tanhf(hx);
      } else {
        const float hw = t == 0 ? s_hwf[i % H] : s_hw[i];
        m = a.mix == MIX_PROD ? tanhf(hx * hw) : tanhf(hx + hw);
      }
      s_hw[i] = m;
    }
    __syncthreads();
    rows_matmul(s_hw, H, H, a.in[P_WBIN], a.in[P_BBIN], W, s_z, W);
    __syncthreads();
    for (int i = tid; i < ROWS * W; i += nthreads) {
      const int r = i / W, j = i % W;
      const float prob = sigmoid_f(s_z[i]);
      float bit;
      if (TRAIN) {
        bit = 0.f;    // padded rows of the last tile
        if (r < nrows) {
          bit = uniform01(a, S_Z, t, row0 + r, j, W) < prob ? 1.f : 0.f;
          if (a.flip_sen)
            bit = fabsf(bit - (uniform01(a, S_FZ, t, row0 + r, j, W) <
                                       a.p_flip_sen ? 1.f : 0.f));
        }
      } else {
        bit = floorf(prob + 0.5f);
      }
      bit = fabsf(bit - __ldg(corrupt + j));
      s_z[i] = bit;
      if (r < nrows) {
        o_zprob[out_row * W + i] = prob;
        o_zfeat[out_row * W + i] = bit;
      }
    }
    __syncthreads();

    // ---- Receiver GRU, torch gate order [r | z | n] ----
    rows_matmul(s_z, W, W, a.in[P_WIH], a.in[P_BIH], 3 * R, s_gi, 3 * R);
    rows_matmul(s_h, R, R, a.in[P_WHH], a.in[P_BHH], 3 * R, s_gh, 3 * R);
    __syncthreads();
    for (int i = tid; i < ROWS * R; i += nthreads) {
      const int r = i / R, j = i % R;
      const float* gi = s_gi + r * 3 * R;
      const float* gh = s_gh + r * 3 * R;
      const float rg = sigmoid_f(gi[j] + gh[j]);
      const float zg = sigmoid_f(gi[R + j] + gh[R + j]);
      const float ng = tanhf(gi[2 * R + j] + rg * gh[2 * R + j]);
      s_h[i] = (1.f - zg) * ng + zg * s_h[i];
    }
    __syncthreads();

    // ---- Heads on h_z: stop logit, y1's h_z block, w_h ----
    rows_matmul(s_h, R, R, a.in[P_SK], a.in[P_SB], 1, s_s, 1);
    rows_matmul(s_h, R, R, a.in[P_Y1H], a.in[P_Y1B], R, s_head, 2 * R);
    rows_matmul(s_h, R, R, a.in[P_WHK], a.in[P_WHB], R, s_head + R, 2 * R);
    __syncthreads();

    // Stop bit: sampled in train mode; in eval mode the (cumulative) stop
    // probability rounded. Then the running mask min(mask, s).
    for (int r = tid; r < ROWS; r += nthreads) {
      const float sp = sigmoid_f(s_s[r]);
      float sbit;
      if (TRAIN) {
        sbit = r < nrows && uniform01(a, S_S, t, row0 + r, 0, 1) < sp
                   ? 1.f : 0.f;
      } else {
        const float sprod = a.s_prob_prod ? s_sprod[r] * sp : sp;
        s_sprod[r] = sprod;
        sbit = floorf(sprod + 0.5f);
      }
      const float mask = fminf(s_mask[r], sbit);
      s_mask[r] = mask;
      if (r < nrows) {
        o_sfeat[out_row + r] = sbit;
        o_sprob[out_row + r] = sp;
        o_mask[out_row + r] = mask;
      }
    }
    // Class scores y[r, d] = relu(h y1_h + y1_b + desc_proj[d]) . y2 + b2
    {
      const float* y2k = a.in[P_Y2K];
      const float y2b = __ldg(a.in[P_Y2B]);
      for (int i = tid; i < ROWS * D; i += nthreads) {
        const int r = i / D, d = i % D;
        const float* y1h = s_head + r * 2 * R;
        const float* dp = s_dp + d * R;
        float acc = 0.f;
        for (int k = 0; k < R; ++k)
          acc = fmaf(fmaxf(y1h[k] + dp[k], 0.f), __ldg(y2k + k), acc);
        const float y = acc + y2b;
        s_y[i] = y;
        if (r < nrows) o_y[out_row * D + i] = y;
      }
    }
    __syncthreads();

    // Softmax over the classes, one warp per row (row max subtracted).
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < ROWS; r += nthreads / 32) {
        const float* y = s_y + r * D;
        float* p = s_p + r * D;
        float m = -INFINITY;
        for (int d = lane; d < D; d += 32) m = fmaxf(m, y[d]);
        m = warp_max(m);
        float sum = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float e = expf(y[d] - m);
          p[d] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int d = lane; d < D; d += 32) p[d] = p[d] / sum;
      }
    }
    __syncthreads();

    // ---- Query: tanh(h w_h + b + (softmax . desc) w_d) -> w -> round ----
    rows_matmul(s_p, D, D, desc, nullptr, V, s_wd, V);
    __syncthreads();
    rows_matmul(s_wd, V, V, a.in[P_WDK], nullptr, R, s_hq, R);
    __syncthreads();
    for (int i = tid; i < ROWS * R; i += nthreads) {
      const int r = i / R, j = i % R;
      s_hq[i] = tanhf(s_head[r * 2 * R + R + j] + s_hq[i]);
    }
    __syncthreads();
    rows_matmul(s_hq, R, R, a.in[P_WK], a.in[P_WB], W, s_w, W);
    __syncthreads();
    for (int i = tid; i < ROWS * W; i += nthreads) {
      const int r = i / W, j = i % W;
      const float prob = sigmoid_f(s_w[i]);
      float bit;
      if (TRAIN) {
        bit = 0.f;
        if (r < nrows) {
          bit = uniform01(a, S_W, t, row0 + r, j, W) < prob ? 1.f : 0.f;
          if (a.flip_rec)
            bit = fabsf(bit - (uniform01(a, S_FW, t, row0 + r, j, W) <
                                       a.p_flip_rec ? 1.f : 0.f));
        }
      } else {
        bit = floorf(prob + 0.5f);
      }
      if (a.ignore_receiver) bit = 0.f;
      s_w[i] = bit;
      if (r < nrows) {
        o_wprob[out_row * W + i] = prob;
        o_wfeat[out_row * W + i] = bit;
      }
    }
    __syncthreads();
  }
}

// Fill the fields shared by both modes from the pointer and int tables.
void fill_args(Args& a, void* const* ptrs, const int* dims) {
  for (int i = 0; i < P_O_SFEAT; ++i) a.in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = P_O_SFEAT; i < P_COUNT; ++i)
    a.out[i - P_O_SFEAT] = static_cast<float*>(ptrs[i]);
  for (int i = 0; i < S_COUNT; ++i) a.u[i] = nullptr;
  a.B = dims[D_B]; a.F = dims[D_F]; a.H = dims[D_H]; a.W = dims[D_W];
  a.R = dims[D_R]; a.D = dims[D_D]; a.V = dims[D_V]; a.T = dims[D_T];
  a.mix = dims[D_MIX];
  a.ignore_receiver = dims[D_IGNORE_RECEIVER];
  a.s_prob_prod = dims[D_S_PROB_PROD];
  a.philox = a.flip_sen = a.flip_rec = 0;
  a.seed = a.step = 0u;
  a.p_flip_sen = a.p_flip_rec = 0.f;
}

template <bool TRAIN>
int launch(const Args& a, void* stream) {
  if (a.B <= 0) return 0;
  const size_t smem = sizeof(float) * static_cast<size_t>(make_layout(a).total);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_exchange_kernel<TRAIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (a.B + ROWS - 1) / ROWS;
  fused_exchange_kernel<TRAIN><<<blocks, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the whole eval conversation on `stream`. `ptrs` holds P_COUNT
// device pointers and `dims` D_COUNT ints, in the orders above. Returns 0
// or a cudaError_t code (the launch's cudaGetLastError()).
int mmg_fused_eval_exchange(void* const* ptrs, int n_ptrs, const int* dims,
                            int n_dims, void* stream) {
  if (n_ptrs != P_COUNT || n_dims != D_COUNT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  fill_args(a, ptrs, dims);
  return launch<false>(a, stream);
}

// Launch the whole sampled (train-mode) conversation on `stream`. `ptrs`
// holds P_TRAIN_COUNT pointers: the eval table, then the uniform streams
// z, fz, s, w, fw. `dims` holds D_TRAIN_COUNT ints; `probs` the two
// flipout probabilities (sender, receiver). With dims[D_PHILOX] == 0 the
// streams s, z, w (and fz, fw where flipout is on) must be given; with 1
// every stream must be null and Philox keyed by (D_SEED, D_STEP) draws the
// numbers. Returns 0 or a cudaError_t code.
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

const char* mmg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
