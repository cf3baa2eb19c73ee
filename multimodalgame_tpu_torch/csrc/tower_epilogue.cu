// The elementwise work of the served ResNet-34 tower
// (models/resnet.py:PixelTower), one pass after each of its convolutions.
// Every batch norm's scale is folded into the weights of the convolution
// before it and its shift is that convolution's bias (resnet.py:
// fold_batch_norms); cuDNN computes the convolutions without a bias, and
// these kernels finish them:
//
// * tower_normalize: uint8 pixels -> float32 ((x / 255) - 0.5) / 0.5
//   (ToTensor + Normalize(.5, .5)), each step rounded as PyTorch's three
//   passes round it on the card: its division by a number is a product by
//   the number's float32 reciprocal, and the division by 0.5 is exact.
// * tower_stem: conv1's output y -> max_pool(relu(y + b)), 3x3 window,
//   stride 2, padding 1, computed as relu(max(window) + b[c]). That is
//   exact: rounding y + b is monotone in y, and so is ReLU, so both
//   commute with the max.
// * tower_epilogue: y <- act(y + b[c] [+ (r + rb[c])]) in place, act ReLU
//   or none. r is the block's shortcut: its input, or the downsample
//   convolution's output, whose bias rb is added here rather than in a
//   pass of its own.
//
// Replaces no TPU kernel: the JAX package leaves the network to XLA,
// which fuses these passes into its convolutions' epilogues; cuDNN's
// float32 convolutions end at their outputs, so the port finishes each in
// one pass of its own instead of PyTorch's separate scale, shift, ReLU,
// sum and pooling kernels.
//
// What bounds them on an H100: bytes. None does more than a few
// operations an element; each reads its input once and writes its output
// once (3.35 TB/s). The design: 16-byte loads and stores (uchar4 in,
// float4 out for normalize); a block epilogue's grid is (float4s of an
// image, image), and the channel of each of a thread's four values comes
// from one multiply-shift division (FastDiv) of its offset in the image
// by the plane size, then counting across a plane's end, since the
// 57x57, 29x29 and 15x15 planes are not multiples of four values. The
// stem gives each thread one output; its 3x3 window's nine loads
// overlap its neighbours' and come from L1, so device memory sees conv1's
// output about once. Every kernel runs on the caller's stream, allocates
// nothing and reports cudaGetLastError after its launches.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kStemW = 32;     // a stem block's outputs: 32 columns
constexpr int kStemH = 8;      // by 8 rows
constexpr int kMaxGridYZ = 65535;

// n / d for 0 <= n < 2^31 by a multiply-high and a shift, the magic number
// computed on the host (PyTorch's IntDivider): s = ceil(log2 d),
// m = floor(2^32 (2^s - d) / d) + 1, n / d = (umulhi(n, m) + n) >> s.
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_fast_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned fast_div(unsigned n, FastDiv f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

// PyTorch's max_pool2d and ReLU carry a NaN through; so do these.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float relu(float x) {
  return (x < 0.0f) ? 0.0f : x;
}

// The explicit _rn intrinsics keep the compiler from contracting the
// product and the difference into one fused multiply-add, which would
// round once where PyTorch's passes round twice.
__device__ __forceinline__ float normalize_one(unsigned char v) {
  return __fmul_rn(__fsub_rn(__fmul_rn(static_cast<float>(v),
                                       1.0f / 255.0f), 0.5f), 2.0f);
}

__global__ void __launch_bounds__(kThreads)
tower_normalize(const unsigned char* __restrict__ in,
                float* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = first; i < n4; i += step) {
    const uchar4 v = reinterpret_cast<const uchar4*>(in)[i];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(normalize_one(v.x), normalize_one(v.y),
                    normalize_one(v.z), normalize_one(v.w));
  }
  for (long long i = 4 * n4 + first; i < n; i += step)
    out[i] = normalize_one(in[i]);
}

// One output of the pooled stem a thread; blockIdx.z numbers the (image,
// channel) planes from plane0.
__global__ void __launch_bounds__(kStemW * kStemH)
tower_stem(const float* __restrict__ y, const float* __restrict__ bias,
           float* __restrict__ out, unsigned plane0, FastDiv channels,
           int h, int w, int oh, int ow) {
  const int col = blockIdx.x * kStemW + threadIdx.x;
  const int row = blockIdx.y * kStemH + threadIdx.y;
  if (col >= ow || row >= oh) return;
  const unsigned p = plane0 + blockIdx.z;
  const unsigned c = p - fast_div(p, channels) * channels.d;
  const float* src = y + static_cast<long long>(p) * h * w;
  float m = -CUDART_INF_F;
#pragma unroll
  for (int dh = -1; dh <= 1; ++dh) {
    const int r = 2 * row + dh;
    if (r < 0 || r >= h) continue;
#pragma unroll
    for (int dw = -1; dw <= 1; ++dw) {
      const int q = 2 * col + dw;
      if (q < 0 || q >= w) continue;
      m = max_nan(m, __ldg(src + r * w + q));
    }
  }
  out[static_cast<long long>(p) * oh * ow + row * ow + col] =
      relu(__fadd_rn(m, __ldg(bias + c)));
}

// Four values of image blockIdx.y (from image n0) a thread; `plane` divides
// by the plane size h * w, `cp` is the image's size, channels * h * w,
// a multiple of four.
template <bool RESIDUAL, bool RELU>
__global__ void __launch_bounds__(kThreads)
tower_epilogue(float* __restrict__ y, const float* __restrict__ bias,
               const float* __restrict__ r, const float* __restrict__ rbias,
               unsigned n0, unsigned cp, FastDiv plane) {
  const unsigned e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= cp) return;
  const long long off =
      static_cast<long long>(n0 + blockIdx.y) * cp + e;
  const float4 a = *reinterpret_cast<const float4*>(y + off);
  float v[4] = {a.x, a.y, a.z, a.w};
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (RESIDUAL) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(r + off));
    s[0] = b.x; s[1] = b.y; s[2] = b.z; s[3] = b.w;
  }
  unsigned c = fast_div(e, plane);
  unsigned k = e - c * plane.d;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t = __fadd_rn(v[j], __ldg(bias + c));
    if (RESIDUAL)
      t = __fadd_rn(t, rbias == nullptr ? s[j]
                                        : __fadd_rn(s[j], __ldg(rbias + c)));
    v[j] = RELU ? relu(t) : t;
    if (++k == plane.d) {   // the next value starts the next channel
      k = 0;
      ++c;
    }
  }
  *reinterpret_cast<float4*>(y + off) = make_float4(v[0], v[1], v[2], v[3]);
}

template <bool RESIDUAL, bool RELU>
cudaError_t launch_epilogue(float* y, const float* bias, const float* r,
                            const float* rbias, int n, unsigned cp,
                            FastDiv plane, cudaStream_t stream) {
  const unsigned blocks = (cp / 4 + kThreads - 1) / kThreads;
  for (int n0 = 0; n0 < n; n0 += kMaxGridYZ) {
    const int images = std::min(n - n0, kMaxGridYZ);
    tower_epilogue<RESIDUAL, RELU><<<dim3(blocks, images), kThreads, 0,
                                     stream>>>(y, bias, r, rbias, n0, cp,
                                               plane);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// `n` uint8 values at `in` (4-byte aligned) as float32 at `out` (16-byte
// aligned). Returns 0 or a cudaError_t code.
int mmg_tower_normalize(const void* in, void* out, long long n,
                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1
                                      : want > (1 << 20) ? (1 << 20) : want);
  tower_normalize<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(in), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// y (n, c, h, w) -> out (n, c, oh, ow): relu(max over each 3x3 window of
// stride 2 and padding 1 + bias[c]). Returns 0 or a cudaError_t code.
int mmg_tower_stem(const void* y, const void* bias, void* out, int n, int c,
                   int h, int w, int oh, int ow, void* stream) {
  if (n <= 0 || c <= 0 || oh <= 0 || ow <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned planes = static_cast<unsigned>(n) * c;
  const dim3 block(kStemW, kStemH);
  for (unsigned p0 = 0; p0 < planes; p0 += kMaxGridYZ) {
    const dim3 grid((ow + kStemW - 1) / kStemW, (oh + kStemH - 1) / kStemH,
                    std::min(planes - p0, static_cast<unsigned>(kMaxGridYZ)));
    tower_stem<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(y), static_cast<const float*>(bias),
        static_cast<float*>(out), p0, make_fast_div(c), h, w, oh, ow);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// y (n, c, plane) <- act(y + bias[c] [+ (r + rbias[c])]) in place; r null:
// no shortcut; rbias null: none on it; act 1 for ReLU, 0 for none. y and r
// 16-byte aligned, c * plane a multiple of 4 below 2^31. Returns 0 or a
// cudaError_t code.
int mmg_tower_epilogue(void* y, const void* bias, const void* r,
                       const void* rbias, int n, int c, int plane, int act,
                       void* stream) {
  const long long cp = static_cast<long long>(c) * plane;
  if (n <= 0 || plane <= 0 || cp <= 0 || cp % 4 != 0 || cp >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  float* yy = static_cast<float*>(y);
  const float* b = static_cast<const float*>(bias);
  const float* rr = static_cast<const float*>(r);
  const float* rb = static_cast<const float*>(rbias);
  const FastDiv div = make_fast_div(static_cast<unsigned>(plane));
  const unsigned size = static_cast<unsigned>(cp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rr != nullptr)
    err = act ? launch_epilogue<true, true>(yy, b, rr, rb, n, size, div, s)
               : launch_epilogue<true, false>(yy, b, rr, rb, n, size, div, s);
  else
    err = act ? launch_epilogue<false, true>(yy, b, rr, rb, n, size, div, s)
               : launch_epilogue<false, false>(yy, b, rr, rb, n, size, div,
                                               s);
  return static_cast<int>(err);
}

const char* mmg_tower_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
