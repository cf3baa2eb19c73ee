// The rotation of q and k in each block of Qwen2.5-VL's vision tower
// (models/qwen_vision.py:VisionTower), one pass over the qkv product that
// also lays q, k and v out as attention reads them:
//
// * vit_rotary_qkv: the bias-added product (B * N, 3C), each token's row
//   q | k | v, heads of d values -> q, k and v, each (B * N, heads, d),
//   q and k rotated as x * cos + rotate_half(x) * sin, v as it came.
//   Each half of a head pairs with the other: x1 * c - x2 * s and
//   x2 * c + x1 * s, with c and s the angle tables' first half (their two
//   halves are equal). The arithmetic is float32 and rounded as
//   PyTorch's passes round it on the card (its product by cos, then
//   addcmul_ on each half: with value -1 the product x2 * s is rounded
//   before the difference, with value 1 x1 * s is fused into the sum;
//   the _rn intrinsics say which), so the two agree bit for bit, and
//   the result is rounded once to the element type.
// * Token t of image b goes to row batch * start + b * length + (t -
//   start), where (start, length) is its group's, read from `dest` (one
//   pair a token): in a windowed block a group is the windows of one
//   size, and each group's (B, n, s) windows lie in one contiguous block,
//   which attention reads as (B * n, s, heads, d) without a copy; in a
//   full block every token's pair is (0, N), the plain (B, N) order.
//
// Replaces no TPU kernel: the JAX package has no vision tower. It takes
// the place of four PyTorch passes over q and k (the float32 product by
// cos, two multiply-adds on the halves, the cast back) and of the copies
// that cut each window group out of q, k and v.
//
// What bounds it on an H100: bytes. It reads the product once and writes
// q, k and v once (at batch 100 and 364 x 504, 93,600 tokens of 3,840
// bfloat16 values: 1.44 GB, 0.43 ms at 3.35 TB/s); the angle tables
// (N x d float32 each) stay in L2. The design: one thread a pair of
// 16-byte vectors, vector j of a head's first half and vector j of its
// second, so rotate_half needs no exchange between threads; neighbouring
// threads take neighbouring vectors of a row, so loads and stores are
// whole sectors. It runs on the caller's stream, allocates nothing and
// reports cudaGetLastError after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 16 bytes of T as float32 values and back.
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// One thread a (row, part, head, j): part 0 q, 1 k, 2 v; j the vector of
// each half of the head. `per_row` = 3 * heads * vh, `per_part` = heads *
// vh, vh the 16-byte vectors in half a head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vit_rotary_qkv(const T* __restrict__ qkv, const float* __restrict__ cosines,
               const float* __restrict__ sines, const int2* __restrict__ dest,
               T* __restrict__ out, unsigned items, unsigned per_row,
               unsigned per_part, unsigned vh, unsigned tokens,
               unsigned batch, unsigned channels, unsigned head_dim) {
  using L = Lanes<T>;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const unsigned row = i / per_row;          // b * tokens + t
  unsigned rem = i - row * per_row;
  const unsigned part = rem / per_part;
  rem -= part * per_part;
  const unsigned head = rem / vh;
  const unsigned j = rem - head * vh;
  const unsigned b = row / tokens;
  const unsigned t = row - b * tokens;
  const unsigned half = head_dim / 2;
  const unsigned col = head * head_dim + j * L::kN;
  const int2 g = __ldg(dest + t);            // (start, length) of t's group
  const unsigned long long to =
      static_cast<unsigned long long>(batch) * g.x +
      static_cast<unsigned long long>(b) * g.y + (t - g.x);
  const T* src = qkv + static_cast<unsigned long long>(row) * 3 * channels +
                 part * channels + col;
  T* dst = out +
           (static_cast<unsigned long long>(part) * batch * tokens + to) *
               channels + col;
  uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
  uint4 hi = __ldg(reinterpret_cast<const uint4*>(src + half));
  if (part < 2) {
    float x1[L::kN], x2[L::kN], c[L::kN], s[L::kN];
    L::unpack(lo, x1);
    L::unpack(hi, x2);
    const float4* ct = reinterpret_cast<const float4*>(
        cosines + static_cast<unsigned long long>(t) * head_dim +
        j * L::kN);
    const float4* st = reinterpret_cast<const float4*>(
        sines + static_cast<unsigned long long>(t) * head_dim + j * L::kN);
#pragma unroll
    for (int q = 0; q < L::kN / 4; ++q) {
      const float4 a = __ldg(ct + q), e = __ldg(st + q);
      c[4 * q] = a.x; c[4 * q + 1] = a.y; c[4 * q + 2] = a.z;
      c[4 * q + 3] = a.w;
      s[4 * q] = e.x; s[4 * q + 1] = e.y; s[4 * q + 2] = e.z;
      s[4 * q + 3] = e.w;
    }
    float r1[L::kN], r2[L::kN];
#pragma unroll
    for (int e = 0; e < L::kN; ++e) {
      r1[e] = __fsub_rn(__fmul_rn(x1[e], c[e]), __fmul_rn(x2[e], s[e]));
      r2[e] = __fmaf_rn(x1[e], s[e], __fmul_rn(x2[e], c[e]));
    }
    lo = L::pack(r1);
    hi = L::pack(r2);
  }
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + half) = hi;
}

template <typename T>
cudaError_t launch(const void* qkv, const void* cosines, const void* sines,
                   const void* dest, void* out, unsigned batch,
                   unsigned tokens, unsigned heads, unsigned head_dim,
                   cudaStream_t stream) {
  const unsigned vh = head_dim / 2 / Lanes<T>::kN;
  const unsigned long long items =
      static_cast<unsigned long long>(batch) * tokens * 3 * heads * vh;
  if (vh == 0 || (head_dim / 2) % Lanes<T>::kN != 0 ||
      items >= (1ull << 31))
    return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>((items + kThreads - 1) / kThreads);
  vit_rotary_qkv<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cosines),
      static_cast<const float*>(sines), static_cast<const int2*>(dest),
      static_cast<T*>(out), static_cast<unsigned>(items), 3 * heads * vh,
      heads * vh, vh, tokens, batch, heads * head_dim, head_dim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (batch * tokens, 3 * heads * head_dim) -> out (3, batch * tokens,
// heads, head_dim), q and k rotated by cosines and sines (tokens,
// head_dim) float32, each token's row placed by dest (tokens, 2) int32.
// Elements bfloat16 (elem_bytes 2) or float32 (4); pointers 16-byte
// aligned, half a head a multiple of 16 bytes. Returns 0 or a cudaError_t code.
int mmg_vit_rotary_qkv(const void* qkv, const void* cosines,
                       const void* sines, const void* dest, void* out,
                       int batch, int tokens, int heads, int head_dim,
                       int elem_bytes, void* stream) {
  if (batch <= 0 || tokens <= 0 || heads <= 0 || head_dim <= 0 ||
      head_dim % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 2)
    err = launch<__nv_bfloat16>(qkv, cosines, sines, dest, out, batch,
                                tokens, heads, head_dim, s);
  else if (elem_bytes == 4)
    err = launch<float>(qkv, cosines, sines, dest, out, batch, tokens, heads,
                        head_dim, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* mmg_vit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
