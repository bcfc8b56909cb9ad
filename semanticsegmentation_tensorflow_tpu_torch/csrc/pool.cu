// 2x2/2 max pool with its within-window argmax, and the unpool that routes by
// it: SegNet's encoder pools, their backward, and the decoder's unpools.
//
// Replaces: semanticsegmentation_tensorflow_tpu/ops/pallas/pool.py
// (pool_pairs_pallas: _fwd_kernel, the 2x2 max pool, and _bwd_kernel, the
// gradient routed to the FIRST maximum in (dy, dx) row-major order). Ported
// by function, not by block: on the TPU the kernel pooled the width-pair
// packed layout and recomputed the routing in its backward; here the forward
// writes the routing as a u8 index (2*dy + dx), the form SegNet's
// max_pool_with_argmax returns (ops/pool.py:70-101), and two passes route by
// it: place-or-zero into the window (the pool's backward, TF's
// MaxPoolGradWithArgmax, which is also the decoder's forward max_unpool,
// ops/pool.py:104-139) and select-at-index (the unpool's backward,
// ops/pool.py:146-161).
//
// Contract (NHWC bf16, C a multiple of 8, pooled pixel (py, px), channel c):
//   pool_argmax: out[py,px,c] = x[2py+dy, 2px+dx, c] at the first (dy, dx) in
//                row-major order whose value equals the window's maximum;
//                idx[py,px,c] = 2*dy + dx. H and W even.
//   unpool:      y[2py+dy, 2px+dx, c] = p[py,px,c] if idx == 2*dy + dx, else 0.
//   unpool_bwd:  d[py,px,c] = g[2py+dy, 2px+dx, c] at (dy, dx) = idx.
// All three are selections: the results are bit-equal to the plain PyTorch
// versions (ops/cuda/pool.py).
//
// What bounds it on the H100: bytes. Each pass reads every input byte once
// and writes every output byte once with no arithmetic to speak of: at the
// SegNet training shape the enc2 pool ([8,160,576,128] bf16 in) moves 260 MB,
// ~78 us at 3.35 TB/s, and the dec1 unpool (to [8,320,1152,64]) 519 MB,
// ~155 us. Design: one thread per pooled pixel and 8-channel octet, 16-byte
// vector loads and stores (the four window pixels of one octet are four
// uint4), the 8 u8 indices as one 8-byte access; octets vary fastest across
// threads, so a warp covers whole pixels of contiguous memory. No shared
// memory, no atomics: every output element has exactly one writer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

union Octet {  // 8 bf16 channels, one 16-byte vector
  uint4 raw;
  __nv_bfloat16 v[8];
};

union Codes {  // 8 u8 indices, one 8-byte access
  uint2 raw;
  uint8_t v[8];
};

__device__ __forceinline__ Octet load8(const __nv_bfloat16* p) {
  Octet o;
  o.raw = *reinterpret_cast<const uint4*>(p);
  return o;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const Octet& o) {
  *reinterpret_cast<uint4*>(p) = o.raw;
}

__device__ __forceinline__ Codes load_codes(const uint8_t* p) {
  Codes c;
  c.raw = *reinterpret_cast<const uint2*>(p);
  return c;
}

// offset of full-resolution pixel (2py+dy, 2px+dx) of image n, in elements
__device__ __forceinline__ size_t full_off(long long n, int py, int px, int dy,
                                           int dx, int H, int W, int C) {
  return (((size_t)n * H + 2 * py + dy) * W + 2 * px + dx) * C;
}

__global__ void __launch_bounds__(kThreads)
pool_argmax_kernel(const __nv_bfloat16* __restrict__ x,  // [N][H][W][C]
                   __nv_bfloat16* __restrict__ out,      // [N][H/2][W/2][C]
                   uint8_t* __restrict__ idx,            // [N][H/2][W/2][C]
                   long long total, int Hp, int Wp, int C) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int octets = C / 8;
  const int oct = (int)(t % octets);
  const long long p = t / octets;  // pooled pixel
  const int px = (int)(p % Wp);
  const int py = (int)((p / Wp) % Hp);
  const long long n = p / ((long long)Wp * Hp);
  const int H = 2 * Hp, W = 2 * Wp;
  Octet w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = load8(x + full_off(n, py, px, k >> 1, k & 1, H, W, C) + oct * 8);
  Octet m;
  Codes code;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // selects, not an indexed read, so the window stays in registers
    __nv_bfloat16 keep = w[0].v[c];
    float best = __bfloat162float(keep);
    uint8_t at = 0;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float v = __bfloat162float(w[k].v[c]);
      if (v > best) {  // strict: an equal later value never displaces the first
        best = v;
        keep = w[k].v[c];
        at = (uint8_t)k;
      }
    }
    m.v[c] = keep;
    code.v[c] = at;
  }
  store8(out + p * C + oct * 8, m);
  *reinterpret_cast<uint2*>(idx + p * C + oct * 8) = code.raw;
}

__global__ void __launch_bounds__(kThreads)
unpool_kernel(const __nv_bfloat16* __restrict__ pooled,  // [N][Hp][Wp][C]
              const uint8_t* __restrict__ idx,           // [N][Hp][Wp][C]
              __nv_bfloat16* __restrict__ y,             // [N][2Hp][2Wp][C]
              long long total, int Hp, int Wp, int C) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int octets = C / 8;
  const int oct = (int)(t % octets);
  const long long p = t / octets;
  const int px = (int)(p % Wp);
  const int py = (int)((p / Wp) % Hp);
  const long long n = p / ((long long)Wp * Hp);
  const Octet v = load8(pooled + p * C + oct * 8);
  const Codes code = load_codes(idx + p * C + oct * 8);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Octet o;
#pragma unroll
    for (int c = 0; c < 8; ++c) o.v[c] = code.v[c] == k ? v.v[c] : zero;
    store8(y + full_off(n, py, px, k >> 1, k & 1, 2 * Hp, 2 * Wp, C) + oct * 8, o);
  }
}

__global__ void __launch_bounds__(kThreads)
unpool_bwd_kernel(const __nv_bfloat16* __restrict__ g,  // [N][2Hp][2Wp][C]
                  const uint8_t* __restrict__ idx,      // [N][Hp][Wp][C]
                  __nv_bfloat16* __restrict__ d,        // [N][Hp][Wp][C]
                  long long total, int Hp, int Wp, int C) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int octets = C / 8;
  const int oct = (int)(t % octets);
  const long long p = t / octets;
  const int px = (int)(p % Wp);
  const int py = (int)((p / Wp) % Hp);
  const long long n = p / ((long long)Wp * Hp);
  Octet w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = load8(g + full_off(n, py, px, k >> 1, k & 1, 2 * Hp, 2 * Wp, C) + oct * 8);
  const Codes code = load_codes(idx + p * C + oct * 8);
  Octet o;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint8_t k = code.v[c];
    o.v[c] = k == 0 ? w[0].v[c] : k == 1 ? w[1].v[c] : k == 2 ? w[2].v[c] : w[3].v[c];
  }
  store8(d + p * C + oct * 8, o);
}

cudaError_t grid_for(long long total, unsigned* blocks) {
  const long long b = (total + kThreads - 1) / kThreads;
  if (b > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return cudaSuccess;
}

}  // namespace

// C entries. Pointers are device pointers, 16-byte aligned (the u8 index
// 8-byte aligned); `stream` is a cudaStream_t; C must be a positive multiple
// of 8. Hp, Wp are the POOLED sizes (the full-resolution tensor is
// [n][2Hp][2Wp][c]). Each returns a cudaError_t (0 on success).
extern "C" int seg_pool_argmax(const void* x, void* out, void* idx, int n, int hp,
                               int wp, int c, void* stream) {
  if (c <= 0 || c % 8 || n < 0 || hp < 0 || wp < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * hp * wp * (c / 8);
  if (total == 0) return 0;
  unsigned blocks = 0;
  cudaError_t err = grid_for(total, &blocks);
  if (err != cudaSuccess) return (int)err;
  pool_argmax_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<uint8_t*>(idx), total, hp, wp, c);
  return (int)cudaGetLastError();
}

extern "C" int seg_unpool(const void* pooled, const void* idx, void* y, int n,
                          int hp, int wp, int c, void* stream) {
  if (c <= 0 || c % 8 || n < 0 || hp < 0 || wp < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * hp * wp * (c / 8);
  if (total == 0) return 0;
  unsigned blocks = 0;
  cudaError_t err = grid_for(total, &blocks);
  if (err != cudaSuccess) return (int)err;
  unpool_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pooled), static_cast<const uint8_t*>(idx),
      static_cast<__nv_bfloat16*>(y), total, hp, wp, c);
  return (int)cudaGetLastError();
}

extern "C" int seg_unpool_bwd(const void* g, const void* idx, void* d, int n,
                              int hp, int wp, int c, void* stream) {
  if (c <= 0 || c % 8 || n < 0 || hp < 0 || wp < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * hp * wp * (c / 8);
  if (total == 0) return 0;
  unsigned blocks = 0;
  cudaError_t err = grid_for(total, &blocks);
  if (err != cudaSuccess) return (int)err;
  unpool_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(idx),
      static_cast<__nv_bfloat16*>(d), total, hp, wp, c);
  return (int)cudaGetLastError();
}
