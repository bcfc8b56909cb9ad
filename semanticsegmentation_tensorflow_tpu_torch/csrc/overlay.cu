// Fused argmax + colormap + alpha blend over the logits of a batch.
//
// Replaces: semanticsegmentation_tensorflow_tpu/ops/pallas/overlay.py:_overlay_kernel
//
// Per pixel: the class is found by a strict `>` scan, so ties go to the
// lowest class (for C == 2 this is `l1 > l0`); the pixel is blended as
// img*(1-alpha) + palette[label]*alpha in f32, class 0 keeps the image unless
// blend_class0, and the result is clipped to [0, 255] and truncated to u8.
// The blend is written with __fmul_rn/__fadd_rn: nvcc would otherwise
// contract it into an FMA, which rounds once where PyTorch's plain version
// (separate mul, mul, add) rounds three times, and the bytes could differ
// by one.
//
// The logits may be the padded model output [N,Hp,Wp,C]: the kernel reads
// the top-left [H,W] window in place, so the crop costs no copy.
//
// What bounds it on the H100: bytes. Per pixel it reads 4*C + 3 bytes and
// writes 7 (overlay + int32 label), with a handful of flops: 18 bytes for
// C == 2, 8.38 MB at 1x375x1242, 2.5 us at HBM speed. So the kernel must
// spend few instructions per byte. The design:
//
// * Each warp owns a tile of 128 consecutive pixels of the flattened
//   [N*H*W] image. The tile's row and column come from two 32-bit divisions
//   once per warp; a lane steps from there with compares (no division per
//   pixel, no 64-bit arithmetic but the row's pointer).
// * The tile's 384 image bytes start 16-byte aligned (384 * tile), so 24
//   lanes load them as uint4 into the warp's slice of shared memory and
//   store the 384 overlay bytes back the same way; each lane blends its
//   pixels there (12 bytes as three 32-bit words for C == 2).
// * C == 2 (the fast path): a lane owns 4 consecutive pixels, reads their
//   logits as two float4 where the 32 bytes are aligned and in one row (all
//   but the lanes that straddle a row end, W = 1242 not being a multiple of
//   4), and writes their labels as one int4. Any other C: a lane owns
//   pixels lane, lane + 32, ... of the tile (coalesced scalar loads over the
//   classes, coalesced label stores).
// * Blocks of 4 warps (512 pixels): the 910 blocks of 1x375x1242 are all
//   resident at once; at batch 8, 7,278 blocks stream through. Blocks of 8
//   or 16 warps were no faster, and a grid capped at 2 or 8 blocks an SM,
//   each warp walking several tiles, was slower (fewer bytes in flight).
//   At batch 1 about half the time is the launch itself: 455 blocks of 8
//   warps with no work take 2.4 us on the profiler's clock (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;                 // pixels a warp owns
constexpr int kPx = kTile / 32;            // pixels a lane owns
constexpr int kTileBytes = kTile * 3;      // image (and overlay) bytes of a tile

struct Blend {
  float alpha, one_minus_alpha;
  bool keep0;  // class 0 keeps the image (blend_class0 off)
};

// One channel byte of the blend, rounded as the plain version rounds it.
__device__ __forceinline__ uint32_t blend_byte(uint32_t byte, float pal_alpha,
                                               bool keep, const Blend& bl) {
  const float im = (float)byte;
  float v = keep ? im : __fadd_rn(__fmul_rn(im, bl.one_minus_alpha), pal_alpha);
  v = fminf(fmaxf(v, 0.f), 255.f);
  return (uint32_t)v;  // truncation, like the f32 -> u8 cast
}

// Batch, row and column of a pixel, stepped forward along the flattened
// image by compares (no division).
struct Pos {
  int b, y, x;
  __device__ __forceinline__ void advance(int by, int h, int w) {
    x += by;
    while (x >= w) {
      x -= w;
      if (++y == h) {
        y = 0;
        ++b;
      }
    }
  }
};

template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
overlay_kernel(const uint8_t* __restrict__ img,      // [N][H][W][3]
               const float* __restrict__ logits,     // [N][Hp][Wp][C]
               const float* __restrict__ palette,    // [C][3]
               uint8_t* __restrict__ out,            // [N][H][W][3]
               int32_t* __restrict__ labels,         // [N][H][W]
               unsigned total, int h, int w, int hp, int wp, int c,
               Blend bl) {
  __shared__ __align__(16) uint8_t stage[kWarps][kTileBytes];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned p0 = (blockIdx.x * kWarps + warp) * kTile;
  if (p0 >= total) return;
  const int npx = (int)min((unsigned)kTile, total - p0);
  const bool full = npx == kTile;
  uint8_t* s = stage[warp];

  // the image bytes of the tile: loaded first, stored to shared memory
  // after the logits' loads are in flight
  uint4 pix = make_uint4(0, 0, 0, 0);
  const bool vec_lane = full && lane < kTileBytes / 16;
  if (vec_lane) pix = __ldg(reinterpret_cast<const uint4*>(img + 3ull * p0) + lane);

  const unsigned r0 = p0 / (unsigned)w;
  Pos pos{(int)(r0 / (unsigned)h), 0, (int)(p0 - r0 * (unsigned)w)};
  pos.y = (int)(r0 - (unsigned)pos.b * (unsigned)h);

  int label[kPx];
  if constexpr (kTwo) {
    // pixels 4*lane .. 4*lane + 3 of the tile
    pos.advance(kPx * lane, h, w);
    const int q = kPx * lane;
    const float* row = logits + 2ull * ((size_t)(pos.b * hp + pos.y) * wp);
    const float* l = row + 2 * pos.x;
    if (q + kPx <= npx && pos.x + kPx <= w &&
        (reinterpret_cast<uintptr_t>(l) & 15) == 0) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(l));
      const float4 b = __ldg(reinterpret_cast<const float4*>(l) + 1);
      label[0] = a.y > a.x;
      label[1] = a.w > a.z;
      label[2] = b.y > b.x;
      label[3] = b.w > b.z;
    } else {
      Pos p = pos;
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        label[j] = 0;
        if (q + j < npx) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(
              logits + 2ull * ((size_t)(p.b * hp + p.y) * wp + p.x)));
          label[j] = v.y > v.x;
        }
        p.advance(1, h, w);
      }
    }
  } else {
    // pixels lane, lane + 32, lane + 64, lane + 96 of the tile
    pos.advance(lane, h, w);
    Pos p = pos;
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      label[j] = 0;
      if (32 * j + lane < npx) {
        const float* l = logits + (size_t)c * ((size_t)(p.b * hp + p.y) * wp + p.x);
        float best = __ldg(l);
        for (int k = 1; k < c; ++k) {
          const float v = __ldg(l + k);
          if (v > best) {
            best = v;
            label[j] = k;
          }
        }
      }
      p.advance(32, h, w);
    }
  }

  if (vec_lane) {
    reinterpret_cast<uint4*>(s)[lane] = pix;
  } else if (!full) {
    for (int k = lane; k < 3 * npx; k += 32) s[k] = img[3ull * p0 + k];
  }
  __syncwarp();

  if constexpr (kTwo) {
    const int q = kPx * lane;
    if (q + kPx <= npx) {
      *reinterpret_cast<int4*>(labels + p0 + q) =
          make_int4(label[0], label[1], label[2], label[3]);
    } else {
      for (int j = 0; j < kPx; ++j)
        if (q + j < npx) labels[p0 + q + j] = label[j];
    }
    float pa[2][3];  // palette * alpha, rounded once, as the plain version does
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        pa[k][ch] = __fmul_rn(__ldg(palette + 3 * k + ch), bl.alpha);
    // the lane's 12 bytes: pixel j, channel ch is byte 3j + ch
    uint32_t* words = reinterpret_cast<uint32_t*>(s) + 3 * lane;
    uint32_t wv[3] = {words[0], words[1], words[2]};
    uint32_t ov[3] = {0, 0, 0};
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const bool keep = label[j] == 0 && bl.keep0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int k = 3 * j + ch;
        const uint32_t byte = (wv[k / 4] >> (8 * (k % 4))) & 0xffu;
        const float pal = label[j] ? pa[1][ch] : pa[0][ch];
        ov[k / 4] |= blend_byte(byte, pal, keep, bl) << (8 * (k % 4));
      }
    }
    words[0] = ov[0];
    words[1] = ov[1];
    words[2] = ov[2];
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int q = 32 * j + lane;
      if (q >= npx) continue;
      labels[p0 + q] = label[j];
      const bool keep = label[j] == 0 && bl.keep0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float pal = __fmul_rn(__ldg(palette + 3 * label[j] + ch), bl.alpha);
        s[3 * q + ch] = (uint8_t)blend_byte(s[3 * q + ch], pal, keep, bl);
      }
    }
  }
  __syncwarp();

  if (vec_lane) {
    reinterpret_cast<uint4*>(out + 3ull * p0)[lane] = reinterpret_cast<const uint4*>(s)[lane];
  } else if (!full) {
    for (int k = lane; k < 3 * npx; k += 32) out[3ull * p0 + k] = s[k];
  }
}

}  // namespace

// C entry. Pointers are device pointers; `stream` is a cudaStream_t. The
// image, overlay and labels must be 16-byte aligned, the logits 8-byte
// aligned, and N*H*W below 2^31 (the wrapper checks). `one_minus_alpha` is
// computed by the caller exactly as the plain version does, so the two
// round alike. Returns a cudaError_t (0 on success).
extern "C" int seg_overlay(const void* img, const void* logits,
                           const void* palette, void* out, void* labels,
                           int n, int h, int w, int hp, int wp, int c,
                           float alpha, float one_minus_alpha, int blend_class0,
                           void* stream) {
  const long long total = (long long)n * h * w;
  if (total == 0) return (int)cudaSuccess;
  if (total >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + kWarps * kTile - 1) / (kWarps * kTile));
  const Blend bl{alpha, one_minus_alpha, blend_class0 == 0};
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* i8 = static_cast<const uint8_t*>(img);
  const auto* lg = static_cast<const float*>(logits);
  const auto* pl = static_cast<const float*>(palette);
  auto* o8 = static_cast<uint8_t*>(out);
  auto* lb = static_cast<int32_t*>(labels);
  if (c == 2)
    overlay_kernel<true><<<blocks, kThreads, 0, st>>>(i8, lg, pl, o8, lb, (unsigned)total,
                                                      h, w, hp, wp, c, bl);
  else
    overlay_kernel<false><<<blocks, kThreads, 0, st>>>(i8, lg, pl, o8, lb, (unsigned)total,
                                                       h, w, hp, wp, c, bl);
  return (int)cudaGetLastError();
}
