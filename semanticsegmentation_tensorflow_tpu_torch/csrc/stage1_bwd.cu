// VGG stage1 tail, backward: the gradients of
//   out = relu(maxpool2(conv3x3(relu(z1), k2)) + b2)
// with respect to z1, k2 and b2, routed by the forward's 2-bit pool codes.
//
// Replaces: semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:_bwd_kernel
// (via _fused_bwd / _bwd_call; FCN mode, single device, z1 pre-biased).
// It computes what _fused_bwd computes, on the port's NHWC layout, not the
// TPU's width-pair-packed M/S form.
//
// Contract (g, out, codes [N,H/2,W/2,C]; z1, dz1 [N,H,W,C]; all bf16 but codes):
//   gr[p]      = out[p] > 0 ? g[p] : 0                        (stage1.py:312)
//   dz2[y,x,c] = gr[y/2,x/2,c] if codes[y/2,x/2,c] == 2*(y&1) + (x&1), else 0
//                (bf16, each pooled gradient to exactly one conv pixel; :326)
//   dz1[y,x,ci]  = bf16(z1 > 0 ? sum_{dy,dx,co} dz2[y-dy+1, x-dx+1, co]
//                                   * k2[co,ci,dy,dx] : 0)    (:377-381)
//   dk2[co,ci,dy,dx] = sum_{n,y,x} dz2[y,x,co] * relu(z1)[y+dy-1, x+dx-1, ci]
//   db2[c]       = sum gr[., c]
// f32 accumulation throughout; dz2 is zero and relu(z1) is zero outside the
// image (the SAME halo); dz1 is written only inside it.
//
// What bounds it on the H100: the math. dgrad and wgrad each do the
// forward conv's multiply-adds (2 x 17.7 G per 384x1248 image, 2 x 136 G
// for a 8x320x1152 batch); the bytes are g, out, codes, z1 read and dz1
// written (~5 bytes per conv pixel per channel).
//
// Design, three launches:
//  1. dgrad: the forward kernel's implicit GEMM (stage1_mma.cuh) with the
//     flipped, transposed kernel wt[ci][dy][dx][co] = k2[co][ci][2-dy][2-dx]
//     (M = conv pixels, N = Cin, K = 9*Cout). The staged input tile is dz2,
//     built in shared memory from g, out and codes, halo zero; the epilogue
//     applies relu'(z1) and stores bf16.
//  2. wgrad: per tap row dy (gridDim.y = 3), a GEMM with M = Cout, N = 3*Cin
//     (the three dx taps), K = conv pixels. Each block stages a 4 x 32 tile
//     of dz2 and the (4+2) x (32+2) tile of relu(z1), feeds both to mma.sync
//     through transposing ldmatrix loads (the shifted input is a shifted row
//     address), and keeps its partial sums in registers over all the tiles
//     it walks. It writes its f32 partial once; blocks with dy == 0 also sum
//     dz2 into partial db2 (the same pixels, so the same total as gr).
//  3. a sum over the partials in a fixed order, one thread per output
//     element. No float atomics: two runs are bit-identical, as the TPU's
//     per-row-block partials are (stage1.py:559-562).
// Simple first; the dz2 tile is rebuilt from global memory per tile (each
// pooled element is read by four conv pixels, from L1/L2).
//
// Halo mode (kernel 1c; the same _bwd_kernel with spmd=True, via _bwd_cp
// :652): this rank holds conv rows [0, H) of an image split by rows. z1
// arrives WITHOUT b1 and every read of it becomes relu(bf16(z + b1)) (the
// relu mask of dz1 too, stage1.py:378-380); the wgrad's rows -1 and H come
// from the pre-bias halo rows ztop / zbot (-inf at the image's edge). The
// routed gradient of conv rows -1 and H, which the dgrad of rows 0 and H-1
// reads, is rebuilt from the neighbours' boundary pooled rows of g, out and
// codes (gt/ot/ct, gb/ob/cb; zero at the edge), where single-device it is
// the SAME padding's zero (the `y >= 0 && y < H` bounds). No gradient flows
// into the halo rows: each rank writes only its own dz1 rows, as each TPU
// block does (stage1.py:282-283). db1 = sum of dz1 comes out as per-block
// f32 partials of the dgrad launch (each thread sums the bf16 dz1 values it
// stores, the block reduces them in a fixed order) and is summed in the
// fixed order of dk2 and db2 (stage1.py:382-388, :409-411). The bias adds
// are packed bf16 adds (__hadd2, one rounding): for two bf16 operands that
// equals PyTorch's f32 add rounded to bf16 (an f32 sum of two bf16 values
// never lands on a bf16 rounding midpoint it was not at exactly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_mma.cuh"

namespace {

using namespace stage1;

// The pooled tensors the backward routes by: g, out, codes [N][Ho][Wo][C]
// and, in halo mode, the pooled row just above this rank's rows (gt, ot, ct)
// and just below them (gb, ob, cb), each [N][1][Wo][C].
struct Pooled {
  const __nv_bfloat16 *g, *out;
  const uint8_t* codes;
  const __nv_bfloat16 *gt, *ot;
  const uint8_t* ct;
  const __nv_bfloat16 *gb, *ob;
  const uint8_t* cb;
};

// dz2 for one conv pixel (y, x) and 8 channels from ch8: the pooled gradient
// where the code selects this pixel and out > 0. y in [0, H), or -1 / H
// (the halo rows) in halo mode.
__device__ __forceinline__ uint4 routed_grad(const Pooled& P, int n, int y, int x,
                                             int Ho, int Wo, int C, int ch8) {
  const __nv_bfloat16 *g = P.g, *out = P.out;
  const uint8_t* codes = P.codes;
  size_t o;
  if (y < 0 || y >= 2 * Ho) {
    if (y < 0) g = P.gt, out = P.ot, codes = P.ct;
    else g = P.gb, out = P.ob, codes = P.cb;
    o = ((size_t)n * Wo + (x >> 1)) * C + ch8;
  } else {
    o = (((size_t)n * Ho + (y >> 1)) * Wo + (x >> 1)) * C + ch8;
  }
  const uint4 gv = *reinterpret_cast<const uint4*>(g + o);
  const uint4 ov = *reinterpret_cast<const uint4*>(out + o);
  const uint2 cv = *reinterpret_cast<const uint2*>(codes + o);
  const uint32_t sel = 2u * (y & 1) + (x & 1);  // y = -1: the window's row 1
  const uint16_t* gh = reinterpret_cast<const uint16_t*>(&gv);
  const __nv_bfloat16* oh = reinterpret_cast<const __nv_bfloat16*>(&ov);
  const uint8_t* cb = reinterpret_cast<const uint8_t*>(&cv);
  uint4 r;
  uint16_t* rh = reinterpret_cast<uint16_t*>(&r);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rh[k] = (cb[k] == sel && __bfloat162float(oh[k]) > 0.f) ? gh[k] : (uint16_t)0;
  return r;
}

// z1 + b1 in halo mode (one bf16 rounding, as the forward adds it), z1
// otherwise; 2 channels
template <bool kHalo>
__device__ __forceinline__ float2 biased2(const __nv_bfloat16* __restrict__ z,
                                          const __nv_bfloat16* __restrict__ b1) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(z);
  if constexpr (kHalo) v = __hadd2(v, *reinterpret_cast<const __nv_bfloat162*>(b1));
  return __bfloat1622float2(v);
}

// relu(z1 (+ b1 in halo mode)) of 8 channels
template <bool kHalo>
__device__ __forceinline__ uint4 relu8(uint4 v, const __nv_bfloat16* __restrict__ b1) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  uint4 bv;
  if constexpr (kHalo) bv = *reinterpret_cast<const uint4*>(b1);
  const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kHalo) h[k] = __hadd2(h[k], bh[k]);
    h[k] = __hmax2(h[k], __float2bfloat162_rn(0.f));
  }
  return v;
}

// ---------------------------------------------------------------------------
// 1. dgrad
// ---------------------------------------------------------------------------

template <int C, bool kHalo>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stage1_dgrad_kernel(const Pooled P,                          // [N][H/2][W/2][C]
                    const __nv_bfloat16* __restrict__ z1,    // [N][H][W][C]
                    const __nv_bfloat16* __restrict__ b1,    // [C] halo mode
                    const __nv_bfloat16* __restrict__ wt,    // [Cin][3][3][Cout]
                    __nv_bfloat16* __restrict__ dz1,         // [N][H][W][C]
                    float* __restrict__ db1_part,            // [gridDim.x][C] halo mode
                    int n_img, int H, int W) {
  constexpr int RS = row_stride(C);
  constexpr int NB = C / 16;
  constexpr int CH = C / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [9][C][RS]
  __nv_bfloat16* tile = ws + weight_elems(C);                  // [6][34][RS]

  stage_weights<C>(ws, wt);

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (W + kConvCols - 1) / kConvCols;
  const int tiles_y = (H + kConvRows - 1) / kConvRows;
  const int n_tiles = n_img * tiles_y * tiles_x;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pr = warp & 1;
  const int cs = ((warp >> 1) & 1) * 16;
  const int nbase = (warp >> 2) * (C / 2);
  // halo mode: this thread's sums of the dz1 it stores, channels
  // nbase + 8j + 2*(lane%4) + {0,1}
  float db1acc[2 * NB];
#pragma unroll
  for (int k = 0; k < 2 * NB; ++k) db1acc[k] = 0.f;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
    const int n = t / (tiles_x * tiles_y);
    const int r0 = ty * kConvRows, c0 = tx * kConvCols;

    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kTileRows * kTileCols * CH; i += kThreads) {
      const int ch = i % CH, p = i / CH;
      const int tc = p % kTileCols, tr = p / kTileCols;
      const int y = r0 - 1 + tr, x = c0 - 1 + tc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const bool row_ok = kHalo ? (y >= -1 && y <= H) : (y >= 0 && y < H);
      if (row_ok && x >= 0 && x < W) v = routed_grad(P, n, y, x, Ho, Wo, C, ch * 8);
      *reinterpret_cast<uint4*>(tile + p * RS + ch * 8) = v;
    }
    __syncthreads();

    float acc[2][NB][4];
    conv_tile<C>(tile, ws, acc, pr, cs, nbase, lane);

    // epilogue: relu'(z1) mask, one bf16 rounding, 4-byte stores
    const int gq = lane >> 2;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = r0 + 2 * pr + m;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int x = c0 + cs + gq + 8 * half;
        if (y >= H || x >= W) continue;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int c = nbase + j * 8 + 2 * (lane & 3);
          const size_t o = (((size_t)n * H + y) * W + x) * C + c;
          const float2 z = biased2<kHalo>(z1 + o, b1 + c);
          const float d0 = z.x > 0.f ? acc[m][j][2 * half] : 0.f;
          const float d1 = z.y > 0.f ? acc[m][j][2 * half + 1] : 0.f;
          const __nv_bfloat162 d = __floats2bfloat162_rn(d0, d1);
          *reinterpret_cast<__nv_bfloat162*>(dz1 + o) = d;
          if constexpr (kHalo) {
            const float2 f = __bfloat1622float2(d);
            db1acc[2 * j] += f.x;
            db1acc[2 * j + 1] += f.y;
          }
        }
      }
    }
  }
  if constexpr (kHalo) {
    // the block's db1 partial: the 32 threads of channel c (4 warps with
    // its nbase, 8 lanes with its lane%4) summed in a fixed order
    __syncthreads();  // the tile is no longer read: reuse it
    float* red = reinterpret_cast<float*>(tile);  // [kThreads][2*NB]
#pragma unroll
    for (int k = 0; k < 2 * NB; ++k) red[threadIdx.x * 2 * NB + k] = db1acc[k];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const int half = c / (C / 2), j = (c % (C / 2)) / 8, q = (c % 8) / 2;
      float s = 0.f;
      for (int wl = 0; wl < 4; ++wl)
        for (int g8 = 0; g8 < 8; ++g8)
          s += red[((4 * half + wl) * 32 + 4 * g8 + q) * 2 * NB + 2 * j + (c & 1)];
      db1_part[(size_t)blockIdx.x * C + c] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. wgrad (+ db2)
// ---------------------------------------------------------------------------

constexpr int kWRows = 4;                 // conv rows per wgrad tile
constexpr int kWCols = 32;                // conv columns per wgrad tile
constexpr int kWPix = kWRows * kWCols;    // K per tile (multiple of 16)

template <int C>
struct Wgrad {
  static constexpr int MT = C / 16;            // m16 tiles of Cout
  static constexpr int kWarps = 2 * MT;        // per m16 tile, two halves of N
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NT = 3 * C / 8;         // n8 tiles per tap row (dx, ci)
  static constexpr int NTW = NT / 2;           // n8 tiles per warp
  static constexpr int RS = row_stride(C);
  static constexpr size_t kSmem =
      ((size_t)kWPix * RS + (size_t)(kWRows + 2) * (kWCols + 2) * RS) *
          sizeof(__nv_bfloat16) +
      (size_t)kThreads * 8 * sizeof(float);
};

template <int C, bool kHalo>
__global__ void __launch_bounds__(Wgrad<C>::kThreads)
stage1_wgrad_kernel(const Pooled P,
                    const __nv_bfloat16* __restrict__ z1,
                    const __nv_bfloat16* __restrict__ ztop,  // [N][1][W][C] halo mode
                    const __nv_bfloat16* __restrict__ zbot,  // [N][1][W][C] halo mode
                    const __nv_bfloat16* __restrict__ b1,    // [C] halo mode
                    float* __restrict__ dk_part,   // [parts][3 dy][C co][3 dx][C ci]
                    float* __restrict__ db_part,   // [parts][C]
                    int n_img, int H, int W) {
  using Cfg = Wgrad<C>;
  constexpr int RS = Cfg::RS;
  constexpr int CH = C / 8;
  constexpr int NTW = Cfg::NTW;
  constexpr int YC = kWCols + 2;
  static_assert(Cfg::kThreads % CH == 0, "a thread stages one channel chunk");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* dzt = reinterpret_cast<__nv_bfloat16*>(smem);  // [kWPix][RS]
  __nv_bfloat16* yt = dzt + kWPix * RS;                         // [6][34][RS]
  float* red = reinterpret_cast<float*>(yt + (kWRows + 2) * YC * RS);  // [threads][8]

  const int dyt = blockIdx.y;                  // tap row of this block
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (W + kWCols - 1) / kWCols;
  const int tiles_y = (H + kWRows - 1) / kWRows;
  const int n_tiles = n_img * tiles_y * tiles_x;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp % Cfg::MT;               // Cout rows mt*16..+16
  const int nh = warp / Cfg::MT;               // n8 tiles nh*NTW..+NTW
  const int mat = lane >> 3, r8 = lane & 7;

  // per lane, the (dx, ci) of the B rows it addresses for tile pair i
  float acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  float dbacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
    const int n = t / (tiles_x * tiles_y);
    const int r0 = ty * kWRows, c0 = tx * kWCols;

    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kWPix * CH; i += Cfg::kThreads) {
      const int ch = i % CH, p = i / CH;
      const int y = r0 + p / kWCols, x = c0 + p % kWCols;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (y < H && x < W) {
        v = routed_grad(P, n, y, x, Ho, Wo, C, ch * 8);
        if (dyt == 0) {
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int k = 0; k < 8; ++k) dbacc[k] += __bfloat162float(h[k]);
        }
      }
      *reinterpret_cast<uint4*>(dzt + p * RS + ch * 8) = v;
    }
    for (int i = threadIdx.x; i < (kWRows + 2) * YC * CH; i += Cfg::kThreads) {
      const int ch = i % CH, p = i / CH;
      const int y = r0 - 1 + p / YC, x = c0 - 1 + p % YC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const __nv_bfloat16* src = nullptr;
      if (x >= 0 && x < W) {
        if (y >= 0 && y < H) src = z1 + (((size_t)n * H + y) * W + x) * C;
        else if (kHalo && y == -1) src = ztop + ((size_t)n * W + x) * C;
        else if (kHalo && y == H) src = zbot + ((size_t)n * W + x) * C;
      }
      if (src) v = relu8<kHalo>(*reinterpret_cast<const uint4*>(src + ch * 8), b1 + ch * 8);
      *reinterpret_cast<uint4*>(yt + p * RS + ch * 8) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int kb = 0; kb < kWPix / 16; ++kb) {
      const int r = kb / (kWCols / 16), cb = (kb % (kWCols / 16)) * 16;
      // A = dz2^T: rows m = Cout, k = pixels. Matrix mat covers
      // m + 8*(mat&1), k + 8*(mat>>1); stored [pixel][co], so transposed.
      uint32_t a[4];
      ldsm_x4_t(a, dzt + (r * kWCols + cb + 8 * (mat >> 1) + r8) * RS +
                       mt * 16 + 8 * (mat & 1));
      // B = relu(z1) shifted by the tap: rows k = pixels, n = Cin; matrix
      // mat covers k + 8*(mat&1) of n8 tile (mat>>1) of the pair
#pragma unroll
      for (int i = 0; i + 1 < NTW; i += 2) {
        const int nt = nh * NTW + i + (mat >> 1);
        const int dx = nt / (C / 8), ci0 = (nt % (C / 8)) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, yt + ((r + dyt) * YC + cb + 8 * (mat & 1) + r8 + dx) * RS + ci0);
        mma_bf16(acc[i], a, b[0], b[1]);
        mma_bf16(acc[i + 1], a, b[2], b[3]);
      }
      if constexpr (NTW % 2) {
        const int nt = nh * NTW + NTW - 1;
        const int dx = nt / (C / 8), ci0 = (nt % (C / 8)) * 8;
        uint32_t b0, b1;
        ldsm_x2_t(b0, b1, yt + ((r + dyt) * YC + cb + 8 * (mat & 1) + r8 + dx) * RS + ci0);
        mma_bf16(acc[NTW - 1], a, b0, b1);
      }
    }
  }

  // the block's partial: fragment rows co = mt*16 + lane/4 (+8), columns
  // ci = ci0 + 2*(lane%4) + {0,1}
  float* part = dk_part + ((size_t)blockIdx.x * 3 + dyt) * C * 3 * C;
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int nt = nh * NTW + i;
    const int dx = nt / (C / 8), ci = (nt % (C / 8)) * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = mt * 16 + (lane >> 2) + 8 * h;
      float2* dst = reinterpret_cast<float2*>(part + ((size_t)co * 3 + dx) * C + ci);
      *dst = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
  if (dyt == 0) {  // db2: thread t summed channels 8*(t % CH)..+8
#pragma unroll
    for (int k = 0; k < 8; ++k) red[threadIdx.x * 8 + k] = dbacc[k];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += Cfg::kThreads) {
      float s = 0.f;
      for (int th = c / 8; th < Cfg::kThreads; th += CH) s += red[th * 8 + c % 8];
      db_part[(size_t)blockIdx.x * C + c] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the fixed-order sum of the partials
// ---------------------------------------------------------------------------

__global__ void stage1_wgrad_sum_kernel(const float* __restrict__ dk_part,
                                        const float* __restrict__ db_part,
                                        const float* __restrict__ db1_part,
                                        float* __restrict__ dk2,  // [C][3][3][C]
                                        float* __restrict__ db2,
                                        float* __restrict__ db1,  // halo mode
                                        int parts, int dparts, int C) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nk = 9 * C * C;
  if (e < nk) {
    const int ci = e % C, dx = (e / C) % 3, dy = (e / (3 * C)) % 3, co = e / (9 * C);
    const size_t src = (((size_t)dy * C + co) * 3 + dx) * C + ci;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += dk_part[(size_t)p * nk + src];
    dk2[e] = s;
  } else if (e < nk + C) {
    const int c = e - nk;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += db_part[(size_t)p * C + c];
    db2[c] = s;
  } else if (db1 != nullptr && e < nk + 2 * C) {
    const int c = e - nk - C;
    float s = 0.f;
    for (int p = 0; p < dparts; ++p) s += db1_part[(size_t)p * C + c];
    db1[c] = s;
  }
}

template <int C>
long long wgrad_tiles(int n, int h, int w) {
  return (long long)n * ((h + kWRows - 1) / kWRows) * ((w + kWCols - 1) / kWCols);
}

template <int C>
cudaError_t wgrad_parts(int n, int h, int w, int* parts) {
  const size_t smem = Wgrad<C>::kSmem;
  // the halo instance has the same resources; the plain one sets the count
  cudaError_t err = cudaFuncSetAttribute(stage1_wgrad_kernel<C, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = wgrad_tiles<C>(n, h, w);
  int grid = 0;
  // the three tap rows share the card: a third of the resident blocks each
  if ((err = persistent_grid(stage1_wgrad_kernel<C, false>, Wgrad<C>::kThreads, smem,
                             tiles * 3, &grid)) != cudaSuccess)
    return err;
  grid /= 3;
  *parts = (int)(grid < 1 ? 1 : (tiles < grid ? tiles : grid));
  return cudaSuccess;
}

// the backward's tensors; ztop, zbot, b1 (and P's halo rows) are read and
// db1_part, db1 written in halo mode only
struct BwdArgs {
  Pooled P;
  const void *z1, *ztop, *zbot, *b1, *wt;
  void *dz1, *dk_part, *db_part, *db1_part, *dk2, *db2, *db1;
};

// The dgrad launch's persistent grid: the number of db1 partials.
template <int C>
cudaError_t dgrad_parts(int n, int h, int w, int* parts) {
  const size_t smem = conv_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(stage1_dgrad_kernel<C, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)n * ((h + kConvRows - 1) / kConvRows) *
                          ((w + kConvCols - 1) / kConvCols);
  return persistent_grid(stage1_dgrad_kernel<C, true>, kThreads, smem, tiles, parts);
}

template <int C, bool kHalo>
cudaError_t launch_bwd(const BwdArgs& a, int parts, int dparts, int n, int h, int w,
                       cudaStream_t stream) {
  using B = __nv_bfloat16;
  const auto* zb = static_cast<const B*>(a.z1);
  const auto* b1 = static_cast<const B*>(a.b1);
  cudaError_t err;

  // 1. dgrad
  const size_t smem = conv_smem_bytes(C);
  auto dgrad = stage1_dgrad_kernel<C, kHalo>;
  if ((err = cudaFuncSetAttribute(dgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  const long long tiles = (long long)n * ((h + kConvRows - 1) / kConvRows) *
                          ((w + kConvCols - 1) / kConvCols);
  int grid = dparts;  // halo mode: as many blocks as db1 partials
  if (!kHalo &&
      (err = persistent_grid(dgrad, kThreads, smem, tiles, &grid)) != cudaSuccess)
    return err;
  if (grid < 1) return cudaErrorInvalidValue;
  dgrad<<<grid, kThreads, smem, stream>>>(a.P, zb, b1, static_cast<const B*>(a.wt),
                                          static_cast<B*>(a.dz1),
                                          static_cast<float*>(a.db1_part), n, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. wgrad + db2 partials
  const size_t wsmem = Wgrad<C>::kSmem;
  auto wgrad = stage1_wgrad_kernel<C, kHalo>;
  if ((err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)wsmem)) != cudaSuccess)
    return err;
  wgrad<<<dim3(parts, 3), Wgrad<C>::kThreads, wsmem, stream>>>(
      a.P, zb, static_cast<const B*>(a.ztop), static_cast<const B*>(a.zbot), b1,
      static_cast<float*>(a.dk_part), static_cast<float*>(a.db_part), n, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 3. fixed-order sum
  const int total = 9 * C * C + (kHalo ? 2 : 1) * C;
  stage1_wgrad_sum_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(a.dk_part), static_cast<const float*>(a.db_part),
      static_cast<const float*>(a.db1_part), static_cast<float*>(a.dk2),
      static_cast<float*>(a.db2), kHalo ? static_cast<float*>(a.db1) : nullptr, parts,
      dparts, C);
  return cudaGetLastError();
}

template <bool kHalo>
int dispatch_bwd(const BwdArgs& a, int parts, int dparts, int n, int h, int w, int c,
                 cudaStream_t s) {
  if (parts < 1 || n < 1) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 16: return (int)launch_bwd<16, kHalo>(a, parts, dparts, n, h, w, s);
    case 32: return (int)launch_bwd<32, kHalo>(a, parts, dparts, n, h, w, s);
    case 48: return (int)launch_bwd<48, kHalo>(a, parts, dparts, n, h, w, s);
    case 64: return (int)launch_bwd<64, kHalo>(a, parts, dparts, n, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of wgrad partials (blocks per tap row) for this shape: the
// caller allocates dk_part [parts][9*C*C] and db_part [parts][C] f32 and
// passes the same number to seg_stage1_tail_bwd. Returns parts > 0, or the
// negated cudaError_t.
extern "C" int seg_stage1_bwd_parts(int n, int h, int w, int c) {
  int parts = 0;
  cudaError_t err;
  switch (c) {
    case 16: err = wgrad_parts<16>(n, h, w, &parts); break;
    case 32: err = wgrad_parts<32>(n, h, w, &parts); break;
    case 48: err = wgrad_parts<48>(n, h, w, &parts); break;
    case 64: err = wgrad_parts<64>(n, h, w, &parts); break;
    default: err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? parts : -(int)err;
}

// The number of db1 partials of the halo-mode backward (the dgrad launch's
// blocks): the caller allocates db1_part [dparts][C] f32 and passes the same
// number to seg_stage1_tail_bwd_halo. Returns dparts > 0, or the negated
// cudaError_t.
extern "C" int seg_stage1_bwd_dgrad_parts(int n, int h, int w, int c) {
  int parts = 0;
  cudaError_t err;
  switch (c) {
    case 16: err = dgrad_parts<16>(n, h, w, &parts); break;
    case 32: err = dgrad_parts<32>(n, h, w, &parts); break;
    case 48: err = dgrad_parts<48>(n, h, w, &parts); break;
    case 64: err = dgrad_parts<64>(n, h, w, &parts); break;
    default: err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? parts : -(int)err;
}

// C entry. Device pointers: g, out, codes [N][H/2][W/2][C] (bf16, bf16, u8),
// z1 [N][H][W][C] bf16 (pre-relu, b1 added), wt = the flipped, transposed
// conv kernel [Cin][3][3][Cout] bf16 (wt[ci][dy][dx][co] = k2[co][ci][2-dy][2-dx]),
// all 16-byte aligned; outputs dz1 [N][H][W][C] bf16, dk2 [Cout][3][3][Cin]
// f32, db2 [C] f32; scratch dk_part, db_part as seg_stage1_bwd_parts says.
// C must be 16, 32, 48 or 64; H, W even; N >= 1. Returns a cudaError_t.
extern "C" int seg_stage1_tail_bwd(const void* g, const void* out, const void* codes,
                                   const void* z1, const void* wt, void* dz1,
                                   void* dk_part, void* db_part, int parts, void* dk2,
                                   void* db2, int n, int h, int w, int c,
                                   void* stream) {
  const Pooled P{static_cast<const __nv_bfloat16*>(g),
                 static_cast<const __nv_bfloat16*>(out),
                 static_cast<const uint8_t*>(codes)};
  return dispatch_bwd<false>({P, z1, nullptr, nullptr, nullptr, wt, dz1, dk_part,
                              db_part, nullptr, dk2, db2, nullptr},
                             parts, 0, n, h, w, c, static_cast<cudaStream_t>(stream));
}

// Halo mode (kernel 1c): as seg_stage1_tail_bwd, with z1 WITHOUT b1, b1 [C]
// bf16, the halo rows of the pooled tensors gt/ot/ct (above) and gb/ob/cb
// (below) [N][1][W/2][C] (zero at the image's edge) and of z1, ztop and zbot
// [N][1][W][C] (pre-bias, -inf at the edge); one more output, db1 [C] f32,
// with its scratch db1_part [dparts][C] (seg_stage1_bwd_dgrad_parts). All
// 16-byte aligned.
extern "C" int seg_stage1_tail_bwd_halo(
    const void* g, const void* out, const void* codes, const void* gt, const void* ot,
    const void* ct, const void* gb, const void* ob, const void* cb, const void* z1,
    const void* ztop, const void* zbot, const void* b1, const void* wt, void* dz1,
    void* dk_part, void* db_part, void* db1_part, int parts, int dparts, void* dk2,
    void* db2, void* db1, int n, int h, int w, int c, void* stream) {
  using B = __nv_bfloat16;
  const Pooled P{static_cast<const B*>(g),  static_cast<const B*>(out),
                 static_cast<const uint8_t*>(codes),
                 static_cast<const B*>(gt), static_cast<const B*>(ot),
                 static_cast<const uint8_t*>(ct),
                 static_cast<const B*>(gb), static_cast<const B*>(ob),
                 static_cast<const uint8_t*>(cb)};
  return dispatch_bwd<true>({P, z1, ztop, zbot, b1, wt, dz1, dk_part, db_part,
                             db1_part, dk2, db2, db1},
                            parts, dparts, n, h, w, c,
                            static_cast<cudaStream_t>(stream));
}
