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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_mma.cuh"

namespace {

using namespace stage1;

// dz2 for one conv pixel (y, x) inside the image and 8 channels from ch8:
// the pooled gradient where the code selects this pixel and out > 0
__device__ __forceinline__ uint4 routed_grad(const __nv_bfloat16* __restrict__ g,
                                             const __nv_bfloat16* __restrict__ out,
                                             const uint8_t* __restrict__ codes,
                                             int n, int y, int x, int Ho, int Wo,
                                             int C, int ch8) {
  const size_t o = (((size_t)n * Ho + (y >> 1)) * Wo + (x >> 1)) * C + ch8;
  const uint4 gv = *reinterpret_cast<const uint4*>(g + o);
  const uint4 ov = *reinterpret_cast<const uint4*>(out + o);
  const uint2 cv = *reinterpret_cast<const uint2*>(codes + o);
  const uint32_t sel = 2u * (y & 1) + (x & 1);
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

// ---------------------------------------------------------------------------
// 1. dgrad
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stage1_dgrad_kernel(const __nv_bfloat16* __restrict__ g,     // [N][H/2][W/2][C]
                    const __nv_bfloat16* __restrict__ out,   // [N][H/2][W/2][C]
                    const uint8_t* __restrict__ codes,       // [N][H/2][W/2][C]
                    const __nv_bfloat16* __restrict__ z1,    // [N][H][W][C]
                    const __nv_bfloat16* __restrict__ wt,    // [Cin][3][3][Cout]
                    __nv_bfloat16* __restrict__ dz1,         // [N][H][W][C]
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
      if (y >= 0 && y < H && x >= 0 && x < W)
        v = routed_grad(g, out, codes, n, y, x, Ho, Wo, C, ch * 8);
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
          const float2 z = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(z1 + o));
          const float d0 = z.x > 0.f ? acc[m][j][2 * half] : 0.f;
          const float d1 = z.y > 0.f ? acc[m][j][2 * half + 1] : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(dz1 + o) = __floats2bfloat162_rn(d0, d1);
        }
      }
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

template <int C>
__global__ void __launch_bounds__(Wgrad<C>::kThreads)
stage1_wgrad_kernel(const __nv_bfloat16* __restrict__ g,
                    const __nv_bfloat16* __restrict__ out,
                    const uint8_t* __restrict__ codes,
                    const __nv_bfloat16* __restrict__ z1,
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
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);

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
        v = routed_grad(g, out, codes, n, y, x, Ho, Wo, C, ch * 8);
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
      if (y >= 0 && y < H && x >= 0 && x < W) {
        v = *reinterpret_cast<const uint4*>(
            z1 + (((size_t)n * H + y) * W + x) * C + ch * 8);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) h[k] = __hmax2(h[k], zero2);
      }
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
                                        float* __restrict__ dk2,  // [C][3][3][C]
                                        float* __restrict__ db2, int parts, int C) {
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
  }
}

template <int C>
long long wgrad_tiles(int n, int h, int w) {
  return (long long)n * ((h + kWRows - 1) / kWRows) * ((w + kWCols - 1) / kWCols);
}

template <int C>
cudaError_t wgrad_parts(int n, int h, int w, int* parts) {
  const size_t smem = Wgrad<C>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      stage1_wgrad_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = wgrad_tiles<C>(n, h, w);
  int grid = 0;
  // the three tap rows share the card: a third of the resident blocks each
  if ((err = persistent_grid(stage1_wgrad_kernel<C>, Wgrad<C>::kThreads, smem,
                             tiles * 3, &grid)) != cudaSuccess)
    return err;
  grid /= 3;
  *parts = (int)(grid < 1 ? 1 : (tiles < grid ? tiles : grid));
  return cudaSuccess;
}

template <int C>
cudaError_t launch_bwd(const void* g, const void* out, const void* codes,
                       const void* z1, const void* wt, void* dz1, void* dk_part,
                       void* db_part, int parts, void* dk2, void* db2, int n, int h,
                       int w, cudaStream_t stream) {
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* ob = static_cast<const __nv_bfloat16*>(out);
  const auto* cb = static_cast<const uint8_t*>(codes);
  const auto* zb = static_cast<const __nv_bfloat16*>(z1);
  cudaError_t err;

  // 1. dgrad
  const size_t smem = conv_smem_bytes(C);
  if ((err = cudaFuncSetAttribute(stage1_dgrad_kernel<C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  const long long tiles = (long long)n * ((h + kConvRows - 1) / kConvRows) *
                          ((w + kConvCols - 1) / kConvCols);
  int grid = 0;
  if ((err = persistent_grid(stage1_dgrad_kernel<C>, kThreads, smem, tiles, &grid)) !=
      cudaSuccess)
    return err;
  stage1_dgrad_kernel<C><<<grid, kThreads, smem, stream>>>(
      gb, ob, cb, zb, static_cast<const __nv_bfloat16*>(wt),
      static_cast<__nv_bfloat16*>(dz1), n, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. wgrad + db2 partials
  const size_t wsmem = Wgrad<C>::kSmem;
  if ((err = cudaFuncSetAttribute(stage1_wgrad_kernel<C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)wsmem)) != cudaSuccess)
    return err;
  stage1_wgrad_kernel<C><<<dim3(parts, 3), Wgrad<C>::kThreads, wsmem, stream>>>(
      gb, ob, cb, zb, static_cast<float*>(dk_part), static_cast<float*>(db_part), n,
      h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 3. fixed-order sum
  const int total = 9 * C * C + C;
  stage1_wgrad_sum_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(db_part),
      static_cast<float*>(dk2), static_cast<float*>(db2), parts, C);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts < 1 || n < 1) return (int)cudaErrorInvalidValue;
#define SEG_BWD(CC)                                                                \
  case CC:                                                                         \
    return (int)launch_bwd<CC>(g, out, codes, z1, wt, dz1, dk_part, db_part, parts, \
                               dk2, db2, n, h, w, s)
  switch (c) {
    SEG_BWD(16);
    SEG_BWD(32);
    SEG_BWD(48);
    SEG_BWD(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEG_BWD
}
