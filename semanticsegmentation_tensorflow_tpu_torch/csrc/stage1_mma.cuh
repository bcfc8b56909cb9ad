// Shared pieces of the stage1 kernels (stage1_tail.cu forward, stage1_bwd.cu
// backward): bf16 mma.sync m16n8k16 fragments fed by ldmatrix, the weight
// staging, and the 3x3 SAME implicit-GEMM main loop over one tile of
// 4 conv rows x 32 conv columns staged in shared memory.
//
// Layouts. The weights are staged as ws[tap][cout][RS] (tap = 3*dy + dx,
// RS = C + 8 bf16 per row) from a [Cout][3][3][Cin] tensor; the input tile as
// tile[(kTileRows x kTileCols) pixels][RS], tile row 0 / column 0 being the
// halo row / column above / left of the tile. The 8 padding channels per row
// put the 8 row addresses of every ldmatrix in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stage1 {

constexpr int kPoolRows = 2;                 // pooled rows per tile
constexpr int kPoolCols = 16;                // pooled columns per tile
constexpr int kConvRows = 2 * kPoolRows;     // conv rows per tile
constexpr int kConvCols = 2 * kPoolCols;     // conv columns per tile
constexpr int kTileRows = kConvRows + 2;     // + 1-row halo each side
constexpr int kTileCols = kConvCols + 2;     // + 1-col halo each side
constexpr int kThreads = 256;                // 8 warps
constexpr int kPad = 8;                      // bf16 padding per smem row
constexpr int kBlocksPerSm = 2;

__host__ __device__ constexpr int row_stride(int c) { return c + kPad; }

__host__ __device__ constexpr size_t weight_elems(int c) {
  return (size_t)9 * c * row_stride(c);
}

// weights + one input tile
__host__ __device__ constexpr size_t conv_smem_bytes(int c) {
  return (weight_elems(c) + (size_t)kTileRows * kTileCols * row_stride(c)) *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

// transposed loads: each 8x8 matrix is stored with its rows along K (the
// addressed rows) and delivered as the fragment of its transpose
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row-major) * b (16x8, col-major); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// [Cout][3][3][Cin] weights -> ws[9][Cout][RS], once per block
template <int C>
__device__ __forceinline__ void stage_weights(__nv_bfloat16* ws,
                                              const __nv_bfloat16* __restrict__ w) {
  constexpr int RS = row_stride(C);
  constexpr int CH = C / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 9 * C * CH; i += blockDim.x) {
    const int ch = i % CH, row = i / CH;  // row = cout * 9 + tap
    const int cout = row / 9, tap = row % 9;
    *reinterpret_cast<uint4*>(ws + (tap * C + cout) * RS + ch * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t)row * C + ch * 8);
  }
}

// The 3x3 SAME conv of one staged tile, 8 warps of kThreads:
// warp w owns conv rows 2*pr and 2*pr + 1 (pr = w & 1), conv columns
// cs..cs+15 (cs = 16*((w >> 1) & 1)) and output channels nbase..nbase+C/2
// (nbase = C/2*(w >> 2)). acc[m][j] is the m16n8 fragment of conv row
// 2*pr + m and channels nbase + 8j..+8: the thread holds conv columns
// cs + g (q = 0, 1) and cs + g + 8 (q = 2, 3), g = lane / 4, channels
// nbase + 8j + 2*(lane % 4) + {0, 1}.
template <int C>
__device__ __forceinline__ void conv_tile(const __nv_bfloat16* tile,
                                          const __nv_bfloat16* ws,
                                          float (&acc)[2][C / 16][4], int pr,
                                          int cs, int nbase, int lane) {
  constexpr int RS = row_stride(C);
  constexpr int NB = C / 16;  // n8 fragments per warp (C/2 channels)
  constexpr int KS = C / 16;  // k16 steps per tap
  // ldmatrix row addresses of this lane
  const int a_pix = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const __nv_bfloat16* wt = ws + (dy * 3 + dx) * C * RS;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)  // conv row 2*pr + m reads tile row +dy
          ldsm_x4(a[m], tile + ((2 * pr + m + dy) * kTileCols + cs + dx + a_pix) * RS +
                            ks * 16 + a_k);
#pragma unroll
        for (int j = 0; j + 1 < NB; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, wt + (nbase + j * 8 + b_n) * RS + ks * 16 + b_k);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][j], a[m], b[0], b[1]);
            mma_bf16(acc[m][j + 1], a[m], b[2], b[3]);
          }
        }
        if constexpr (NB % 2) {
          uint32_t b0, b1;
          ldsm_x2(b0, b1, wt + (nbase + (NB - 1) * 8 + (lane & 7)) * RS +
                              ks * 16 + b_k);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_bf16(acc[m][NB - 1], a[m], b0, b1);
        }
      }
    }
  }
}

// Persistent grid: as many blocks as fit on the card at once (at most one
// per tile); each walks tiles blockIdx.x, +gridDim.x, ...
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   long long tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
    return err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = (int)(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

}  // namespace stage1
