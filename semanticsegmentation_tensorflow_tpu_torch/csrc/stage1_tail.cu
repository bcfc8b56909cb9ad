// VGG stage1 tail, forward: relu -> 3x3 SAME conv -> 2x2/2 max pool -> +b2 -> relu.
//
// Replaces: semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:_fwd_kernel
// (FCN mode, single device, b1 already added to z1 by the caller).
//
// Contract (per image n, pooled pixel (oy, ox), channel c):
//   y      = relu(z1)                     zero outside the image (SAME pad)
//   conv   = sum_{dy,dx,ci} y[2oy+py+dy-1, 2ox+px+dx-1, ci] * k2[c,ci,dy,dx]
//            accumulated in f32, then rounded to bf16      (stage1.py:231)
//   m      = max over the 2x2 window (py, px) of those bf16 values
//   out    = relu(bf16(m + b2[c]))                           (stage1.py:259)
// The halo is zero AFTER the relu: out-of-image pixels contribute 0, never
// relu(b1) (stage1.py:203-216). The routing codes the TPU kernel also writes
// serve only its backward and are not produced here.
//
// What bounds it on the H100: the math. At the main-path shape
// (1x384x1248x64) the conv is 17.7 G multiply-adds, 35.3 GFLOP, against
// ~61 MB read and ~15 MB written (~465 FLOP/byte, above the bf16 ridge of
// ~295): ~36 us at the dense bf16 peak (989 TFLOP/s) against ~23 us for the
// bytes at 3.35 TB/s. The plain PyTorch version also moves far more bytes:
// it writes the full-resolution conv output (61 MB) and reads it back for the
// pool, then again for the bias and relu.
//
// Design: an implicit GEMM (M = conv pixels, N = C, K = 9*C) on bf16
// mma.sync m16n8k16 with f32 accumulators, operands fed by ldmatrix.
//  * Persistent blocks, two per SM: each stages the whole 3x3xCxC weight
//    tensor in shared memory once, then walks output tiles of 2 pooled rows
//    x 16 pooled columns (4 x 32 conv pixels).
//  * Per tile the relu'd (4+2) x (32+2) x C input window, halo zero-filled,
//    is staged in shared memory and read by all nine taps. Pixel and weight
//    rows are padded by 8 channels (144 B for C=64), so the 8 row addresses
//    of every ldmatrix fall in distinct banks.
//  * Warp w owns pooled row (w & 1), conv columns 16*((w >> 1) & 1)..+16 and
//    output channels C/2*(w >> 2)..+C/2: two 16-pixel M fragments (the two
//    conv rows of one pooled row) by C/16 n8 fragments.
//  * Epilogue in registers: the two conv rows sit in one thread (vertical
//    max), horizontal neighbours are 4 lanes apart (one shuffle); then the
//    bf16 bias add, relu and a 4-byte store. The full-resolution conv output
//    never leaves the registers.
// Loads are synchronous (the second block on the SM hides them). Since the
// math bounds it, the next step is wgmma (Hopper's warpgroup MMA; mma.sync
// does not reach the dense peak on sm_90), with TMA feeding it; both are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoolRows = 2;                 // pooled rows per tile
constexpr int kPoolCols = 16;                // pooled columns per tile
constexpr int kTileRows = 2 * kPoolRows + 2; // conv rows + 1-row halo each side
constexpr int kTileCols = 2 * kPoolCols + 2; // conv cols + 1-col halo each side
constexpr int kThreads = 256;                // 8 warps
constexpr int kPad = 8;                      // bf16 padding per smem row
constexpr int kBlocksPerSm = 2;

__host__ __device__ constexpr int row_stride(int c) { return c + kPad; }

__host__ __device__ constexpr size_t weight_elems(int c) {
  return (size_t)9 * c * row_stride(c);
}

__host__ __device__ constexpr size_t smem_bytes(int c) {
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

template <int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stage1_tail_kernel(const __nv_bfloat16* __restrict__ z1,  // [N][H][W][C]
                   const __nv_bfloat16* __restrict__ w,   // [Cout][3][3][Cin]
                   const __nv_bfloat16* __restrict__ b2,  // [C]
                   __nv_bfloat16* __restrict__ out,       // [N][H/2][W/2][C]
                   int n_img, int H, int W) {
  constexpr int RS = row_stride(C);
  constexpr int NB = C / 16;          // n8 fragments per warp (C/2 channels)
  constexpr int KS = C / 16;          // k16 steps per tap
  constexpr int CH = C / 8;           // 16-byte chunks per pixel
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [9][C][RS]
  __nv_bfloat16* tile = ws + weight_elems(C);                  // [6][34][RS]

  // weights -> shared memory, once per block, [Cout][3][3][Cin] -> [9][Cout][RS]
  for (int i = threadIdx.x; i < 9 * C * CH; i += kThreads) {
    const int ch = i % CH, row = i / CH;  // row = cout * 9 + tap
    const int cout = row / 9, tap = row % 9;
    *reinterpret_cast<uint4*>(ws + (tap * C + cout) * RS + ch * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t)row * C + ch * 8);
  }

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + kPoolCols - 1) / kPoolCols;
  const int tiles_y = (Ho + kPoolRows - 1) / kPoolRows;
  const int n_tiles = n_img * tiles_y * tiles_x;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pr = warp & 1;                 // pooled row within the tile
  const int cs = ((warp >> 1) & 1) * 16;   // first conv column of the warp
  const int nbase = (warp >> 2) * (C / 2); // first output channel of the warp
  // ldmatrix row addresses of this lane
  const int a_pix = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
    const int n = t / (tiles_x * tiles_y);
    const int pr0 = ty * kPoolRows, pc0 = tx * kPoolCols;
    const int r0 = 2 * pr0, c0 = 2 * pc0;

    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kTileRows * kTileCols * CH; i += kThreads) {
      const int ch = i % CH, p = i / CH;
      const int tc = p % kTileCols, tr = p / kTileCols;
      const int y = r0 - 1 + tr, x = c0 - 1 + tc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (y >= 0 && y < H && x >= 0 && x < W) {
        v = *reinterpret_cast<const uint4*>(
            z1 + (((size_t)n * H + y) * W + x) * C + ch * 8);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) h[k] = __hmax2(h[k], zero2);
      }
      *reinterpret_cast<uint4*>(tile + p * RS + ch * 8) = v;
    }
    __syncthreads();

    float acc[2][NB][4];
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

    // epilogue: thread holds conv pixels g and g+8 (g = lane/4) of both conv
    // rows, channels nbase + 8j + 2*(lane%4) + {0,1}
    const int g = lane >> 2;
    const int oy = pr0 + pr;
    const int ox = pc0 + (cs + g) / 2;       // pooled column of pixel g (g even)
    const bool store = !(g & 1) && oy < Ho;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = nbase + j * 8 + 2 * (lane & 3);
      const float bias0 = __bfloat162float(b2[c]);
      const float bias1 = __bfloat162float(b2[c + 1]);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = fmaxf(round_bf16(acc[0][j][q]), round_bf16(acc[1][j][q]));
        v[q] = fmaxf(v[q], __shfl_xor_sync(0xffffffffu, v[q], 4));
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // pixels g, g+8 -> ox, ox+4
        const int col = ox + 4 * half;
        if (store && col < Wo) {
          const float s0 = fmaxf(round_bf16(__fadd_rn(v[2 * half], bias0)), 0.f);
          const float s1 = fmaxf(round_bf16(__fadd_rn(v[2 * half + 1], bias1)), 0.f);
          *reinterpret_cast<__nv_bfloat162*>(
              out + (((size_t)n * Ho + oy) * Wo + col) * C + c) =
              __floats2bfloat162_rn(s0, s1);
        }
      }
    }
  }
}

template <int C>
cudaError_t launch(const void* z1, const void* w, const void* b2, void* out,
                   int n, int h, int w_, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      stage1_tail_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, stage1_tail_kernel<C>, kThreads, smem)) != cudaSuccess)
    return err;
  const long long tiles = (long long)n * ((h / 2 + kPoolRows - 1) / kPoolRows) *
                          ((w_ / 2 + kPoolCols - 1) / kPoolCols);
  if (tiles == 0) return cudaSuccess;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = (int)(tiles < resident ? tiles : resident);
  stage1_tail_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(z1), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out),
      n, h, w_);
  return cudaGetLastError();
}

}  // namespace

// C entry. Pointers are device pointers (z1, w and out 16-byte aligned); `w`
// is the conv kernel as [Cout][3][3][Cin] bf16, the memory of an OIHW tensor
// in torch.channels_last; `stream` is a cudaStream_t.
// C must be 16, 32, 48 or 64. Returns a cudaError_t (0 on success).
extern "C" int seg_stage1_tail(const void* z1, const void* w, const void* b2,
                               void* out, int n, int h, int w_, int c,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 16: return (int)launch<16>(z1, w, b2, out, n, h, w_, s);
    case 32: return (int)launch<32>(z1, w, b2, out, n, h, w_, s);
    case 48: return (int)launch<48>(z1, w, b2, out, n, h, w_, s);
    case 64: return (int)launch<64>(z1, w, b2, out, n, h, w_, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
