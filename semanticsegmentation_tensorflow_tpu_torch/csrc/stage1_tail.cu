// VGG stage1 tail, forward: relu -> 3x3 SAME conv -> 2x2/2 max pool -> +b2 -> relu,
// and in training also the 2-bit routing codes of the pool; in SegNet mode
// relu -> conv -> +b2 -> relu -> 2x2/2 argmax pool.
//
// Replaces: semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:_fwd_kernel
// (single device, b1 already added to z1 by the caller): its FCN mode with
// the `codes` output, and its SegNet mode (`biased_codes=True`, :235-260, the
// forward of fused_segnet_stage1_tail :799).
//
// Contract (per image n, pooled pixel (oy, ox), channel c):
//   y      = relu(z1)                     zero outside the image (SAME pad)
//   conv   = sum_{dy,dx,ci} y[2oy+py+dy-1, 2ox+px+dx-1, ci] * k2[c,ci,dy,dx]
//            accumulated in f32, then rounded to bf16      (stage1.py:231)
//   m      = max over the 2x2 window (py, px) of those bf16 values
//   out    = relu(bf16(m + b2[c]))                           (stage1.py:259)
//   codes  = 2*py + px of the FIRST window element equal to m, in (py, px)
//            row-major order, on the bf16 values              (stage1.py:252-257)
// The halo is zero AFTER the relu: out-of-image pixels contribute 0, never
// relu(b1) (stage1.py:203-216). The inference launch (codes == nullptr)
// writes no codes.
// SegNet mode (the bias and relu come BEFORE the pool, because the decoder
// unpools by the index and relu reorders negatives):
//   s      = relu(bf16(bf16(conv) + b2[c])) for each of the four window values
//   out    = max over the window of s               (no second bias add)
//   codes  = 2*py + px of the FIRST s equal to out, in row-major order
// so an all-nonpositive window (all s = 0) gets code 0 (stage1.py:235-260).
//
// What bounds it on the H100: the math. At the inference shape
// (1x384x1248x64) the conv is 17.7 G multiply-adds, 35.3 GFLOP, against
// ~61 MB read and ~15 MB written (~465 FLOP/byte, above the bf16 ridge of
// ~295): ~36 us at the dense bf16 peak (989 TFLOP/s) against ~23 us for the
// bytes at 3.35 TB/s. The codes add 1/4 of the output's bytes. The plain
// PyTorch version also moves far more bytes: it writes the full-resolution
// conv output (61 MB) and reads it back for the pool, then again for the
// bias and relu.
//
// Design: an implicit GEMM (M = conv pixels, N = C, K = 9*C) on bf16
// mma.sync m16n8k16 with f32 accumulators, operands fed by ldmatrix
// (stage1_mma.cuh).
//  * Persistent blocks, two per SM: each stages the whole 3x3xCxC weight
//    tensor in shared memory once, then walks output tiles of 2 pooled rows
//    x 16 pooled columns (4 x 32 conv pixels).
//  * Per tile the relu'd (4+2) x (32+2) x C input window, halo zero-filled,
//    is staged in shared memory and read by all nine taps.
//  * Epilogue in registers: the two conv rows of a pooled row sit in one
//    thread, horizontal neighbours are 4 lanes apart (one shuffle each);
//    then the bf16 bias add, relu and a 4-byte store (and a 2-byte store of
//    two codes). The full-resolution conv output never leaves the registers.
// Loads are synchronous (the second block on the SM hides them). Since the
// math bounds it, the next step is wgmma (Hopper's warpgroup MMA; mma.sync
// does not reach the dense peak on sm_90), with TMA feeding it; both are
// later work.
//
// Halo mode (kernel 1c; replaces the same _fwd_kernel with spmd=True, reached
// through _fwd_cp :636, fused_stage1_tail(..., spmd=True) :679 and
// fused_segnet_stage1_tail(..., spmd=True) :799): the image's rows are split
// across ranks, z1 holds this rank's rows WITHOUT the conv1_1 bias b1, and
// `top` / `bot` [N][1][W][C] are the pre-bias conv1_1 rows just above and
// below them (a neighbour's boundary row, or -inf at the image's edge). Every
// loaded value becomes relu(bf16(z + b1)) (stage1.py:213), so an -inf row
// relus to an exact 0, the SAME padding. Rows -1 and H come from top and bot
// instead of zero fill; the rest is the same kernel. The TPU kernel's
// per-block halo arrays (stage1.py:457-475) come from its VMEM blocking: a
// block here reads its neighbours inside the shard directly and needs
// halo rows only at the shard's edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_mma.cuh"

namespace {

using namespace stage1;

enum Mode { kInfer, kCodes, kSegNet };

// Halo mode: the z1 row y of image n, y = -1 and y = H from the halo rows,
// or nullptr where the SAME padding is zero (outside the columns).
template <int C>
__device__ __forceinline__ const __nv_bfloat16* halo_row(
    const __nv_bfloat16* __restrict__ z1, const __nv_bfloat16* __restrict__ top,
    const __nv_bfloat16* __restrict__ bot, int n, int y, int x, int H, int W) {
  if (x < 0 || x >= W || y < -1 || y > H) return nullptr;
  if (y == -1) return top + ((size_t)n * W + x) * C;
  if (y == H) return bot + ((size_t)n * W + x) * C;
  return z1 + (((size_t)n * H + y) * W + x) * C;
}

// Halo mode: relu(bf16(z + b1)) of 8 values, by a packed bf16 add (one
// rounding), which for two bf16 operands equals PyTorch's f32 add rounded
// to bf16 (an f32 sum of two bf16 values never sits on a bf16 rounding
// midpoint that the exact sum does not)
__device__ __forceinline__ uint4 halo_relu8(uint4 v, const __nv_bfloat16* __restrict__ b1) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  const uint4 bv = *reinterpret_cast<const uint4*>(b1);
  const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&bv);
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __hmax2(__hadd2(h[k], bh[k]), zero2);
  return v;
}

template <int C, int kMode, bool kHalo>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stage1_tail_kernel(const __nv_bfloat16* __restrict__ z1,  // [N][H][W][C]
                   const __nv_bfloat16* __restrict__ top, // [N][1][W][C] halo mode
                   const __nv_bfloat16* __restrict__ bot, // [N][1][W][C] halo mode
                   const __nv_bfloat16* __restrict__ w,   // [Cout][3][3][Cin]
                   const __nv_bfloat16* __restrict__ b2,  // [C]
                   const __nv_bfloat16* __restrict__ b1,  // [C] halo mode
                   __nv_bfloat16* __restrict__ out,       // [N][H/2][W/2][C]
                   uint8_t* __restrict__ codes,           // [N][H/2][W/2][C]
                   int n_img, int H, int W) {
  constexpr int RS = row_stride(C);
  constexpr int NB = C / 16;          // n8 fragments per warp (C/2 channels)
  constexpr int CH = C / 8;           // 16-byte chunks per pixel
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [9][C][RS]
  __nv_bfloat16* tile = ws + weight_elems(C);                  // [6][34][RS]

  stage_weights<C>(ws, w);

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + kPoolCols - 1) / kPoolCols;
  const int tiles_y = (Ho + kPoolRows - 1) / kPoolRows;
  const int n_tiles = n_img * tiles_y * tiles_x;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pr = warp & 1;                 // pooled row within the tile
  const int cs = ((warp >> 1) & 1) * 16;   // first conv column of the warp
  const int nbase = (warp >> 2) * (C / 2); // first output channel of the warp
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
      if constexpr (kHalo) {
        const __nv_bfloat16* src = halo_row<C>(z1, top, bot, n, y, x, H, W);
        if (src) v = halo_relu8(*reinterpret_cast<const uint4*>(src + ch * 8), b1 + ch * 8);
      } else if (y >= 0 && y < H && x >= 0 && x < W) {
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
    conv_tile<C>(tile, ws, acc, pr, cs, nbase, lane);

    // epilogue: thread holds conv pixels g and g+8 (g = lane/4) of both conv
    // rows, channels nbase + 8j + 2*(lane%4) + {0,1}; the storing thread
    // (g even) holds window column 0, its neighbour g+1 (lane+4) column 1
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
      uint32_t code[4];
#pragma unroll
      // q: pixel g (q = 0, 1) or g+8 (q = 2, 3), channel c + (q & 1)
      for (int q = 0; q < 4; ++q) {
        float a0 = round_bf16(acc[0][j][q]);  // window (0, 0)
        float a2 = round_bf16(acc[1][j][q]);  // window (1, 0)
        if constexpr (kMode == kSegNet) {
          // bias and relu on every window value before the pool; the
          // neighbour (lane + 4) does the same for column 1, same channel
          const float bias = (q & 1) ? bias1 : bias0;
          a0 = fmaxf(round_bf16(__fadd_rn(a0, bias)), 0.f);
          a2 = fmaxf(round_bf16(__fadd_rn(a2, bias)), 0.f);
        }
        if constexpr (kMode != kInfer) {
          const float a1 = __shfl_xor_sync(0xffffffffu, a0, 4);  // (0, 1)
          const float a3 = __shfl_xor_sync(0xffffffffu, a2, 4);  // (1, 1)
          v[q] = fmaxf(fmaxf(a0, a1), fmaxf(a2, a3));
          // first maximum in row-major window order; a max taken pairwise
          // and then across columns would prefer (1, 0) over an equal (0, 1)
          code[q] = a0 == v[q] ? 0u : a1 == v[q] ? 1u : a2 == v[q] ? 2u : 3u;
        } else {
          v[q] = fmaxf(a0, a2);
          v[q] = fmaxf(v[q], __shfl_xor_sync(0xffffffffu, v[q], 4));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // pixels g, g+8 -> ox, ox+4
        const int col = ox + 4 * half;
        if (store && col < Wo) {
          const size_t o = (((size_t)n * Ho + oy) * Wo + col) * C + c;
          float s0 = v[2 * half], s1 = v[2 * half + 1];
          if constexpr (kMode != kSegNet) {
            s0 = fmaxf(round_bf16(__fadd_rn(s0, bias0)), 0.f);
            s1 = fmaxf(round_bf16(__fadd_rn(s1, bias1)), 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(s0, s1);
          if constexpr (kMode != kInfer)
            *reinterpret_cast<uint16_t*>(codes + o) =
                (uint16_t)(code[2 * half] | (code[2 * half + 1] << 8));
        }
      }
    }
  }
}

// the kernel's pointer arguments; top, bot and b1 are read in halo mode only
struct Args {
  const void *z1, *top, *bot, *w, *b2, *b1;
  void *out, *codes;
};

template <int C, int kMode, bool kHalo>
cudaError_t launch(const Args& a, int n, int h, int w_, cudaStream_t stream) {
  const size_t smem = conv_smem_bytes(C);
  auto kernel = stage1_tail_kernel<C, kMode, kHalo>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)n * ((h / 2 + kPoolRows - 1) / kPoolRows) *
                          ((w_ / 2 + kPoolCols - 1) / kPoolCols);
  if (tiles == 0) return cudaSuccess;
  int grid = 0;
  if ((err = persistent_grid(kernel, kThreads, smem, tiles, &grid)) != cudaSuccess)
    return err;
  using B = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const B*>(a.z1), static_cast<const B*>(a.top),
      static_cast<const B*>(a.bot), static_cast<const B*>(a.w),
      static_cast<const B*>(a.b2), static_cast<const B*>(a.b1),
      static_cast<B*>(a.out), static_cast<uint8_t*>(a.codes), n, h, w_);
  return cudaGetLastError();
}

template <int C, bool kHalo>
cudaError_t launch_c(const Args& a, int n, int h, int w_, bool segnet,
                     cudaStream_t s) {
  if (segnet) return launch<C, kSegNet, kHalo>(a, n, h, w_, s);
  return a.codes ? launch<C, kCodes, kHalo>(a, n, h, w_, s)
                 : launch<C, kInfer, kHalo>(a, n, h, w_, s);
}

template <bool kHalo>
cudaError_t dispatch(const Args& a, int n, int h, int w_, int c, bool segnet,
                     cudaStream_t s) {
  switch (c) {
    case 16: return launch_c<16, kHalo>(a, n, h, w_, segnet, s);
    case 32: return launch_c<32, kHalo>(a, n, h, w_, segnet, s);
    case 48: return launch_c<48, kHalo>(a, n, h, w_, segnet, s);
    case 64: return launch_c<64, kHalo>(a, n, h, w_, segnet, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry. Pointers are device pointers (z1, w and out 16-byte aligned); `w`
// is the conv kernel as [Cout][3][3][Cin] bf16, the memory of an OIHW tensor
// in torch.channels_last; `codes` is nullptr (inference) or a u8 tensor of
// out's shape (training); `stream` is a cudaStream_t.
// C must be 16, 32, 48 or 64. Returns a cudaError_t (0 on success).
extern "C" int seg_stage1_tail(const void* z1, const void* w, const void* b2,
                               void* out, void* codes, int n, int h, int w_, int c,
                               void* stream) {
  return (int)dispatch<false>({z1, nullptr, nullptr, w, b2, nullptr, out, codes}, n,
                              h, w_, c, false, static_cast<cudaStream_t>(stream));
}

// SegNet mode: the same arguments; `idx` (u8, out's shape) is required.
extern "C" int seg_stage1_tail_segnet(const void* z1, const void* w, const void* b2,
                                      void* out, void* idx, int n, int h, int w_,
                                      int c, void* stream) {
  if (idx == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch<false>({z1, nullptr, nullptr, w, b2, nullptr, out, idx}, n,
                              h, w_, c, true, static_cast<cudaStream_t>(stream));
}

// Halo mode (kernel 1c), FCN epilogue: z1 [N][H][W][C] WITHOUT b1, the halo
// rows top and bot [N][1][W][C] (pre-bias; -inf at the image's edge), b1 [C]
// bf16, all 16-byte aligned; the rest as seg_stage1_tail.
extern "C" int seg_stage1_tail_halo(const void* z1, const void* top, const void* bot,
                                    const void* w, const void* b2, const void* b1,
                                    void* out, void* codes, int n, int h, int w_,
                                    int c, void* stream) {
  return (int)dispatch<true>({z1, top, bot, w, b2, b1, out, codes}, n, h, w_, c,
                             false, static_cast<cudaStream_t>(stream));
}

// Halo mode, SegNet epilogue; `idx` is required.
extern "C" int seg_stage1_tail_halo_segnet(const void* z1, const void* top,
                                           const void* bot, const void* w,
                                           const void* b2, const void* b1, void* out,
                                           void* idx, int n, int h, int w_, int c,
                                           void* stream) {
  if (idx == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch<true>({z1, top, bot, w, b2, b1, out, idx}, n, h, w_, c, true,
                             static_cast<cudaStream_t>(stream));
}
