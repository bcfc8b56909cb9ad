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
// What bounds it on the H100: the math. At the training shape
// [8,320,1152,64] the conv is 108.7 G multiply-adds, 217.4 GFLOP (0.220 ms
// at the dense bf16 peak of 989 TFLOP/s), against 519.1 MB moved (z1 377.5
// MB and the weights 0.07 MB read, out 94.4 MB and codes 47.2 MB written;
// 0.155 ms at 3.35 TB/s).
// At the inference shape [1,384,1248,64] (no codes): 35.3 GFLOP (0.036 ms)
// against 76.7 MB (0.023 ms). The plain PyTorch version also writes the
// full-resolution conv output and reads it back for the pool, then again
// for the bias and relu.
//
// Design: an implicit GEMM (M = conv pixels, N = Cout, K = 9 taps x Cin)
// on wgmma m64n64k16 with f32 accumulators, fed by TMA. A persistent block
// of 384 threads (one per SM) walks tiles of 4 conv rows x 64 conv columns
// (2 pooled rows x 32 pooled columns).
//  * The z1 window of a tile, (4+2) x (64+2) pixels, comes by TMA, one 4-D
//    box of 66 pixels x 64 channels per row (128-byte swizzled rows, each
//    row padded to 1024 bytes), into a ring of two stages. Reads outside
//    the image (and channels past C) give NaN, which the relu by max.bf16x2
//    turns into the SAME padding's 0.
//  * Warpgroups 0 and 1 (consumers), one per pooled row: warpgroup wg owns
//    conv rows 2 wg and 2 wg + 1, two 64 x 64 accumulators. A = relu(z1)
//    [pixel][ci] comes into registers by ldmatrix at any pixel (the dx
//    shift, which no shared-memory descriptor can start at); the relu (and
//    b1 in halo mode) is applied there. Each A fragment of staged row
//    2 wg + tr feeds the products of both conv rows it is a tap row of
//    (dy = tr - oo in 0..2): 6 products per 4 ldmatrix.x4. B = the
//    weights, staged once per block from [Cout][3][3][Cin] with 16-byte
//    loads as K-major rows of co ([tap][co][64 ci], 128-byte swizzled rows;
//    73,728 bytes), in the row order that gives lane q of each accumulator
//    quad the 16 contiguous channels 16q..16q+15 of its pixel. C < 64 (test
//    widths) pads N with zero rows and runs C/16 k16 steps a tap.
//  * After its products a consumer rounds its two conv rows to bf16,
//    stores them to a staging buffer of its own ([row][pixel][64 co],
//    16 KB; two 16-byte stores a pixel from the permuted accumulators) and
//    goes on to its next tile, so the epilogue runs beside the next tile's
//    products.
//  * Warpgroup 2 (the epilogue warps) pools each 2x2 window there, takes
//    the first-max code, adds the bias and relus, all in packed bf16, and
//    stores out (16 bytes) and the codes (8) per 8 channels. One of its
//    threads issues the TMA loads: once both consumers have staged tile
//    it, neither reads its stage any more, which then takes tile it + 2.
//    It gives its registers to the consumers (setmaxnreg).
// The handoffs between consumers and epilogue warps are named barriers: a
// wait loop between the products and the reads of their accumulators makes
// the compiler serialize the products. The full-resolution conv output
// never leaves the SM. Shared memory: 1,024 alignment + 73,728 weights +
// 2 x 55,296 stages + 2 x 16,384 staging + barriers = 218,128 of the
// 232,448 bytes a block may use; a third stage does not fit.
//
// Halo mode (kernel 1c; replaces the same _fwd_kernel with spmd=True, reached
// through _fwd_cp :636, fused_stage1_tail(..., spmd=True) :679 and
// fused_segnet_stage1_tail(..., spmd=True) :799): the image's rows are split
// across ranks, z1 holds this rank's rows WITHOUT the conv1_1 bias b1, and
// `top` / `bot` [N][1][W][C] are the pre-bias conv1_1 rows just above and
// below them (a neighbour's boundary row, or -inf at the image's edge). Every
// A register becomes relu(bf16(z + b1)) (stage1.py:213) by a packed bf16 add
// (one rounding, which for two bf16 operands equals PyTorch's f32 add
// rounded to bf16) before the relu, so an -inf row, like the NaN fill,
// relus to an exact 0, the SAME padding. Rows -1 and H come by TMA from
// top's and bot's maps instead of the fill; the rest is the same kernel.
// The TPU kernel's per-block halo arrays (stage1.py:457-475) come from its
// VMEM blocking: a block here reads its neighbours inside the shard
// directly and needs halo rows only at the shard's edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "stage1_mma.cuh"

namespace {

using namespace stage1;

enum Mode { kInfer, kCodes, kSegNet };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf16x2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

constexpr int kRows = 4;                       // conv rows per tile (2 pooled rows)
constexpr int kCols = 64;                      // conv columns per tile: one m64 product
constexpr int kYRows = kRows + 2;              // z1 rows staged, halo incl.
constexpr int kYCols = kCols + 2;              // z1 columns staged, halo incl.
constexpr int kStages = 2;
constexpr int kConsumers = 256;                // warpgroups 0-1: pooled row wg
constexpr int kEpilogue = 128;                 // warpgroup 2: the epilogue and the TMA
constexpr int kThreads = kConsumers + kEpilogue;
constexpr int kWBytes = 9 * 64 * 128;          // weights [tap][co][64 ci], 128-byte rows
// z1 [row][pixel][64 ci]: each row one TMA box of kYCols pixels, padded to a
// 1024-byte boundary (the swizzle's period)
constexpr int kYRowBytes = (kYCols * 128 + 1023) / 1024 * 1024;
constexpr int kYBytes = kYRows * kYRowBytes;
// a consumer warpgroup's conv rows for the epilogue warps, bf16:
// [row][pixel][64 co], 128-byte swizzled rows
constexpr int kEBytes = 2 * kCols * 128;
constexpr size_t kSmem = 1024 + kWBytes + (size_t)kStages * kYBytes + 2 * kEBytes +
                         kStages * 8;
// named barriers between consumer warpgroup wg and the epilogue warps: its
// conv rows staged (kStaged + wg), and read (kRead + wg). Named barriers,
// not mbarriers: a wait loop between the products and the reads of their
// accumulators makes the compiler serialize the products
constexpr int kStaged = 1, kRead = 3, kStagingThreads = kConsumers / 2 + kEpilogue;
static_assert(kSmem <= 232448, "shared memory a block can use");
// registers a thread: at most 168 at launch (384 threads), then the
// epilogue warps give some of theirs to the consumers. setmaxnreg moves
// registers within the block's launch allocation: a larger sum never
// completes (the consumers' increase waits forever), so the launch refuses
// a build that allocates fewer than kMinLaunchRegs.
constexpr int kEpilogueRegs = 64, kConsumerRegs = 200;
constexpr int kMinLaunchRegs =
    (kEpilogue * kEpilogueRegs + kConsumers * kConsumerRegs + kThreads - 1) / kThreads;
static_assert(kMinLaunchRegs <= 168, "the block's registers");

// tz1 maps z1 [N][H][W][C], ttop / tbot the halo rows [N][1][W][C] (halo
// mode), each in boxes of one row of kYCols pixels x 64 channels
template <int C, int kMode, bool kHalo>
__global__ void __launch_bounds__(kThreads, 1)
stage1_tail_kernel(const __grid_constant__ CUtensorMap tz1,
                   const __grid_constant__ CUtensorMap ttop,
                   const __grid_constant__ CUtensorMap tbot,
                   const __nv_bfloat16* __restrict__ w,   // [Cout][3][3][Cin]
                   const __nv_bfloat16* __restrict__ b2,  // [C]
                   const __nv_bfloat16* __restrict__ b1,  // [C] halo mode
                   __nv_bfloat16* __restrict__ out,       // [N][H/2][W/2][C]
                   uint8_t* __restrict__ codes,           // [N][H/2][W/2][C]
                   int n_img, int H, int W) {
  constexpr int KS = C / 16;  // k16 steps per tap
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ws = smem;                                   // [9][64 co][128 B]
  unsigned char* ys = smem + kWBytes;                         // [stages][kYBytes]
  unsigned char* es = ys + kStages * kYBytes;                 // [consumer wg][kEBytes]
  const uint32_t full = hopper::smem_u32(es + 2 * kEBytes);  // per stage: the TMA landed

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (W + kCols - 1) / kCols;
  const int tiles_y = (H + kRows - 1) / kRows;
  const int n_tiles = n_img * tiles_y * tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the weights once per block, as the K-major B operand: row n of tap t
  // holds w[co][t][0..C) for co = 16 (n % 8 / 2) + 2 (n / 8) + n % 2, so
  // that accumulator column 8 j + 2 q + e is channel 16 q + 2 j + e; rows
  // co >= C and channels ci >= C zero
  for (int i = threadIdx.x; i < 9 * 64 * 8; i += kThreads) {
    const int ch = i % 8, nr = (i / 8) % 64, tap = i / (64 * 8);
    const int co = 16 * ((nr % 8) / 2) + 2 * (nr / 8) + nr % 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (co < C && ch < C / 8)
      v = *reinterpret_cast<const uint4*>(w + ((size_t)co * 9 + tap) * C + ch * 8);
    *reinterpret_cast<uint4*>(ws + tap * 8192 + hopper::sw128_offset(nr, ch)) = v;
  }
  hopper::fence_proxy_async();  // wgmma reads the weights
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(full + 8 * s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // warpgroup 2: the epilogue of each tile, and by one thread the TMA
    // loads of the z1 windows
    hopper::setmaxnreg_dec<kEpilogueRegs>();
    const int et = threadIdx.x - kConsumers;
    // tile it's z1 window into stage it % 2: rows r0-1 .. r0+4, columns
    // c0-1 .. c0+64 (NaN outside the image and past C; rows -1 and H from
    // the halo rows in halo mode)
    auto load = [&](int it) {
      const int t = blockIdx.x + it * gridDim.x;
      if (t >= n_tiles) return;
      const int s = it % kStages;
      const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
      const int n = t / (tiles_x * tiles_y);
      const int r0 = ty * kRows, c0 = tx * kCols;
      hopper::mbar_expect_tx(full + 8 * s, kYRows * kYCols * 128);
      const uint32_t y = hopper::smem_u32(ys + s * kYBytes);
      for (int tr = 0; tr < kYRows; ++tr) {
        const int yy = r0 - 1 + tr;
        const uint32_t dst = y + tr * kYRowBytes;
        if (kHalo && yy == -1) hopper::tma_load_4d(dst, &ttop, full + 8 * s, 0, c0 - 1, 0, n);
        else if (kHalo && yy == H) hopper::tma_load_4d(dst, &tbot, full + 8 * s, 0, c0 - 1, 0, n);
        else hopper::tma_load_4d(dst, &tz1, full + 8 * s, 0, c0 - 1, yy, n);
      }
    };
    if (et == 0) {
      load(0);
      load(1);
    }
    // per tile and consumer warpgroup wg (pooled row wg), each thread pools
    // the 2x2 windows of 8 channels (its 16-byte chunk ch) at pooled columns
    // et / 8 and et / 8 + 16, from the bf16 conv values: the window's
    // maximum and first-max code, the bias add and relu (SegNet: both
    // before the maximum). All in packed bf16: the bias adds round once
    // (PyTorch's f32 add rounded to bf16, as in halo mode), the maxima and
    // compares are exact. out goes as 16 bytes and the codes as 8 a window
    const int ch = et % 8;
    const bool live = 8 * ch < C;
    const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
    const __nv_bfloat162 one2 = __float2bfloat162_rn(1.f);
    const __nv_bfloat162 k128 = __float2bfloat162_rn(128.f);
    __nv_bfloat162 bias2[4];  // b2 of channels 8 ch + 2 k + {0, 1}
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bias2[k] = live ? *reinterpret_cast<const __nv_bfloat162*>(b2 + 8 * ch + 2 * k) : zero2;
    // both staging buffers start free
    hopper::bar_arrive(kRead, kStagingThreads);
    hopper::bar_arrive(kRead + 1, kStagingThreads);
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
      const int n = t / (tiles_x * tiles_y);
      const bool more = t + (int)gridDim.x < n_tiles;
#pragma unroll 1
      for (int wg = 0; wg < 2; ++wg) {
        hopper::bar_sync(kStaged + wg, kStagingThreads);
        // both consumers are past their last ldmatrix of tile it's stage:
        // it takes tile it + 2
        if (wg == 1 && et == 0) load(it + 2);
        const unsigned char* e = es + wg * kEBytes;
        const int oy = ty * (kRows / 2) + wg;
#pragma unroll
        for (int pc = et / 8; pc < kCols / 2; pc += kEpilogue / 8) {
          // window (py, px): row py, pixel 2 pc + px; 8 channels each
          uint4 v[4];
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4)
            v[w4] = *reinterpret_cast<const uint4*>(
                e + (w4 >> 1) * (kCols * 128) + hopper::sw128_offset(2 * pc + (w4 & 1), ch));
          uint32_t o[4], cw[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // channels 8 ch + 2 k + {0, 1}
            __nv_bfloat162 a[4];
#pragma unroll
            for (int w4 = 0; w4 < 4; ++w4) {
              a[w4] = bf16x2(reinterpret_cast<const uint32_t*>(&v[w4])[k]);
              if constexpr (kMode == kSegNet) a[w4] = __hmax2(__hadd2(a[w4], bias2[k]), zero2);
            }
            __nv_bfloat162 m = __hmax2(__hmax2(a[0], a[1]), __hmax2(a[2], a[3]));
            if constexpr (kMode != kInfer) {
              // the first maximum in row-major window order, n_i = (a_i !=
              // m): code = n0 (1 + n1 (1 + n2)), plus 128 so that the code
              // is the low byte of each bf16 (128..131 are exact); a max
              // taken pairwise and then across columns would prefer (1, 0)
              // over an equal (0, 1)
              const __nv_bfloat162 n1 = __hne2(a[1], m);
              const __nv_bfloat162 u = __hadd2(__hfma2(n1, __hne2(a[2], m), n1), one2);
              cw[k] = bits(__hfma2(__hne2(a[0], m), u, k128));
            }
            if constexpr (kMode != kSegNet) m = __hmax2(__hadd2(m, bias2[k]), zero2);
            o[k] = bits(m);
          }
          const int ox = tx * (kCols / 2) + pc;
          if (live && oy < Ho && ox < Wo) {
            const size_t off = (((size_t)n * Ho + oy) * Wo + ox) * C + 8 * ch;
            *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);
            if constexpr (kMode != kInfer)  // bytes 0 and 2 of each code pair
              *reinterpret_cast<uint2*>(codes + off) =
                  make_uint2(__byte_perm(cw[0], cw[1], 0x6420), __byte_perm(cw[2], cw[3], 0x6420));
          }
        }
        if (more) hopper::bar_arrive(kRead + wg, kStagingThreads);
      }
    }
    return;
  }

  // consumer warpgroup wg: conv rows r0 + 2 wg + oo (oo = 0, 1), 64 pixels
  // each (M), all Cout (N = 64), K = 9 taps x Cin. A = relu(z1) [pixel][ci]
  // from registers (ldmatrix at any pixel: the dx shift), B = the weights by
  // descriptor. Each A fragment of stage row 2 wg + tr feeds the products of
  // both rows it is a tap row of (dy = tr - oo in 0..2): 6 per 4 ldmatrix.
  // Its conv rows go to the epilogue warps as bf16, and the warpgroup goes
  // on to its next tile.
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3;
  const int q = lane & 3, gq = lane >> 2;
  // this lane's ldmatrix row: pixel 16 wl + (lane & 7) + 8 ((lane >> 3) & 1),
  // channel chunk + (lane >> 4) (matrices: rows +8, then k +8)
  const int apix = 16 * wl + (lane & 7) + 8 * ((lane >> 3) & 1), achunk = lane >> 4;
  const uint32_t wbase = hopper::smem_u32(ws);
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  // halo mode: b1 of A register i at k16 step ks, channels
  // 16 ks + 8 (i >> 1) + 2 q + {0, 1}
  __nv_bfloat162 bias1[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      bias1[ks][hh] = kHalo ? *reinterpret_cast<const __nv_bfloat162*>(b1 + 16 * ks + 8 * hh + 2 * q)
                            : zero2;
  unsigned char* e = es + wg * kEBytes;

  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it % kStages;
    float acc[2][32];
#pragma unroll
    for (int oo = 0; oo < 2; ++oo)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[oo][r] = 0.f;

    hopper::mbar_wait(full + 8 * s, (it / kStages) & 1);
    const unsigned char* st = ys + s * kYBytes;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4][4];
#pragma unroll
        for (int tr = 0; tr < 4; ++tr)
          ldsm_x4(a[tr], st + (2 * wg + tr) * kYRowBytes +
                             hopper::sw128_offset(apix + dx, 2 * ks + achunk));
#pragma unroll
        for (int tr = 0; tr < 4; ++tr)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            __nv_bfloat162 v = bf16x2(a[tr][i]);
            if constexpr (kHalo) v = __hadd2(v, bias1[ks][i >> 1]);
            a[tr][i] = bits(__hmax2(v, zero2));
          }
        hopper::wgmma_fence();
        // the two rows' products alternate
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int oo = 0; oo < 2; ++oo)
            hopper::wgmma_n64_rs(
                acc[oo], a[oo + dy], hopper::desc_sw128(wbase + (3 * dy + dx) * 8192 + ks * 32), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous step's A registers are free
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);

    // the conv rows to the epilogue warps, each value rounded to bf16:
    // register 4 j + 2 h + e of row oo holds pixel 16 wl + gq + 8 h,
    // channel 16 q + 2 j + e, so a thread stores 32 contiguous bytes of a
    // pixel per (row, h)
    uint32_t v[2][2][8];
#pragma unroll
    for (int oo = 0; oo < 2; ++oo)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[oo][h][j] =
              bits(__floats2bfloat162_rn(acc[oo][4 * j + 2 * h], acc[oo][4 * j + 2 * h + 1]));
    hopper::bar_sync(kRead + wg, kStagingThreads);  // the previous tile's are read
#pragma unroll
    for (int oo = 0; oo < 2; ++oo)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* row = e + oo * (kCols * 128);
        const int p = 16 * wl + gq + 8 * h;
        *reinterpret_cast<uint4*>(row + hopper::sw128_offset(p, 2 * q)) =
            make_uint4(v[oo][h][0], v[oo][h][1], v[oo][h][2], v[oo][h][3]);
        *reinterpret_cast<uint4*>(row + hopper::sw128_offset(p, 2 * q + 1)) =
            make_uint4(v[oo][h][4], v[oo][h][5], v[oo][h][6], v[oo][h][7]);
      }
    hopper::bar_arrive(kStaged + wg, kStagingThreads);
  }
}

// the kernel's pointer arguments; top, bot and b1 are read in halo mode only
struct Args {
  const void *z1, *top, *bot, *w, *b2, *b1;
  void *out, *codes;
};

template <int C, int kMode, bool kHalo>
cudaError_t launch(const Args& a, int n, int h, int w_, cudaStream_t stream) {
  auto kernel = stage1_tail_kernel<C, kMode, kHalo>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return err;
  if (fa.numRegs < kMinLaunchRegs) return cudaErrorInvalidConfiguration;  // would hang
  const long long tiles =
      (long long)n * ((h + kRows - 1) / kRows) * ((w_ + kCols - 1) / kCols);
  if (tiles == 0) return cudaSuccess;
  int grid = 0;
  if ((err = persistent_grid(kernel, kThreads, kSmem, tiles, &grid)) != cudaSuccess)
    return err;
  CUtensorMap tz1, ttop, tbot;
  const uint64_t st[3] = {(uint64_t)C, (uint64_t)w_ * C, (uint64_t)h * w_ * C};
  const uint64_t st_row[3] = {(uint64_t)C, (uint64_t)w_ * C, (uint64_t)w_ * C};
  if ((err = hopper::make_map_4d_nan(&tz1, a.z1, {(uint64_t)C, (uint64_t)w_, (uint64_t)h,
                                                  (uint64_t)n},
                                     st, kYCols)) != cudaSuccess)
    return err;
  ttop = tbot = tz1;  // read in halo mode only
  if (kHalo &&
      ((err = hopper::make_map_4d_nan(&ttop, a.top, {(uint64_t)C, (uint64_t)w_, 1, (uint64_t)n},
                                      st_row, kYCols)) != cudaSuccess ||
       (err = hopper::make_map_4d_nan(&tbot, a.bot, {(uint64_t)C, (uint64_t)w_, 1, (uint64_t)n},
                                      st_row, kYCols)) != cudaSuccess))
    return err;
  using B = __nv_bfloat16;
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tz1, ttop, tbot, static_cast<const B*>(a.w), static_cast<const B*>(a.b2),
      static_cast<const B*>(a.b1), static_cast<B*>(a.out), static_cast<uint8_t*>(a.codes),
      n, h, w_);
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
