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
// written (~5 bytes per conv pixel per channel). The wgrad alone at
// [8,320,1152,64]: 217 GFLOP, 0.22 ms at 989 TFLOP/s, against 0.18 ms for
// its 613 MB (z1 377 MB; g, out, codes 236 MB): bound by operations.
//
// Design, three launches:
//  1. dgrad: the forward kernel's implicit GEMM (stage1_mma.cuh) with the
//     flipped, transposed kernel wt[ci][dy][dx][co] = k2[co][ci][2-dy][2-dx]
//     (M = conv pixels, N = Cin, K = 9*Cout). The staged input tile is dz2,
//     built in shared memory from g, out and codes, halo zero; the epilogue
//     applies relu'(z1) and stores bf16.
//  2. wgrad on wgmma, in the TPU kernel's form dM[dy][dx] += y_shifted^T @
//     dz (stage1.py:389-392): M = Cin, N = Cout, K = conv pixels. A
//     persistent block of 512 threads walks tiles of 4 x 64 conv pixels and
//     stages each ONCE for all nine taps, in a ring of two stages. A
//     producer warpgroup loads the (4+2) x (64+2) relu(z1) input by TMA, one
//     box per row (NaN outside the image and past C, which relu by
//     max.bf16x2 makes 0, with or without b1; rows -1 and H from the halo
//     rows' maps in halo mode), and builds dz2 from g, out and codes, which
//     it copies by cp.async a tile ahead (each pooled element read once and
//     written to its window's four pixels; db2 summed as it goes); it gives
//     its registers to the consumers (setmaxnreg). A stage's z1 half is
//     released after the consumers' last ldmatrix of it and its dz2 half
//     after their last products from it, so the next tile's TMA starts a
//     tile early. Consumer warpgroup dy keeps the three dx accumulators
//     (64 x 64 f32 each) over all its tiles and per k16 step issues three
//     m64n64k16 products. The dx shift moves the pixels by one, which no
//     shared-memory descriptor can start at (8-row core matrices), so A =
//     relu(z1)^T comes from registers, loaded by ldmatrix.trans at any
//     pixel (bias and relu applied there); B = dz2 is read by descriptor,
//     MN-major ([pixel][co], the transpose flag), at aligned K. Both tiles
//     use 128-byte rows with the 128-byte swizzle (conflict-free ldmatrix),
//     so C < 64 (test widths only) pads M with zero A registers and N with
//     zero channels: one tile layout and one product form (m64n64k16 with
//     A in registers, hopper.cuh) for every width. Each block writes its
//     f32 partial dk2^T [tap][ci][co] and db2 once.
//  3. a sum over the partials in a fixed order, one thread per output
//     element. No float atomics: two runs are bit-identical, as the TPU's
//     per-row-block partials are (stage1.py:559-562).
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

#include "hopper.cuh"
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

constexpr int kWRows = 4;                         // conv rows per wgrad tile
constexpr int kWCols = 64;                        // conv columns per wgrad tile
constexpr int kWPix = kWRows * kWCols;            // K per tile: 16 k16 steps
constexpr int kWYRows = kWRows + 2;               // relu(z1) rows, halo incl.
constexpr int kWYCols = kWCols + 2;               // relu(z1) columns, halo incl.
constexpr int kWStages = 2;
constexpr int kWConsumers = 384;                  // warpgroups 0-2: tap row dy
constexpr int kWProducers = 128;                  // warpgroup 3
constexpr int kWThreads = kWConsumers + kWProducers;
constexpr int kWDzBytes = kWPix * 128;            // dz2 [pixel][64 co], 128-byte rows
// relu(z1) input [row][pixel][64 ci]: each row one TMA box of kWYCols
// pixels, padded to a 1024-byte boundary (the swizzle's period)
constexpr int kWYRowBytes = (kWYCols * 128 + 1023) / 1024 * 1024;
constexpr int kWYBytes = kWYRows * kWYRowBytes;
// the producer's staging of g, out (16 bytes) and codes (8) of the pooled
// chunks it routes: up to 4 per thread, slot [buffer][j][thread], two
// buffers (the next tile's are in flight while this one's dz2 is built)
constexpr int kWSlots = 4;
constexpr int kWSlotRow = kWSlots * kWProducers;
constexpr int kWPoolBytes = 2 * kWSlotRow * (16 + 16 + 8);
constexpr size_t kWSmem = 1024 + (size_t)kWStages * (kWDzBytes + kWYBytes) + kWPoolBytes +
                          kWProducers * 8 * sizeof(float) + 3 * kWStages * 8;
// registers a thread: 128 at launch (512 threads), then the producer gives
// 72 of them to the consumers' three 64 x 64 f32 accumulators
constexpr int kWProducerRegs = 56, kWConsumerRegs = 152;
static_assert(kWProducers * kWProducerRegs + kWConsumers * kWConsumerRegs <= 65536,
              "the register file");

// tz1 maps z1 [N][H][W][C], ttop / tbot the halo rows [N][1][W][C] (halo
// mode), each in boxes of one row of kWYCols pixels x 64 channels
template <int C, bool kHalo>
__global__ void __launch_bounds__(kWThreads, 1)
stage1_wgrad_kernel(const Pooled P,
                    const __grid_constant__ CUtensorMap tz1,
                    const __grid_constant__ CUtensorMap ttop,
                    const __grid_constant__ CUtensorMap tbot,
                    const __nv_bfloat16* __restrict__ b1,    // [C] halo mode
                    float* __restrict__ dk_part,   // [gridDim.x][9 taps][C ci][C co]
                    float* __restrict__ db_part,   // [gridDim.x][C]
                    int n_img, int H, int W) {
  constexpr int CH = C / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* dzs = smem;                                  // [stages][kWDzBytes]
  unsigned char* ys = smem + kWStages * kWDzBytes;            // [stages][kWYBytes]
  uint4* stg_g = reinterpret_cast<uint4*>(ys + kWStages * kWYBytes);  // [2][slots][producers]
  uint4* stg_out = stg_g + 2 * kWSlotRow;
  uint2* stg_codes = reinterpret_cast<uint2*>(stg_out + 2 * kWSlotRow);
  float* red = reinterpret_cast<float*>(stg_codes + 2 * kWSlotRow);  // [producers][8]
  // per stage: full (z1 landed and dz2 built), and the consumers' release of
  // its z1 tile (after their last ldmatrix of it) and of its dz2 tile (after
  // their last products from it), so the next z1 copies start a tile early
  const uint32_t full = hopper::smem_u32(red + kWProducers * 8);
  const uint32_t empty_y = full + 8 * kWStages, empty_dz = empty_y + 8 * kWStages;

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (W + kWCols - 1) / kWCols;
  const int tiles_y = (H + kWRows - 1) / kWRows;
  const int n_tiles = n_img * tiles_y * tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the dz2 stages zero once: the channels from C to 64 stay zero (the
  // relu(z1) stages are written whole by every tile's TMA)
  for (int i = threadIdx.x; i < kWStages * kWDzBytes / 16; i += kWThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  hopper::fence_proxy_async();  // wgmma reads those zeros
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1 + kWProducers);  // z1 landed, dz2 built
      hopper::mbar_init(empty_y + 8 * s, kWConsumers);
      hopper::mbar_init(empty_dz + 8 * s, kWConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kWConsumers / 32) {
    // producer: one thread loads each tile's relu(z1) input by TMA (NaN
    // outside the image, which relu makes 0 with or without b1; it lands on
    // the tile's barrier by itself), all build its dz2 from g, out and codes
    // staged one tile ahead
    hopper::setmaxnreg_dec<kWProducerRegs>();
    const int pt = threadIdx.x - kWConsumers;
    constexpr int kGroups = kWProducers / CH;  // threads per 16-byte channel chunk
    static_assert((kWPix / 4 + kGroups - 1) / kGroups <= kWSlots, "staging slots");
    const int ch = pt % CH, pg = pt / CH;      // this thread's chunk of dz2
    // g, out, codes of this thread's pooled chunks of tile t (zero past the
    // image) into staging buffer `buf`
    auto stage_pooled = [&](int t, int buf) {
      const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
      const int n = t / (tiles_x * tiles_y);
      for (int j = 0, pp = pg; j < kWSlots && pg < kGroups && pp < kWPix / 4;
           ++j, pp += kGroups) {
        const int py = ty * (kWRows / 2) + pp / (kWCols / 2);
        const int px = tx * (kWCols / 2) + pp % (kWCols / 2);
        const bool in = py < Ho && px < Wo;
        const size_t o = in ? (((size_t)n * Ho + py) * Wo + px) * C + ch * 8 : 0;
        const int slot = buf * kWSlotRow + j * kWProducers + pt;
        hopper::cp_async16(stg_g + slot, P.g + o, in);
        hopper::cp_async16(stg_out + slot, P.out + o, in);
        hopper::cp_async8(stg_codes + slot, P.codes + o, in);
      }
    };
    float dbacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (blockIdx.x < n_tiles) stage_pooled(blockIdx.x, 0);
    hopper::cp_async_commit();
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const int s = it % kWStages;
      hopper::mbar_wait(empty_y + 8 * s, ((it / kWStages) & 1) ^ 1);
      const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
      const int n = t / (tiles_x * tiles_y);
      const int r0 = ty * kWRows, c0 = tx * kWCols;
      if (pt == 0) {  // rows r0-1 .. r0+kWRows, columns c0-1 .. c0+kWCols
        hopper::mbar_expect_tx(full + 8 * s, kWYRows * kWYCols * 128);
        const uint32_t y = hopper::smem_u32(ys + s * kWYBytes);
        for (int tr = 0; tr < kWYRows; ++tr) {
          const int yy = r0 - 1 + tr;
          const uint32_t dst = y + tr * kWYRowBytes;
          if (kHalo && yy == -1) hopper::tma_load_4d(dst, &ttop, full + 8 * s, 0, c0 - 1, 0, n);
          else if (kHalo && yy == H) hopper::tma_load_4d(dst, &tbot, full + 8 * s, 0, c0 - 1, 0, n);
          else hopper::tma_load_4d(dst, &tz1, full + 8 * s, 0, c0 - 1, yy, n);
        }
      }
      if (t + (int)gridDim.x < n_tiles) stage_pooled(t + gridDim.x, (it + 1) & 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait_group<1>();  // this tile's g, out, codes have landed
      hopper::mbar_wait(empty_dz + 8 * s, ((it / kWStages) & 1) ^ 1);
      // dz2 from the tile's 2 x 32 pooled pixels: gr = out > 0 ? g : 0 to
      // the one conv pixel of its window that its code names, 0 to the
      // other three; db2 sums gr
      unsigned char* dz = dzs + s * kWDzBytes;
      for (int j = 0, pp = pg; j < kWSlots && pg < kGroups && pp < kWPix / 4;
           ++j, pp += kGroups) {
        const int pr = pp / (kWCols / 2), pc = pp % (kWCols / 2);
        const int slot = (it & 1) * kWSlotRow + j * kWProducers + pt;
        uint4 gv = stg_g[slot];
        const uint4 ov = stg_out[slot];
        const uint2 cv = stg_codes[slot];
        uint16_t* gh = reinterpret_cast<uint16_t*>(&gv);
        const __nv_bfloat16* oh = reinterpret_cast<const __nv_bfloat16*>(&ov);
        const uint8_t* cb = reinterpret_cast<const uint8_t*>(&cv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (!(__bfloat162float(oh[k]) > 0.f)) gh[k] = 0;
          dbacc[k] += __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(gh)[k]);
        }
#pragma unroll
        for (int pos = 0; pos < 4; ++pos) {
          uint4 v;
          uint16_t* vh = reinterpret_cast<uint16_t*>(&v);
#pragma unroll
          for (int k = 0; k < 8; ++k) vh[k] = cb[k] == pos ? gh[k] : (uint16_t)0;
          const int p = (2 * pr + (pos >> 1)) * kWCols + 2 * pc + (pos & 1);
          *reinterpret_cast<uint4*>(dz + hopper::sw128_offset(p, ch)) = v;
        }
      }
      hopper::fence_proxy_async();  // the dz2 stores, for wgmma's reads
      hopper::mbar_arrive(full + 8 * s);
    }
    // the block's db2 partial: the kGroups threads of each chunk, in order
#pragma unroll
    for (int k = 0; k < 8; ++k) red[pt * 8 + k] = dbacc[k];
    hopper::bar_sync(1, kWProducers);
    for (int c = pt; c < C; c += kWProducers) {
      float sum = 0.f;
      for (int g = 0; g < kGroups; ++g) sum += red[(g * CH + c / 8) * 8 + c % 8];
      db_part[(size_t)blockIdx.x * C + c] = sum;
    }
    return;
  }

  // consumer warpgroup dy: dk2[dy][dx]^T [ci][co] += relu(z1)^T shifted by
  // (dy, dx) [ci][pixel] @ dz2 [pixel][co], one accumulator per dx. A comes
  // from registers, loaded by ldmatrix.trans at any pixel (the dx shift);
  // M = Cin is padded to 64 with zero rows, N = Cout to 64 with zero columns
  hopper::setmaxnreg_inc<kWConsumerRegs>();
  const int dy = warp >> 2, wl = warp & 3;
  const bool live = 16 * wl < C;  // this warp's rows ci = 16 wl..+16
  const int mat = lane >> 3;
  // this lane's ldmatrix row: input row r + dy, pixel poff + column,
  // channel chunk `chunk` (matrix mat: ci + 8 (mat & 1), pixel + 8 (mat >> 1))
  const int poff = 8 * (mat >> 1) + (lane & 7);
  const int chunk = 2 * wl + (mat & 1);
  __nv_bfloat162 bias[2] = {__float2bfloat162_rn(0.f), __float2bfloat162_rn(0.f)};
  if (kHalo && live) {  // b1 of the fragment rows ci = 16 wl + lane/4 (+8)
    bias[0] = __bfloat162bfloat162(b1[16 * wl + (lane >> 2)]);
    bias[1] = __bfloat162bfloat162(b1[16 * wl + (lane >> 2) + 8]);
  }
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  float acc[3][32];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[dx][r] = 0.f;

  int it = 0, prev = -1;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it % kWStages;
    hopper::mbar_wait(full + 8 * s, (it / kWStages) & 1);
    const unsigned char* y = ys + s * kWYBytes + dy * kWYRowBytes;
    const uint32_t dz = hopper::smem_u32(dzs + s * kWDzBytes);
#pragma unroll
    for (int kk = 0; kk < kWPix / 16; ++kk) {
      const int row = kk / (kWCols / 16), col = kk % (kWCols / 16) * 16;
      uint32_t a[3][4];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (live) {
          ldsm_x4_t(a[dx], y + row * kWYRowBytes +
                               hopper::sw128_offset(poff + col + dx, chunk));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&a[dx][i]);
            if constexpr (kHalo) v = __hadd2(v, bias[i & 1]);
            v = __hmax2(v, zero);
            a[dx][i] = *reinterpret_cast<uint32_t*>(&v);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[dx][i] = 0u;
        }
      }
      if (kk == kWPix / 16 - 1) hopper::mbar_arrive(empty_y + 8 * s);  // z1 read
      hopper::wgmma_fence();
      const uint64_t db = hopper::desc_sw128(dz + kk * 2048);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) hopper::wgmma_n64_rs_tb(acc[dx], a[dx], db, 1);
      hopper::wgmma_commit();
      // the last step's products are done: its A registers are free, and
      // at a tile's first step the previous tile's dz2 is no longer read
      hopper::wgmma_wait<1>();
      if (kk == 0 && prev >= 0) hopper::mbar_arrive(empty_dz + 8 * prev);
    }
    prev = s;
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) hopper::fence_regs(acc[dx]);

  // the block's partial from the fragments: register r holds ci = 16 wl +
  // lane/4 + 8 ((r/2) % 2), co = 8 (r/4) + 2 (lane % 4) + r % 2
  if (!live) return;
  float* part = dk_part + (size_t)blockIdx.x * 9 * C * C;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int tap = 3 * dy + dx;
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int ci = 16 * wl + (lane >> 2) + 8 * ((r >> 1) & 1);
      const int co = 8 * (r >> 2) + 2 * (lane & 3);
      if (co < C)
        *reinterpret_cast<float2*>(part + ((size_t)tap * C + ci) * C + co) =
            make_float2(acc[dx][r], acc[dx][r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the fixed-order sum of the partials
// ---------------------------------------------------------------------------

// one thread per element, in the partials' order (coalesced reads)
__global__ void stage1_wgrad_sum_kernel(const float* __restrict__ dk_part,
                                        const float* __restrict__ db_part,
                                        const float* __restrict__ db1_part,
                                        float* __restrict__ dk2,  // [C][3][3][C]
                                        float* __restrict__ db2,
                                        float* __restrict__ db1,  // halo mode
                                        int parts, int dparts, int C) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nk = 9 * C * C;
  if (e < nk) {  // e = (tap * C + ci) * C + co
    const int co = e % C, ci = (e / C) % C, tap = e / (C * C);
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += dk_part[(size_t)p * nk + e];
    dk2[((size_t)co * 9 + tap) * C + ci] = s;
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
cudaError_t wgrad_parts(int n, int h, int w, int* parts) {
  // the halo instance has the same resources; the plain one sets the count
  cudaError_t err = cudaFuncSetAttribute(stage1_wgrad_kernel<C, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWSmem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)n * ((h + kWRows - 1) / kWRows) * ((w + kWCols - 1) / kWCols);
  int grid = 0;
  if ((err = persistent_grid(stage1_wgrad_kernel<C, false>, kWThreads, kWSmem, tiles,
                             &grid)) != cudaSuccess)
    return err;
  *parts = grid < 1 ? 1 : grid;
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
  auto wgrad = stage1_wgrad_kernel<C, kHalo>;
  if ((err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kWSmem)) != cudaSuccess)
    return err;
  CUtensorMap tz1, ttop, tbot;
  const uint64_t st[3] = {(uint64_t)C, (uint64_t)w * C, (uint64_t)h * w * C};
  const uint64_t st_row[3] = {(uint64_t)C, (uint64_t)w * C, (uint64_t)w * C};
  if ((err = hopper::make_map_4d_nan(&tz1, a.z1, {(uint64_t)C, (uint64_t)w, (uint64_t)h,
                                                  (uint64_t)n},
                                     st, kWYCols)) != cudaSuccess)
    return err;
  ttop = tbot = tz1;  // read in halo mode only
  if (kHalo &&
      ((err = hopper::make_map_4d_nan(&ttop, a.ztop, {(uint64_t)C, (uint64_t)w, 1, (uint64_t)n},
                                      st_row, kWYCols)) != cudaSuccess ||
       (err = hopper::make_map_4d_nan(&tbot, a.zbot, {(uint64_t)C, (uint64_t)w, 1, (uint64_t)n},
                                      st_row, kWYCols)) != cudaSuccess))
    return err;
  wgrad<<<parts, kWThreads, kWSmem, stream>>>(
      a.P, tz1, ttop, tbot, b1, static_cast<float*>(a.dk_part),
      static_cast<float*>(a.db_part), n, h, w);
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

// The number of wgrad partials (the wgrad launch's blocks) for this shape: the
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
