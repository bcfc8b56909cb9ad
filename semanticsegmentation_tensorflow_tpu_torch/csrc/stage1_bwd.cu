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
// What bounds it on the H100. dgrad and wgrad each do the forward conv's
// multiply-adds (2 x 17.7 G per 384x1248 image, 2 x 136 G for a
// 8x320x1152 batch). At [8,320,1152,64] the wgrad reads z1 377 MB and g,
// out, codes 236 MB: 0.18 ms at 3.35 TB/s against 0.22 ms for its 217
// GFLOP, bound by operations. The dgrad reads the same and writes dz1 (377
// MB): 991 MB, 0.296 ms, bound by bytes.
//
// Design, three launches:
//  1. dgrad on wgmma (the SAME conv of dz2 with the flipped kernel
//     wt[ty][tx][co][ci] = k2[co][ci][2-ty][2-tx]): M = conv pixels, N =
//     Cin, K = 9 taps x Cout. A persistent block of 512 threads walks tiles
//     of 4 x 64 output pixels. Two producer warpgroups build each tile's
//     dz2, (4+2) x (64+2) pixels with its halo, into a ring of two stages
//     from g, out and codes (each pooled chunk read once and written to the
//     pixels of its window in the stage; codes compared four bytes at a
//     time). Each thread's chunk j comes by cp.async as a commit group of
//     its own, and the next tile's copy of that slot is issued as soon as
//     the slot is read, so every copy has about a tile's build to land (with
//     one producer warpgroup, or copies issued after a whole build, the
//     producer set the launch's time). Two consumer warpgroups own two
//     output rows each. A = dz2 [pixel][co] comes from registers by ldmatrix
//     at any pixel (the dx shift, which no descriptor can start at), and
//     each fragment of a dz2 row feeds the products of both output rows it
//     is a tap row of: 6 m64n64k16 products per 4 ldmatrix.x4. B = the
//     weights, staged once per block as [tap][co][ci] with 128-byte
//     swizzled rows, MN-major. A stage is released after the consumers'
//     last ldmatrix of it, so the producers refill it while the products
//     run. The epilogue needs no shared memory: the weights' ci columns are
//     permuted so that lane q of each quad accumulates the 16 contiguous
//     channels 16q..16q+15 of its pixel, and z1 (loaded before the
//     products) and dz1 go as two 16-byte accesses a pixel. C < 64 (test
//     widths) pads N with zero weight columns and runs C/16 k16 steps a
//     tap. Shared memory: weights 9 x 64 x 128 B = 73,728 B; dz2 2 stages x
//     6 x 66 x 128 B = 101,376 B; the producers' staging 5 slots x 256
//     threads x 40 B = 51,200 B; 1,024 B of alignment and the barriers:
//     227,360 of the 232,448 a block may use. A third stage (50,688 B) or a
//     z1 tile (32,768 B) does not fit beside the staging, so z1 comes into
//     registers and the ring has two stages.
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

// ---------------------------------------------------------------------------
// 1. dgrad (+ db1 partials in halo mode)
// ---------------------------------------------------------------------------

constexpr int kDRows = 4;                          // output rows per dgrad tile
constexpr int kDCols = 64;                         // output columns: one m64 product
constexpr int kDZRows = kDRows + 2;                // dz2 rows staged, halo incl.
constexpr int kDZCols = kDCols + 2;                // dz2 columns staged, halo incl.
constexpr int kDStages = 2;
constexpr int kDConsumers = 256;                   // warpgroups 0-1: rows 2 wg, 2 wg + 1
constexpr int kDProducers = 256;                   // warpgroups 2-3
constexpr int kDThreads = kDConsumers + kDProducers;
constexpr int kDWBytes = 9 * 64 * 128;             // weights [tap][co][64 ci], 128-byte rows
constexpr int kDZBytes = kDZRows * kDZCols * 128;  // dz2 [row][pixel][64 co]
// the pooled pixels whose windows cover a stage: 4 rows x 34 columns
constexpr int kDPoolRows = kDRows / 2 + 2;
constexpr int kDPoolCols = kDCols / 2 + 2;
// the producer's staging of g, out (16 bytes) and codes (8) of the pooled
// chunks it routes, slot [j][thread]: 1088 chunks at C = 64, 5 a thread
constexpr int kDSlots = (kDPoolRows * kDPoolCols * 8 + kDProducers - 1) / kDProducers;
constexpr int kDSlotBytes = kDSlots * kDProducers * (16 + 16 + 8);
constexpr size_t kDSmem =
    1024 + kDWBytes + (size_t)kDStages * kDZBytes + kDSlotBytes + 2 * kDStages * 8;
static_assert(kDSmem <= 232448, "shared memory a block can use");
static_assert(kDConsumers * 16 * 4 <= kDZBytes, "db1 reduction in a dz2 stage");
// registers a thread: 128 at launch (512 threads), then the producers give
// 72 of them to the consumers (two 64 x 64 f32 accumulators, z1 prefetch).
// setmaxnreg moves registers within the block's launch allocation: a
// larger sum never completes (the consumers' increase waits forever).
constexpr int kDLaunchRegs = 128, kDProducerRegs = 56, kDConsumerRegs = 200;
static_assert(kDProducers * kDProducerRegs + kDConsumers * kDConsumerRegs <=
                  kDThreads * kDLaunchRegs,
              "the block's registers");

// wt: the flipped kernel [tap = 3 ty + tx][co][ci] = k2[co][ci][2-ty][2-tx]
template <int C, bool kHalo>
__global__ void __launch_bounds__(kDThreads, 1)
stage1_dgrad_kernel(const Pooled P,                          // [N][H/2][W/2][C]
                    const __nv_bfloat16* __restrict__ z1,    // [N][H][W][C]
                    const __nv_bfloat16* __restrict__ b1,    // [C] halo mode
                    const __nv_bfloat16* __restrict__ wt,    // [9][Cout][Cin]
                    __nv_bfloat16* __restrict__ dz1,         // [N][H][W][C]
                    float* __restrict__ db1_part,            // [gridDim.x][C] halo mode
                    int n_img, int H, int W) {
  constexpr int CH = C / 8;
  constexpr int KS = C / 16;  // k16 steps per tap
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ws = smem;                                   // [9][64 co][128 B]
  unsigned char* dzs = smem + kDWBytes;                       // [stages][kDZBytes]
  uint4* stg_g = reinterpret_cast<uint4*>(dzs + kDStages * kDZBytes);  // [slots][producers]
  uint4* stg_out = stg_g + kDSlots * kDProducers;
  uint2* stg_codes = reinterpret_cast<uint2*>(stg_out + kDSlots * kDProducers);
  // per stage: full (dz2 built) and empty (the consumers' last ldmatrix of it)
  const uint32_t full = hopper::smem_u32(stg_codes + kDSlots * kDProducers);
  const uint32_t empty = full + 8 * kDStages;

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (W + kDCols - 1) / kDCols;
  const int tiles_y = (H + kDRows - 1) / kDRows;
  const int n_tiles = n_img * tiles_y * tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the weights once per block, as the MN-major B operand: row co, 128-byte
  // swizzled rows of 64 ci in the order that gives lane q of each quad the
  // 16 contiguous channels 16q..16q+15 of its accumulator row: physical
  // column n = 8 (n/8) + 2 q + e holds ci = 16 q + 2 (n/8) + e; ci >= C zero
  for (int i = threadIdx.x; i < 9 * C * 8; i += kDThreads) {
    const int nc = i % 8, row = i / 8;  // row = tap * C + co
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ci = 16 * q + 2 * nc;
      v[q] = ci < C ? *reinterpret_cast<const uint32_t*>(wt + (size_t)row * C + ci) : 0u;
    }
    *reinterpret_cast<uint4*>(ws + (row / C) * 8192 + hopper::sw128_offset(row % C, nc)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  hopper::fence_proxy_async();  // wgmma reads the weights
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDStages; ++s) {
      hopper::mbar_init(full + 8 * s, kDProducers);
      hopper::mbar_init(empty + 8 * s, kDConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kDConsumers / 32) {
    // producer: builds each tile's dz2 (halo incl.) from g, out and codes;
    // each pooled chunk is read once and written to the pixels of its window
    // that lie in the stage. Chunk j of a thread comes by cp.async into its
    // own slot as one commit group, and the next tile's copy of that slot is
    // issued as soon as the slot is read, so every copy has about a tile's
    // build to land (cp.async.wait_group kDSlots - 1 before a slot is read).
    hopper::setmaxnreg_dec<kDProducerRegs>();
    const int pt = threadIdx.x - kDConsumers;
    constexpr int kItems = kDPoolRows * kDPoolCols * CH;
    static_assert(kItems <= kDSlots * kDProducers, "staging slots");
    // the pooled window of tile t: image n, first pooled row and column
    struct Window {
      int n, py0, px0;
    };
    auto window = [&](int t) {
      const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
      return Window{t / (tiles_x * tiles_y), ty * (kDRows / 2) - 1, tx * (kDCols / 2) - 1};
    };
    // g, out, codes of pooled chunk j of this thread in window w into its
    // slot (zero past the image)
    auto copy_chunk = [&](const Window& w, int j) {
      const int i = pt + j * kDProducers;
      if (i >= kItems) return;
      const int n = w.n, ch = i % CH, pp = i / CH;
      const int py = w.py0 + pp / kDPoolCols, px = w.px0 + pp % kDPoolCols;
      const __nv_bfloat16 *g = P.g, *out = P.out;
      const uint8_t* cd = P.codes;
      bool in = px >= 0 && px < Wo;
      size_t o = 0;
      if (py >= 0 && py < Ho) {
        o = (((size_t)n * Ho + py) * Wo + px) * C + ch * 8;
      } else if (kHalo && (py == -1 || py == Ho)) {  // the neighbours' pooled rows
        if (py < 0) g = P.gt, out = P.ot, cd = P.ct;
        else g = P.gb, out = P.ob, cd = P.cb;
        o = ((size_t)n * Wo + px) * C + ch * 8;
      } else {
        in = false;
      }
      if (!in) o = 0, g = P.g, out = P.out, cd = P.codes;
      const int slot = j * kDProducers + pt;
      hopper::cp_async16(stg_g + slot, g + o, in);
      hopper::cp_async16(stg_out + slot, out + o, in);
      hopper::cp_async8(stg_codes + slot, cd + o, in);
    };
    if (blockIdx.x < n_tiles) {
      const Window w = window(blockIdx.x);
#pragma unroll
      for (int j = 0; j < kDSlots; ++j) {
        copy_chunk(w, j);
        hopper::cp_async_commit();
      }
    }
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const int s = it % kDStages;
      hopper::mbar_wait(empty + 8 * s, ((it / kDStages) & 1) ^ 1);
      const Window w = window(t);
      const int r0 = 2 * (w.py0 + 1), c0 = 2 * (w.px0 + 1);
      const bool more = t + (int)gridDim.x < n_tiles;
      const Window next = window(more ? t + gridDim.x : t);
      unsigned char* dz = dzs + s * kDZBytes;
#pragma unroll
      for (int j = 0; j < kDSlots; ++j) {
        hopper::cp_async_wait_group<kDSlots - 1>();  // this slot's copy has landed
        const int i = pt + j * kDProducers;
        if (i < kItems) {
          const int ch = i % CH, pp = i / CH;
          const int py = w.py0 + pp / kDPoolCols, px = w.px0 + pp % kDPoolCols;
          const int slot = j * kDProducers + pt;
          uint4 gv = stg_g[slot];
          const uint4 ov = stg_out[slot];
          const uint2 cv = stg_codes[slot];
          uint16_t* gh = reinterpret_cast<uint16_t*>(&gv);
          const __nv_bfloat16* oh = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
          for (int k = 0; k < 8; ++k)  // gr = out > 0 ? g : 0
            if (!(__bfloat162float(oh[k]) > 0.f)) gh[k] = 0;
          // the window's pixel (2 py + a, 2 px + b) at stage row y - r0 + 1,
          // column x - c0 + 1 takes gr where the code is 2a + b; zero outside
          // the image (rows -1 and H are the halo rows' in halo mode)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int y = 2 * py + a, tr = y - r0 + 1;
            if (tr < 0 || tr >= kDZRows) continue;
            const bool y_ok = kHalo ? (y >= -1 && y <= H) : (y >= 0 && y < H);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int x = 2 * px + b, tc = x - c0 + 1;
              if (tc < 0 || tc >= kDZCols) continue;
              // 0xFF in each byte of codes that equals 2a + b: bit 7 of a
              // byte of ((x & 0x7F..) + 0x7F..) | x is set where the byte of
              // x = codes ^ sel is not 0 (no carry crosses a byte)
              const uint32_t sel = (uint32_t)(2 * a + b) * 0x01010101u;
              const uint32_t x0 = cv.x ^ sel, x1 = cv.y ^ sel;
              const uint32_t m0 =
                  ((~(((x0 & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x0) & 0x80808080u) >> 7) * 0xFFu;
              const uint32_t m1 =
                  ((~(((x1 & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x1) & 0x80808080u) >> 7) * 0xFFu;
              uint4 v = make_uint4(gv.x & __byte_perm(m0, 0, 0x1100),
                                   gv.y & __byte_perm(m0, 0, 0x3322),
                                   gv.z & __byte_perm(m1, 0, 0x1100),
                                   gv.w & __byte_perm(m1, 0, 0x3322));
              if (!(y_ok && x >= 0 && x < W)) v = make_uint4(0u, 0u, 0u, 0u);
              *reinterpret_cast<uint4*>(dz + hopper::sw128_offset(tr * kDZCols + tc, ch)) = v;
            }
          }
        }
        if (more) copy_chunk(next, j);  // the slot is read: the next tile's copy
        hopper::cp_async_commit();
      }
      hopper::mbar_arrive(full + 8 * s);
    }
    return;
  }

  // consumer warpgroup wg: output rows r0 + 2 wg + oo (oo = 0, 1), 64 pixels
  // each (M), all Cin (N = 64), K = 9 taps x Cout. A = dz2 [pixel][co] from
  // registers (ldmatrix at any pixel: the dx shift), B = the weights by
  // descriptor. Each A fragment of stage row 2 wg + tr feeds the products of
  // both rows it is a tap row of (ty = tr - oo in 0..2): 6 per 4 ldmatrix.
  hopper::setmaxnreg_inc<kDConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3;
  const int q = lane & 3, gq = lane >> 2;
  const bool live = 16 * q < C;  // this lane's output channels 16 q..+16
  // this lane's ldmatrix row: pixel 16 wl + (lane & 7) + 8 ((lane >> 3) & 1),
  // channel chunk + (lane >> 4) (matrices: rows +8, then k +8)
  const int apix = 16 * wl + (lane & 7) + 8 * ((lane >> 3) & 1), achunk = lane >> 4;
  const uint32_t wbase = hopper::smem_u32(ws);
  __nv_bfloat162 bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bias[j] = (kHalo && live) ? *reinterpret_cast<const __nv_bfloat162*>(b1 + 16 * q + 2 * j)
                              : __float2bfloat162_rn(0.f);
  // halo mode: this thread's sums of the dz1 it stores, channels 16 q + k
  float db1acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) db1acc[k] = 0.f;

  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it % kDStages;
    const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y;
    const int n = t / (tiles_x * tiles_y);
    const int r0 = ty * kDRows, c0 = tx * kDCols;
    // z1 for the relu' mask, loaded before the products: this lane's 32
    // bytes (channels 16 q..) of pixels 16 wl + gq (+8) of its two rows
    uint4 zv[2][2][2];
#pragma unroll
    for (int oo = 0; oo < 2; ++oo)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = r0 + 2 * wg + oo, x = c0 + 16 * wl + gq + 8 * h;
        const bool ok = live && y < H && x < W;
        const size_t o = ok ? (((size_t)n * H + y) * W + x) * C + 16 * q : 0;
        const uint4* src = reinterpret_cast<const uint4*>(z1 + o);
        const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
        zv[oo][h][0] = ok ? __ldg(src) : zero4;
        zv[oo][h][1] = ok ? __ldg(src + 1) : zero4;
      }
    float acc[2][32];
#pragma unroll
    for (int oo = 0; oo < 2; ++oo)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[oo][r] = 0.f;

    hopper::mbar_wait(full + 8 * s, (it / kDStages) & 1);
    const unsigned char* st = dzs + s * kDZBytes;
#pragma unroll
    for (int tx3 = 0; tx3 < 3; ++tx3) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4][4];
#pragma unroll
        for (int tr = 0; tr < 4; ++tr)
          ldsm_x4(a[tr], st + hopper::sw128_offset((2 * wg + tr) * kDZCols + apix + tx3,
                                                   2 * ks + achunk));
        if (tx3 == 2 && ks == KS - 1) hopper::mbar_arrive(empty + 8 * s);  // dz2 read
        hopper::wgmma_fence();
#pragma unroll
        for (int tr = 0; tr < 4; ++tr)
#pragma unroll
          for (int oo = 0; oo < 2; ++oo) {
            const int tyy = tr - oo;
            if (tyy < 0 || tyy > 2) continue;
            hopper::wgmma_n64_rs_tb(
                acc[oo], a[tr],
                hopper::desc_sw128(wbase + (3 * tyy + tx3) * 8192 + ks * 2048), 1);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous step's A registers are free
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);

    // epilogue: register 4 j + 2 h + e of a row holds pixel 16 wl + gq + 8 h,
    // ci 16 q + 2 j + e: relu'(z1) mask, one bf16 rounding, 2 x 16-byte stores
#pragma unroll
    for (int oo = 0; oo < 2; ++oo)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = r0 + 2 * wg + oo, x = c0 + 16 * wl + gq + 8 * h;
        const bool ok = live && y < H && x < W;
        const uint32_t* zw = reinterpret_cast<const uint32_t*>(zv[oo][h]);
        uint32_t d[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          __nv_bfloat162 z = *reinterpret_cast<const __nv_bfloat162*>(&zw[j]);
          if constexpr (kHalo) z = __hadd2(z, bias[j]);
          const float2 zf = __bfloat1622float2(z);
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              zf.x > 0.f ? acc[oo][4 * j + 2 * h] : 0.f,
              zf.y > 0.f ? acc[oo][4 * j + 2 * h + 1] : 0.f);
          d[j] = *reinterpret_cast<const uint32_t*>(&v);
          if (kHalo && ok) {
            const float2 f = __bfloat1622float2(v);
            db1acc[2 * j] += f.x;
            db1acc[2 * j + 1] += f.y;
          }
        }
        if (ok) {
          uint4* dst = reinterpret_cast<uint4*>(
              dz1 + (((size_t)n * H + y) * W + x) * C + 16 * q);
          dst[0] = make_uint4(d[0], d[1], d[2], d[3]);
          dst[1] = make_uint4(d[4], d[5], d[6], d[7]);
        }
      }
  }
  if constexpr (kHalo) {
    // the block's db1 partial: the 64 threads of channel c (8 warps, 8 quads,
    // lane q = c / 16) summed in a fixed order, in dz2 stage 0
    hopper::bar_sync(1, kDConsumers);  // every consumer is past its last ldmatrix
    float* red = reinterpret_cast<float*>(dzs);  // [consumer thread][16]
#pragma unroll
    for (int k = 0; k < 16; ++k) red[threadIdx.x * 16 + k] = db1acc[k];
    hopper::bar_sync(1, kDConsumers);
    for (int c = threadIdx.x; c < C; c += kDConsumers) {
      const int qq = c / 16, k = c % 16;
      float sum = 0.f;
      for (int w8 = 0; w8 < kDConsumers / 32; ++w8)
        for (int g8 = 0; g8 < 8; ++g8) sum += red[(w8 * 32 + 4 * g8 + qq) * 16 + k];
      db1_part[(size_t)blockIdx.x * C + c] = sum;
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

// The dgrad launch's persistent grid (the number of db1 partials in halo
// mode): one block per SM, at most one per tile of kDRows x kDCols pixels.
template <int C, bool kHalo>
cudaError_t dgrad_parts(int n, int h, int w, int* parts) {
  cudaError_t err = cudaFuncSetAttribute(stage1_dgrad_kernel<C, kHalo>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kDSmem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)n * ((h + kDRows - 1) / kDRows) * ((w + kDCols - 1) / kDCols);
  return persistent_grid(stage1_dgrad_kernel<C, kHalo>, kDThreads, kDSmem, tiles, parts);
}

template <int C, bool kHalo>
cudaError_t launch_bwd(const BwdArgs& a, int parts, int dparts, int n, int h, int w,
                       cudaStream_t stream) {
  using B = __nv_bfloat16;
  const auto* zb = static_cast<const B*>(a.z1);
  const auto* b1 = static_cast<const B*>(a.b1);
  cudaError_t err;

  // 1. dgrad; in halo mode on as many blocks as the caller has db1 partials
  int grid = 0;
  if ((err = dgrad_parts<C, kHalo>(n, h, w, &grid)) != cudaSuccess) return err;
  if (kHalo) grid = dparts;
  if (grid < 1) return cudaErrorInvalidValue;
  stage1_dgrad_kernel<C, kHalo><<<grid, kDThreads, kDSmem, stream>>>(
      a.P, zb, b1, static_cast<const B*>(a.wt), static_cast<B*>(a.dz1),
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
    case 16: err = dgrad_parts<16, true>(n, h, w, &parts); break;
    case 32: err = dgrad_parts<32, true>(n, h, w, &parts); break;
    case 48: err = dgrad_parts<48, true>(n, h, w, &parts); break;
    case 64: err = dgrad_parts<64, true>(n, h, w, &parts); break;
    default: err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? parts : -(int)err;
}

// C entry. Device pointers: g, out, codes [N][H/2][W/2][C] (bf16, bf16, u8),
// z1 [N][H][W][C] bf16 (pre-relu, b1 added), wt = the flipped conv kernel
// [3][3][Cout][Cin] bf16 (wt[ty][tx][co][ci] = k2[co][ci][2-ty][2-tx]),
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
