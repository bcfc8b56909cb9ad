// Winograd F(2,3) / F(4,3) 3x3 SAME convolution (kernel 6): the forward, the
// masked forward that is the input gradient, and the weight gradient.
//
// Replaces: semanticsegmentation_tensorflow_tpu/ops/pallas/winograd.py
//   _fwd_kernel (:146) and _wgrad_kernel (:231), behind
//   winograd_conv_bias_relu (:467) and winograd_conv3x3 (:512).
// It computes what those compute, on the port's NHWC layout, not the TPU's
// [H, wt, m, N, C] tile view.
//
// Contract (m = 2 or 4, a = m + 2; H, W multiples of m; C, Co multiples of 32):
//   forward  out[n, m*ty+p, m*tx+l, co] = epi( sum_i AT[p,i] sum_j AT[l,j]
//              sum_c bf16(V[i,j][t, c]) * U[i,j][c, co] ),  t = (n, ty, tx),
//            V[i,j] = sum_r BT[i,r] sum_s BT[j,s] d[r,s] (f32, width first),
//            d the a x a input patch at (m*ty - 1, m*tx - 1), zero outside the
//            image; masked mode loads d as x * (o > 0). epi: bias_relu is
//            relu(y + b), b bf16, in f32; none is y. One bf16 rounding out.
//   wgrad    dU[i,j][c, co] = sum_t bf16(V[i,j][t, c]) * bf16(dM[i,j][t, co]),
//            dM[i,j] = sum_p AT[p,i] sum_l AT[l,j] dz[p,l] (f32, width first),
//            dz = g (* (o > 0) when masked); db[co] = sum dz. f32 sums.
// The transforms take the TPU kernel's order (its _combine: structural zeros
// skipped, +-1 as a sign, no fused multiply-add), so V and dM round exactly as
// the plain version's (ops/cuda/winograd.py); the output transform folds each
// coordinate row in the TPU kernel's order (_fwd_kernel :190-211: over j into
// m_acc, then over i into y_acc), once the row's products are complete.
//
// Design: two passes, each input element transformed once.
//   1. Transform. A block stages the input rows its tiles need (m*R + 2 rows
//      x m*TW + 2 columns x a channel chunk) in shared memory once, by
//      cp.async, applies the masked mode's relu mask there once per element,
//      and slides down them: each staged row's width transform is computed
//      once and folded into the (at most two) tile rows that share it. V
//      goes to device memory in bf16, [a^2][tiles][C] for the forward (K = C
//      contiguous) and [a^2][C][tiles] for the wgrad (K = tiles contiguous,
//      tile rows padded to 8 tiles); the wgrad's dM likewise [a^2][Co][tiles],
//      with per-block db partials. Both leave through shared memory in
//      16-byte stores.
//   2. Products on wgmma (sm_90a), both operands K-major in shared memory
//      with the 128-byte swizzle, fed by TMA through a ring of stages: one
//      producer thread keeps the loads in flight (an mbarrier pair per
//      stage), two consumer warpgroups run m64nN wgmmas on the stages that
//      arrived, so the loads of later K chunks overlap the products of this
//      one. Forward: a block owns 64 tiles x 64 (f2) or 32 (f4) output
//      channels; for each coordinate it sums V[i,j] U[i,j] over all of C
//      and folds it into m_acc, then each finished row of m_acc into y_acc:
//      2 + m + m^2 accumulators live (two take turns, so one coordinate's
//      fold overlaps the next one's products), not a^2, the output
//      transform and epilogue in the registers. Its producer is a whole
//      warpgroup that gives its registers to the consumers (setmaxnreg).
//      Wgrad: one block per (coordinate, 128 C, 128 Co, part of the tiles),
//      partials summed in a fixed order by a second launch (no float atomics:
//      two runs give the same bits), db the same way.
// What bounds it on the H100 (80GB HBM3, 700 W; tools/winograd_ab.py
// --breakdown, PERF.md section 6, PR 6), at [8,160,576,128] -> 128, f2:
//   forward, dgrad: the transform pass writes V (4x the input; 2.25x for f4)
//     at ~90 % of the HBM rate, 0.35 ms (masked 0.42); the products pass,
//     0.57 ms, streams V once per 64-channel block and U once per 64-tile
//     block from L2 at ~5 TB/s. The products alone would take 0.10 ms.
//   wgrad: the transposed V and dM passes, 0.47 and 0.60 ms, write 755 MB
//     each at 60-70 % of the HBM rate; the products pass reads both once,
//     0.50 ms. The fixed-order sums take 0.03 ms.
// So the scratch round trip, not the products, bounds every mode: the
// design keeps it to one transform per element (none repeated per output
// channel block), 16-byte stores, and a TMA ring deep enough to keep the
// loads in flight. Sharing V across a cluster of output-channel blocks by
// TMA multicast was measured slower (PERF.md) and is not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// The transform tables (ops/winograd.py VARIANTS; the port's tests read these
// four lines and hold them equal to it).
template <int M> __host__ __device__ constexpr float bt(int i, int j);
template <int M> __host__ __device__ constexpr float at(int i, int j);
template <> __host__ __device__ constexpr float bt<2>(int i, int j) {
  constexpr float t[4][4] = {{-1, 0, 1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, -1, 0, 1}};
  return t[i][j];
}
template <> __host__ __device__ constexpr float at<2>(int i, int j) {
  constexpr float t[2][4] = {{1, 1, 1, 0}, {0, 1, -1, 1}};
  return t[i][j];
}
template <> __host__ __device__ constexpr float bt<4>(int i, int j) {
  constexpr float t[6][6] = {{1, -1.5f, -2, 1.5f, 1, 0}, {0, 1, -2.5f, 0.5f, 1, 0}, {0, -1, 0.5f, 2.5f, 1, 0}, {0, -2, -1, 2, 1, 0}, {0, 0.5f, -1, -0.5f, 1, 0}, {0, 1, -1.5f, -2, 1.5f, 1}};
  return t[i][j];
}
template <> __host__ __device__ constexpr float at<4>(int i, int j) {
  constexpr float t[4][6] = {{1, 1, 1, 1, 1, 0}, {0, -1, 1, 0.5f, -2, 0}, {0, 1, 1, 0.25f, 4, 0}, {0, -1, 1, 0.125f, -8, 1}};
  return t[i][j];
}

// acc + c * x with the TPU kernel's rounding: zeros skipped, +-1 a sign,
// otherwise one rounded multiply and one rounded add (never an FMA)
__device__ __forceinline__ void cadd(float& acc, float c, float x) {
  if (c == 0.f) return;
  acc = __fadd_rn(acc, c == 1.f ? x : (c == -1.f ? -x : __fmul_rn(c, x)));
}


// ---------------------------------------------------------------------------
// pass 1: the transforms
// ---------------------------------------------------------------------------

constexpr int kXfThreads = 256;

// A block: R tile rows x TW tile columns x CC channels, one thread per
// (tile column, channel) walking the R tile rows. Its output is staged in
// shared memory, rows 16-byte aligned, and leaves in 16-byte stores: TC
// so[xi][tile][RO] to v[xi][t][c], CT (transposed) so[xi][channel][RO] to
// v[xi][c][t].
template <int M, bool CT>
struct Xf {
  static constexpr int A = M + 2, NC = A * A;
  static constexpr int R = M == 2 ? 4 : 2;
  static constexpr int TW = CT ? 16 : 8;
  static constexpr int CC = CT ? 16 : 32;
  static constexpr int T = R * TW;  // tiles per block
  // staged pixel stride (bf16): with 16 channels, the two tile columns of a
  // warp land in distinct banks
  static constexpr int CS = CC == 16 ? CC + 8 : CC;
  static constexpr int ROWS = M * R + 2, COLS = M * TW + 2;
  static constexpr int RO = (CT ? T : CC) + 8;
  static constexpr size_t kIn = (size_t)ROWS * COLS * CS * 2;
  static constexpr size_t kOut = (size_t)NC * (CT ? CC : T) * RO * 2;
  static_assert(TW * CC == kXfThreads, "one thread per (tile column, channel)");
};

// the block's image, first tile row and column, first channel. TC: channel
// blocks fastest in the grid, so the blocks that fill one V row run
// together; CT: tile columns fastest.
struct Place {
  int n, ty0, tx0, k0;
};
template <int M, bool CT>
__device__ __forceinline__ Place place(int ht) {
  using K = Xf<M, CT>;
  const int tyb = (ht + K::R - 1) / K::R;
  const int cb = CT ? blockIdx.z : blockIdx.x, xb = CT ? blockIdx.x : blockIdx.y;
  const int rb = CT ? blockIdx.y : blockIdx.z;
  return {rb / tyb, (rb % tyb) * K::R, xb * K::TW, cb * K::CC};
}

// ROWS x COLS pixels from (y0, x0), channels k0..k0+CC, of x (and o) into
// shared memory [pixel][CS] by cp.async, zero outside the image; MASKED then
// keeps x only where o > 0, once per element
template <int ROWS, int COLS, int CC, int CS, bool MASKED>
__device__ __forceinline__ void stage(bf16* xs, bf16* os, const bf16* __restrict__ x,
                                      const bf16* __restrict__ o, int n, int y0, int x0,
                                      int H, int W, int C, int k0) {
  constexpr int CHK = CC / 8;
  for (int e = threadIdx.x; e < ROWS * COLS * CHK; e += kXfThreads) {
    const int ch = e % CHK, pix = e / CHK;
    const int y = y0 + pix / COLS, xx = x0 + pix % COLS;
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    const size_t off = in ? (((size_t)n * H + y) * W + xx) * C + k0 + ch * 8 : 0;
    hopper::cp_async16(xs + pix * CS + ch * 8, x + off, in);
    if constexpr (MASKED) hopper::cp_async16(os + pix * CS + ch * 8, o + off, in);
  }
  hopper::cp_async_wait_all();
  __syncthreads();
  if constexpr (MASKED) {
    for (int e = threadIdx.x; e < ROWS * COLS * (CC / 2); e += kXfThreads) {
      const int pix = e / (CC / 2), q = e % (CC / 2);
      __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xs + pix * CS) + q;
      const float2 of =
          __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(os + pix * CS)[q]);
      const float2 xf = __bfloat1622float2(*xp);
      *xp = __floats2bfloat162_rn(of.x > 0.f ? xf.x : 0.f, of.y > 0.f ? xf.y : 0.f);
    }
    __syncthreads();
  }
}

// The transposed layout's tile index: tile rows padded to wt8, a multiple
// of 8 tiles (zeros in the padding), so every row starts 16-byte aligned.
__host__ __device__ __forceinline__ int pad8(int wt) { return (wt + 7) / 8 * 8; }

// the transposed output of a block, so[xi][cl][q*TW + txl], to
// v[xi][c0 + cl][(n*ht + ty)*wt8 + tx] (row stride ldt), 8 tiles per store
template <int M>
__device__ __forceinline__ void store_transposed(const bf16* so, bf16* __restrict__ v,
                                                 const Place& pl, int ht, int wt,
                                                 int c_total, long long ldt) {
  using K = Xf<M, true>;
  constexpr int R = K::R, TW = K::TW, CC = K::CC, P = TW / 8;
  const int wt8 = pad8(wt);
  for (int e = threadIdx.x; e < K::NC * CC * R * P; e += kXfThreads) {
    const int piece = e % P, q = (e / P) % R, cl = (e / (P * R)) % CC;
    const int xi = e / (P * R * CC);
    const int ty = pl.ty0 + q, tx = pl.tx0 + 8 * piece;
    if (ty >= ht || tx >= wt8) continue;
    *reinterpret_cast<uint4*>(v + ((size_t)xi * c_total + pl.k0 + cl) * ldt +
                              ((size_t)pl.n * ht + ty) * wt8 + tx) =
        *reinterpret_cast<const uint4*>(so + (xi * CC + cl) * K::RO + q * TW + 8 * piece);
  }
}

// V of the block's tiles and channels (module comment, pass 1). TC:
// v[xi][t][c] (tiles rows of C); CT: v[xi][c][t'] (C rows of ldt, t' the
// padded tile index of store_transposed).
template <int M, bool MASKED, bool CT>
__global__ void __launch_bounds__(kXfThreads)
winograd_input_kernel(const bf16* __restrict__ x,  // [N][H][W][C]
                      const bf16* __restrict__ o,  // x's shape (masked)
                      bf16* __restrict__ v, int H, int W, int C, long long tiles,
                      long long ldt) {
  using K = Xf<M, CT>;
  constexpr int A = K::A, R = K::R, TW = K::TW, CC = K::CC, CS = K::CS, RO = K::RO;
  constexpr int ROWS = K::ROWS, COLS = K::COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [ROWS][COLS][CS]
  bf16* os = xs + ROWS * COLS * CS;           // the same for o (masked)
  bf16* so = reinterpret_cast<bf16*>(smem + K::kIn * (MASKED ? 2 : 1));
  const int ht = H / M, wt = W / M;
  const Place pl = place<M, CT>(ht);
  // every input element the block needs, once
  stage<ROWS, COLS, CC, CS, MASKED>(xs, os, x, o, pl.n, M * pl.ty0 - 1, M * pl.tx0 - 1, H, W,
                                    C, pl.k0);

  const int cl = threadIdx.x % CC, txl = threadIdx.x / CC;
  float vv[R][A * A];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int k = 0; k < A * A; ++k) vv[q][k] = 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    // the width transform of staged row r at this tile column, once
    float d[A], tw[A];
#pragma unroll
    for (int s = 0; s < A; ++s) d[s] = __bfloat162float(xs[(r * COLS + M * txl + s) * CS + cl]);
#pragma unroll
    for (int j = 0; j < A; ++j) {
      tw[j] = 0.f;
#pragma unroll
      for (int s = 0; s < A; ++s) cadd(tw[j], bt<M>(j, s), d[s]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {  // the tile rows whose patch holds row r
      const int ri = r - M * q;
      if (ri < 0 || ri >= A) continue;
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < A; ++j) cadd(vv[q][i * A + j], bt<M>(i, ri), tw[j]);
      if (ri != A - 1) continue;
      // tile row q is complete (a padding tile of the transposed layout,
      // past the last tile column, is zero)
      const bool real = pl.tx0 + txl < wt;
#pragma unroll
      for (int xi = 0; xi < A * A; ++xi)
        so[CT ? (xi * CC + cl) * RO + q * TW + txl : (xi * K::T + q * TW + txl) * RO + cl] =
            __float2bfloat16_rn(real ? vv[q][xi] : 0.f);
    }
  }
  __syncthreads();
  if constexpr (CT) {
    store_transposed<M>(so, v, pl, ht, wt, C, ldt);
  } else {  // each (coordinate, tile): CC channels in CC / 8 stores
    constexpr int P = CC / 8;
    for (int e = threadIdx.x; e < K::NC * K::T * P; e += kXfThreads) {
      const int piece = e % P, tl = (e / P) % K::T, xi = e / (P * K::T);
      const int ty = pl.ty0 + tl / TW, tx = pl.tx0 + tl % TW;
      if (ty >= ht || tx >= wt) continue;
      const size_t t = ((size_t)pl.n * ht + ty) * wt + tx;
      *reinterpret_cast<uint4*>(v + ((size_t)xi * tiles + t) * C + pl.k0 + 8 * piece) =
          *reinterpret_cast<const uint4*>(so + (xi * K::T + tl) * RO + 8 * piece);
    }
  }
}

// the dM kernel's staged cotangent: the block's m*R x m*TW output pixels
template <int M>
struct Dm {
  using K = Xf<M, true>;
  static constexpr int ROWS = M * K::R, COLS = M * K::TW;
  static constexpr size_t kIn = (size_t)ROWS * COLS * K::CS * 2;
};

// dM [a^2][Co][ldt] of the cotangent g (masked by o > 0; tiles by the
// padded index of store_transposed) and the block's partial db,
// db_part[block][Co]. Each g element is staged once.
template <int M, bool MASKED>
__global__ void __launch_bounds__(kXfThreads)
winograd_dm_kernel(const bf16* __restrict__ g,  // [N][H][W][Co]
                   const bf16* __restrict__ o,  // g's shape (masked)
                   bf16* __restrict__ dm, float* __restrict__ db_part, int H, int W,
                   int Co, long long ldt) {
  using K = Xf<M, true>;
  constexpr int A = K::A, R = K::R, TW = K::TW, CC = K::CC, CS = K::CS;
  constexpr int ROWS = Dm<M>::ROWS, COLS = Dm<M>::COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem);  // [ROWS][COLS][CS]
  bf16* os = gs + ROWS * COLS * CS;
  bf16* so = reinterpret_cast<bf16*>(smem + Dm<M>::kIn * (MASKED ? 2 : 1));  // [NC][CC][RO]
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(so) + K::kOut);
  const int ht = H / M, wt = W / M;
  const Place pl = place<M, true>(ht);
  // zeros outside the image: a tile past the edge has dz = 0
  stage<ROWS, COLS, CC, CS, MASKED>(gs, os, g, o, pl.n, M * pl.ty0, M * pl.tx0, H, W, Co,
                                    pl.k0);
  const int cl = threadIdx.x % CC, txl = threadIdx.x / CC;

  float dbacc = 0.f;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    float dz[M][M];
#pragma unroll
    for (int p = 0; p < M; ++p)
#pragma unroll
      for (int l = 0; l < M; ++l) {
        dz[p][l] = __bfloat162float(gs[((M * q + p) * COLS + M * txl + l) * CS + cl]);
        dbacc += dz[p][l];
      }
    float dmw[M][A];  // dmw[p][j] = sum_l AT[l,j] dz[p,l]
#pragma unroll
    for (int p = 0; p < M; ++p)
#pragma unroll
      for (int j = 0; j < A; ++j) {
        dmw[p][j] = 0.f;
#pragma unroll
        for (int l = 0; l < M; ++l) cadd(dmw[p][j], at<M>(l, j), dz[p][l]);
      }
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int j = 0; j < A; ++j) {
        float d = 0.f;
#pragma unroll
        for (int p = 0; p < M; ++p) cadd(d, at<M>(p, i), dmw[p][j]);
        so[((i * A + j) * CC + cl) * K::RO + q * TW + txl] = __float2bfloat16_rn(d);
      }
  }
  red[cl * TW + txl] = dbacc;
  __syncthreads();
  if (threadIdx.x < CC) {  // this block's db, its tile columns in order
    float s = 0.f;
    for (int k = 0; k < TW; ++k) s += red[threadIdx.x * TW + k];
    db_part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * Co + pl.k0 + threadIdx.x] = s;
  }
  store_transposed<M>(so, dm, pl, ht, wt, Co, ldt);
}

// ---------------------------------------------------------------------------
// pass 2: the products on wgmma
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 288;  // consumer warpgroups 0-1, producer warp 8
constexpr int kConsumers = 256;
// the forward: consumer warpgroups 0-1 and a producer warpgroup (one of
// its threads issues the loads); the producer gives its registers to the
// consumers (setmaxnreg), 168 at launch -> 40 and 232
constexpr int kFwdThreads = 384;
constexpr int kBK = 64;            // K per stage: one 128-byte swizzle row

// the forward's block: 64 tiles x BN output channels, BN_WG per warpgroup
template <int M>
struct Fwd {
  static constexpr int A = M + 2, NC = A * A;
  // 1 + m + m^2 accumulators of BN_WG / 2 registers each: 112 (f2), 168 (f4)
  static constexpr int BN_WG = M == 2 ? 32 : 16;
  static constexpr int BN = 2 * BN_WG;
  static constexpr int S = 6;
  static constexpr int A_BYTES = 64 * kBK * 2, B_BYTES = BN * kBK * 2;
  static constexpr size_t SMEM = 1024 + (size_t)S * (A_BYTES + B_BYTES) + 2 * S * 8;
};

// the output transform of coordinate xi = a*i + j, in the TPU kernel's
// order: M[i,j] into m_acc over j; after the row's last j, m_acc into y_acc
template <int M, int NR>
__device__ __forceinline__ void fold(int xi, const float (&acc)[NR], float (&macc)[M][NR],
                                     float (&y)[M][M][NR]) {
  constexpr int A = M + 2;
  const int i = xi / A, j = xi % A;
#pragma unroll
  for (int l = 0; l < M; ++l)
#pragma unroll
    for (int r = 0; r < NR; ++r) cadd(macc[l][r], at<M>(l, j), acc[r]);
  if (j != A - 1) return;
#pragma unroll
  for (int l = 0; l < M; ++l)
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int p = 0; p < M; ++p) cadd(y[p][l][r], at<M>(p, i), macc[l][r]);
      macc[l][r] = 0.f;
    }
}

// out = epi(output transform of V U) for 64 tiles x BN output channels:
// tv maps V [a^2][tiles][C], tu maps U^T [a^2][Co][C]
template <int M, bool BIAS_RELU>
__global__ void __launch_bounds__(kFwdThreads, 1)
winograd_fwd_gemm_kernel(const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tu,
                         const bf16* __restrict__ b,  // [Co] (bias_relu)
                         bf16* __restrict__ out,      // [N][H][W][Co]
                         int n_img, int H, int W, int C, int Co) {
  using K = Fwd<M>;
  constexpr int NC = K::NC, S = K::S, BN_WG = K::BN_WG, NR = BN_WG / 2;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (hopper::smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t a_sm = base, b_sm = base + S * K::A_BYTES;
  const uint32_t full = b_sm + S * K::B_BYTES, empty = full + 8 * S;
  const int KC = (C + kBK - 1) / kBK, total = NC * KC;
  const int t0 = blockIdx.y * 64, co0 = blockIdx.x * K::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer: coordinates in order, K chunks inner
    hopper::setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      for (int it = 0; it < total; ++it) {
        const int s = it % S;
        hopper::mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
        hopper::mbar_expect_tx(full + 8 * s, K::A_BYTES + K::B_BYTES);
        const int xi = it / KC, kc = it - xi * KC;
        hopper::tma_load_3d(a_sm + s * K::A_BYTES, &tv, full + 8 * s, kc * kBK, t0, xi);
        hopper::tma_load_3d(b_sm + s * K::B_BYTES, &tu, full + 8 * s, kc * kBK, co0, xi);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int wg = warp >> 2, wl = warp & 3;
  const uint32_t b_wg = b_sm + wg * BN_WG * kBK * 2;
  // two accumulators in turn: coordinate xi's products run while xi - 1's
  // are folded
  float acc[2][NR], macc[M][NR], y[M][M][NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    acc[0][r] = acc[1][r] = 0.f;
#pragma unroll
    for (int l = 0; l < M; ++l) {
      macc[l][r] = 0.f;
#pragma unroll
      for (int p = 0; p < M; ++p) y[p][l][r] = 0.f;
    }
  }
  int it = 0, prev = -1;
#pragma unroll
  for (int xi = 0; xi < NC; ++xi) {
    // M[i,j] (xi = a*i + j) for the block, over all of C
    for (int kc = 0; kc < KC; ++kc, ++it) {
      const int s = it % S;
      hopper::mbar_wait(full + 8 * s, (it / S) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        hopper::Wgmma<BN_WG>::run(acc[xi & 1],
                                  hopper::desc_sw128(a_sm + s * K::A_BYTES + 32 * k),
                                  hopper::desc_sw128(b_wg + s * K::B_BYTES + 32 * k),
                                  (kc | k) != 0);
      hopper::wgmma_commit();
      if (prev >= 0) {  // all but this chunk's products are done: free the last
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      if (xi > 0 && kc == 0) {  // M of coordinate xi - 1 is complete
        hopper::fence_regs(acc[(xi - 1) & 1]);
        fold<M>(xi - 1, acc[(xi - 1) & 1], macc, y);
      }
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc[(NC - 1) & 1]);
  hopper::mbar_arrive(empty + 8 * prev);
  fold<M>(NC - 1, acc[(NC - 1) & 1], macc, y);

  // epilogue from the fragments: register r of this thread is tile
  // t0 + 16*wl + lane/4 + 8*((r/2) % 2), channel 8*(r/4) + 2*(lane%4) + r%2
  const int ht = H / M, wt = W / M;
  const long long tiles = (long long)n_img * ht * wt;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long t = t0 + 16 * wl + (lane >> 2) + 8 * h;
    if (t >= tiles) continue;
    const int tx = (int)(t % wt), ty = (int)((t / wt) % ht), n = (int)(t / ((long long)wt * ht));
#pragma unroll
    for (int nb = 0; nb < NR / 4; ++nb) {
      const int co = co0 + wg * BN_WG + 8 * nb + 2 * (lane & 3);
      if (co >= Co) continue;
      float b0 = 0.f, b1 = 0.f;
      if constexpr (BIAS_RELU) {
        b0 = __bfloat162float(b[co]);
        b1 = __bfloat162float(b[co + 1]);
      }
#pragma unroll
      for (int p = 0; p < M; ++p)
#pragma unroll
        for (int l = 0; l < M; ++l) {
          float v0 = y[p][l][nb * 4 + 2 * h], v1 = y[p][l][nb * 4 + 2 * h + 1];
          if constexpr (BIAS_RELU) {
            v0 = fmaxf(__fadd_rn(v0, b0), 0.f);
            v1 = fmaxf(__fadd_rn(v1, b1), 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              out + (((size_t)n * H + M * ty + p) * W + M * tx + l) * Co + co) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
  }
}

// the wgrad's block: 128 input channels (64 per warpgroup) x 128 output
// channels of one coordinate, over one part of the tiles
struct Wg {
  static constexpr int S = 4, BM = 128, BN = 128;
  static constexpr int A_BYTES = BM * kBK * 2, B_BYTES = BN * kBK * 2;
  static constexpr size_t SMEM = 1024 + (size_t)S * (A_BYTES + B_BYTES) + 2 * S * 8;
};

// du_part[part][xi][c][co] = sum over the part's tiles of V^T dM: tv maps
// V^T [a^2][C][tiles], tg maps dM^T [a^2][Co][tiles]; blockIdx.z = part *
// nc + xi; a part is K chunks [part * per_part, +per_part) of `chunks`
__global__ void __launch_bounds__(kGemmThreads, 1)
winograd_wgrad_gemm_kernel(const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg,
                           float* __restrict__ du_part, int C, int Co, int nc, int chunks,
                           int per_part) {
  constexpr int S = Wg::S;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (hopper::smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t a_sm = base, b_sm = base + S * Wg::A_BYTES;
  const uint32_t full = b_sm + S * Wg::B_BYTES, empty = full + 8 * S;
  const int xi = blockIdx.z % nc, part = blockIdx.z / nc;
  const int kc0 = part * per_part;
  const int nk = min(chunks, kc0 + per_part) - kc0;  // >= 1 (wgrad_parts)
  const int c0 = blockIdx.y * Wg::BM, co0 = blockIdx.x * Wg::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % S;
        hopper::mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
        hopper::mbar_expect_tx(full + 8 * s, Wg::A_BYTES + Wg::B_BYTES);
        const int k = (kc0 + it) * kBK;
        hopper::tma_load_3d(a_sm + s * Wg::A_BYTES, &tv, full + 8 * s, k, c0, xi);
        hopper::tma_load_3d(b_sm + s * Wg::B_BYTES, &tg, full + 8 * s, k, co0, xi);
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3;
  const uint32_t a_wg = a_sm + wg * 64 * kBK * 2;
  float acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.f;
  int prev = -1;
  for (int it = 0; it < nk; ++it) {
    const int s = it % S;
    hopper::mbar_wait(full + 8 * s, (it / S) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)
      hopper::wgmma_n128(acc, hopper::desc_sw128(a_wg + s * Wg::A_BYTES + 32 * k),
                         hopper::desc_sw128(b_sm + s * Wg::B_BYTES + 32 * k), (it | k) != 0);
    hopper::wgmma_commit();
    if (prev >= 0) {
      hopper::wgmma_wait<1>();
      hopper::mbar_arrive(empty + 8 * prev);
    }
    prev = s;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::mbar_arrive(empty + 8 * prev);

  float* dst = du_part + ((size_t)part * nc + xi) * C * Co;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + wg * 64 + 16 * wl + (lane >> 2) + 8 * h;
    if (c >= C) continue;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      const int co = co0 + 8 * nb + 2 * (lane & 3);
      if (co < Co)
        *reinterpret_cast<float2*>(dst + (size_t)c * Co + co) =
            make_float2(acc[nb * 4 + 2 * h], acc[nb * 4 + 2 * h + 1]);
    }
  }
}

// du[e] = sum of the parts in order, one thread per element
__global__ void winograd_du_sum_kernel(const float* __restrict__ du_part,
                                       float* __restrict__ du, int parts, long long n_du) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_du) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += du_part[(size_t)p * n_du + e];
  du[e] = s;
}

// db[co] = sum of the blocks' partials: 8 warps take every 8th block in
// order, then their sums are added in warp order
__global__ void __launch_bounds__(256)
winograd_db_sum_kernel(const float* __restrict__ db_part, float* __restrict__ db,
                       int blocks, int Co) {
  __shared__ float red[8][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int co = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (co < Co)
    for (int k = w; k < blocks; k += 8) s += db_part[(size_t)k * Co + co];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && co < Co) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += red[k][lane];
    db[co] = t;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

long long tiles_of(int n, int h, int w, int m) { return (long long)n * (h / m) * (w / m); }
// the K extent of the wgrad: the transposed layout's padded tile count
long long padded_tiles(int n, int h, int w, int m) {
  return (long long)n * (h / m) * pad8(w / m);
}

// the transform blocks' grid (see place): CT (tile columns, images x tile
// rows, channels), TC (channels, tile columns, images x tile rows)
template <int M, bool CT>
dim3 xf_grid(int n, int h, int w, int c) {
  using K = Xf<M, CT>;
  const unsigned cb = c / K::CC, xb = (w / M + K::TW - 1) / K::TW;
  const unsigned rb = n * ((h / M + K::R - 1) / K::R);
  return CT ? dim3(xb, rb, cb) : dim3(cb, xb, rb);
}

template <int M, bool MASKED, bool CT>
cudaError_t launch_input(const void* x, const void* o, void* v, int n, int h, int w, int c,
                         long long ldt, cudaStream_t s) {
  using K = Xf<M, CT>;
  auto kernel = winograd_input_kernel<M, MASKED, CT>;
  const size_t smem = K::kIn * (MASKED ? 2 : 1) + K::kOut;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<xf_grid<M, CT>(n, h, w, c), kXfThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o), static_cast<bf16*>(v), h, w,
      c, tiles_of(n, h, w, M), ldt);
  return cudaGetLastError();
}

template <int M, bool MASKED, bool BIAS_RELU>
cudaError_t launch_fwd(const void* x, const void* ut, const void* b, const void* o, void* v,
                       void* out, int n, int h, int w, int c, int co, cudaStream_t s) {
  using K = Fwd<M>;
  cudaError_t err = launch_input<M, MASKED, false>(x, o, v, n, h, w, c, 0, s);
  if (err != cudaSuccess) return err;
  const long long tiles = tiles_of(n, h, w, M);
  CUtensorMap tv, tu;
  if ((err = hopper::make_map(&tv, v, c, tiles, K::NC, c, tiles * c, 64)) != cudaSuccess ||
      (err = hopper::make_map(&tu, ut, c, co, K::NC, c, (long long)co * c, K::BN)) !=
          cudaSuccess)
    return err;
  auto kernel = winograd_fwd_gemm_kernel<M, BIAS_RELU>;
  if ((err = prepare(kernel, K::SMEM)) != cudaSuccess) return err;
  const dim3 grid((unsigned)((co + K::BN - 1) / K::BN), (unsigned)((tiles + 63) / 64));
  kernel<<<grid, kFwdThreads, K::SMEM, s>>>(tv, tu, static_cast<const bf16*>(b),
                                              static_cast<bf16*>(out), n, h, w, c, co);
  return cudaGetLastError();
}

// the wgrad's scratch: parts (none empty), db blocks, padded tile count
template <int M>
cudaError_t wgrad_scratch(int n, int h, int w, int c, int co, long long* sizes) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  constexpr int NC = (M + 2) * (M + 2);
  const long long chunks = (padded_tiles(n, h, w, M) + kBK - 1) / kBK;
  const long long per_part =
      (long long)((c + Wg::BM - 1) / Wg::BM) * ((co + Wg::BN - 1) / Wg::BN) * NC;
  // at least a wave of blocks, in whole waves where that costs few parts:
  // the smallest k (1..8) whose ceil(k * sms / per_part) parts fill their
  // last wave to 90 %
  long long p = 0;
  for (int k = 1; k <= 8 && p == 0; ++k) {
    const long long q = (k * (long long)sms + per_part - 1) / per_part;
    const long long waves = (q * per_part + sms - 1) / sms;
    if (q * per_part * 10 >= waves * sms * 9) p = q;
  }
  if (p == 0) p = (2ll * sms + per_part - 1) / per_part;
  // the partials' scratch stays under 512 MiB
  const long long cap = (512ll << 20) / ((long long)NC * c * co * 4);
  if (p > cap) p = cap;
  if (p > chunks) p = chunks;
  if (p < 1) p = 1;
  const long long per = (chunks + p - 1) / p;
  const dim3 g = xf_grid<M, true>(n, h, w, co);
  sizes[0] = (chunks + per - 1) / per;
  sizes[1] = (long long)g.x * g.y;
  sizes[2] = padded_tiles(n, h, w, M);
  return cudaSuccess;
}

template <int M, bool MASKED>
cudaError_t launch_wgrad(const void* x, const void* g, const void* o, void* vt, void* dmt,
                         void* du_part, void* db_part, int parts, void* du, void* db, int n,
                         int h, int w, int c, int co, cudaStream_t s) {
  using K = Xf<M, true>;
  const long long ldt = padded_tiles(n, h, w, M);
  cudaError_t err = launch_input<M, false, true>(x, nullptr, vt, n, h, w, c, ldt, s);
  if (err != cudaSuccess) return err;
  auto dm_kernel = winograd_dm_kernel<M, MASKED>;
  const size_t dm_smem = Dm<M>::kIn * (MASKED ? 2 : 1) + K::kOut + (size_t)K::CC * K::TW * 4;
  if ((err = prepare(dm_kernel, dm_smem)) != cudaSuccess) return err;
  const dim3 dgrid = xf_grid<M, true>(n, h, w, co);
  dm_kernel<<<dgrid, kXfThreads, dm_smem, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), static_cast<bf16*>(dmt),
      static_cast<float*>(db_part), h, w, co, ldt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  CUtensorMap tv, tg;
  if ((err = hopper::make_map(&tv, vt, ldt, c, K::NC, ldt, (long long)c * ldt, Wg::BM)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tg, dmt, ldt, co, K::NC, ldt, (long long)co * ldt, Wg::BN)) !=
          cudaSuccess)
    return err;
  const int chunks = (int)((ldt + kBK - 1) / kBK);
  const int per_part = (chunks + parts - 1) / parts;
  if ((long long)(parts - 1) * per_part >= chunks) return cudaErrorInvalidValue;  // an empty part
  auto kernel = winograd_wgrad_gemm_kernel;
  if ((err = prepare(kernel, Wg::SMEM)) != cudaSuccess) return err;
  const dim3 grid((unsigned)((co + Wg::BN - 1) / Wg::BN), (unsigned)((c + Wg::BM - 1) / Wg::BM),
                  (unsigned)(K::NC * parts));
  kernel<<<grid, kGemmThreads, Wg::SMEM, s>>>(tv, tg, static_cast<float*>(du_part), c, co,
                                               K::NC, chunks, per_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n_du = (long long)K::NC * c * co;
  winograd_du_sum_kernel<<<(unsigned)((n_du + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), parts, n_du);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  winograd_db_sum_kernel<<<(unsigned)((co + 31) / 32), 256, 0, s>>>(
      static_cast<const float*>(db_part), static_cast<float*>(db), (int)(dgrid.x * dgrid.y),
      co);
  return cudaGetLastError();
}

bool shape_ok(int n, int h, int w, int c, int co, int m) {
  if (!((m == 2 || m == 4) && n >= 1 && h >= m && w >= m && h % m == 0 && w % m == 0 &&
        c > 0 && co > 0 && c % 32 == 0 && co % 32 == 0))
    return false;
  // grid limits: the transform's images x tile-row blocks, the forward's
  // 64-tile blocks
  const long long tile_rows = (long long)n * ((h / m + 1) / 2);
  return tile_rows <= 65535 && (tiles_of(n, h, w, m) + 63) / 64 <= 65535;
}

}  // namespace

// C entry, the forward. Device pointers, 16-byte aligned: x [N][H][W][C] bf16
// (in masked mode the cotangent), ut = U transposed [a*a][Co][C] bf16, b [Co]
// bf16 (read when bias_relu is 1), o [N][H][W][C] bf16 or null (non-null:
// masked mode), v scratch [a*a][N*(H/m)*(W/m)][C] bf16, out [N][H][W][Co]
// bf16. m = 2 or 4; H, W multiples of m; C, Co multiples of 32. Returns a
// cudaError_t.
extern "C" int seg_winograd_fwd(const void* x, const void* ut, const void* b,
                                const void* o, void* v, void* out, int n, int h, int w,
                                int c, int co, int m, int bias_relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(n, h, w, c, co, m) || (bias_relu && b == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool masked = o != nullptr;
#define SEG_WFWD(MM, MK, BR)                                                   \
  if (m == MM && masked == MK && (bias_relu != 0) == BR)                       \
  return (int)launch_fwd<MM, MK, BR>(x, ut, b, o, v, out, n, h, w, c, co, s)
  SEG_WFWD(2, false, false);
  SEG_WFWD(2, false, true);
  SEG_WFWD(2, true, false);
  SEG_WFWD(2, true, true);
  SEG_WFWD(4, false, false);
  SEG_WFWD(4, false, true);
  SEG_WFWD(4, true, false);
  SEG_WFWD(4, true, true);
#undef SEG_WFWD
  return (int)cudaErrorInvalidValue;
}

// The wgrad's scratch for this shape, into sizes[3]: parts, db blocks and
// T8 = N*(H/m)*wt8 (tile rows padded to wt8, a multiple of 8 tiles). The
// caller allocates vt [a*a][C][T8] and dmt [a*a][Co][T8] bf16, du_part [parts][a*a][C][Co] and db_part [db blocks][Co]
// f32, and passes parts to seg_winograd_wgrad. Returns a cudaError_t.
extern "C" int seg_winograd_wgrad_scratch(int n, int h, int w, int c, int co, int m,
                                          long long* sizes) {
  if (!shape_ok(n, h, w, c, co, m)) return (int)cudaErrorInvalidValue;
  return (int)(m == 2 ? wgrad_scratch<2>(n, h, w, c, co, sizes)
                      : wgrad_scratch<4>(n, h, w, c, co, sizes));
}

// C entry, the weight gradient. x [N][H][W][C], g [N][H][W][Co] bf16, o g's
// shape or null (non-null: dz = g * (o > 0)); outputs du [a*a][C][Co] and db
// [Co] f32; scratch vt, dmt, du_part, db_part as seg_winograd_wgrad_scratch
// says. Returns a cudaError_t.
extern "C" int seg_winograd_wgrad(const void* x, const void* g, const void* o, void* vt,
                                  void* dmt, void* du_part, void* db_part, int parts,
                                  void* du, void* db, int n, int h, int w, int c, int co,
                                  int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(n, h, w, c, co, m) || parts < 1) return (int)cudaErrorInvalidValue;
  const bool masked = o != nullptr;
#define SEG_WWG(MM, MK)                                                                 \
  if (m == MM && masked == MK)                                                          \
  return (int)launch_wgrad<MM, MK>(x, g, o, vt, dmt, du_part, db_part, parts, du, db, n, h, \
                                   w, c, co, s)
  SEG_WWG(2, false);
  SEG_WWG(2, true);
  SEG_WWG(4, false);
  SEG_WWG(4, true);
#undef SEG_WWG
  return (int)cudaErrorInvalidValue;
}
