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
//   forward  out[n, m*ty+p, m*tx+l, co] = epi( sum_{i,j} AT[p,i] AT[l,j]
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
// the plain version's (ops/cuda/winograd.py).
//
// What bounds it on the H100: the products, 2*a^2*tiles*C*Co FLOP per call
// (2.25x / 4x fewer than the direct conv), against the bytes of x, out and U.
// Design, simple first: a block takes T output tiles (forward) or T input
// channels (wgrad) x 32 output channels, walks the 32-deep K dimension in
// chunks, builds V (and dM) for the chunk in f32 and stores them in bf16 in
// shared memory, and runs the products with mma.sync (stage1_mma.cuh). The
// a^2 Winograd coordinates are split across the warps (CPW each), so a warp
// reuses each operand fragment over 8 products. The forward then parks M in
// shared memory (f32) and transforms it back, epilogue included, one thread
// per (tile, output channel). The wgrad keeps its partial dU in registers
// over all the chunks it walks, writes it once per block, and a second
// launch sums the partials in a fixed order: no float atomics, two runs are
// bit-identical. Each block rebuilds V for its own output-channel tile (the
// transform is repeated Co/32 times); wgmma, TMA and sharing V are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_mma.cuh"

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

constexpr int kBN = 32;   // output channels per block
constexpr int kKC = 32;   // K per chunk (forward: input channels; wgrad: tiles)
constexpr int kPad = 8;   // bf16 per shared-memory row, against bank conflicts
constexpr int kRowK = kKC + kPad;
constexpr int kRowN = kBN + kPad;

template <int M>
struct Cfg {
  static constexpr int A = M + 2;
  static constexpr int NC = A * A;            // Winograd coordinates
  static constexpr int T = M == 2 ? 32 : 16;  // GEMM rows per block
  static constexpr int CPW = M == 2 ? 2 : 3;  // coordinates per warp
  static constexpr int WARPS = NC / CPW;      // 8 or 12
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int CH = M == 2 ? 2 : 1;   // channels per staging item
  static constexpr int MT = T / 16;           // m16 fragments per warp
  static constexpr int NT = kBN / 8;          // n8 fragments per warp
  // f2's forward fits two blocks per SM in shared memory; ask the
  // compiler for registers to match (the masked form took 155 unbounded)
  static constexpr int kFwdBlocksPerSm = M == 2 ? 2 : 1;
  static_assert(NC % CPW == 0, "coordinates split evenly over the warps");
  // forward: V [NC][T][kRowK] + U [NC][kBN][kRowK] bf16, then M [NC][T][kRowN] f32
  static constexpr size_t kFwdSmem =
      (size_t)NC * (T + kBN) * kRowK * 2 > (size_t)NC * T * kRowN * 4
          ? (size_t)NC * (T + kBN) * kRowK * 2
          : (size_t)NC * T * kRowN * 4;
  // wgrad: V [NC][kKC][T + kPad] + dM [NC][kKC][kRowN] bf16, db [THREADS][CH] f32
  static constexpr int kRowV = T + kPad;
  static constexpr size_t kWgradSmem =
      (size_t)NC * kKC * (kRowV + kRowN) * 2 + (size_t)THREADS * CH * 4;
};

template <int CH>
__device__ __forceinline__ void load_ch(const bf16* p, float (&v)[CH]) {
  if constexpr (CH == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int CH>
__device__ __forceinline__ void store_ch(bf16* p, const float (&v)[CH]) {
  if constexpr (CH == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  else
    *p = __float2bfloat16_rn(v[0]);
}

// V = B^T d B for one tile and CH channels from c, into vs + xi*stride as bf16:
// the patch rows r = 0..a-1 at y0 + r, columns x0..x0+a-1; zero outside the
// image; in MASKED mode d = x where o > 0, else 0. Row by row: the width
// transform of the row, then its share of every V[i][j].
template <int M, int CH, bool MASKED>
__device__ __forceinline__ void input_transform(const bf16* __restrict__ x,
                                                const bf16* __restrict__ o,
                                                bool valid, int n, int y0, int x0,
                                                int H, int W, int C, int c,
                                                bf16* vs, int stride) {
  constexpr int A = M + 2;
  float v[A * A][CH];
#pragma unroll
  for (int k = 0; k < A * A; ++k)
#pragma unroll
    for (int q = 0; q < CH; ++q) v[k][q] = 0.f;
#pragma unroll
  for (int r = 0; r < A; ++r) {
    const int y = y0 + r;
    float d[A][CH];
#pragma unroll
    for (int s = 0; s < A; ++s) {
      const int xx = x0 + s;
#pragma unroll
      for (int q = 0; q < CH; ++q) d[s][q] = 0.f;
      if (valid && y >= 0 && y < H && xx >= 0 && xx < W) {
        const size_t off = (((size_t)n * H + y) * W + xx) * C + c;
        load_ch<CH>(x + off, d[s]);
        if constexpr (MASKED) {
          float ov[CH];
          load_ch<CH>(o + off, ov);
#pragma unroll
          for (int q = 0; q < CH; ++q) d[s][q] = ov[q] > 0.f ? d[s][q] : 0.f;
        }
      }
    }
    float tw[A][CH];
#pragma unroll
    for (int j = 0; j < A; ++j)
#pragma unroll
      for (int q = 0; q < CH; ++q) {
        tw[j][q] = 0.f;
#pragma unroll
        for (int s = 0; s < A; ++s) cadd(tw[j][q], bt<M>(j, s), d[s][q]);
      }
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int j = 0; j < A; ++j)
#pragma unroll
        for (int q = 0; q < CH; ++q) cadd(v[i * A + j][q], bt<M>(i, r), tw[j][q]);
  }
#pragma unroll
  for (int k = 0; k < A * A; ++k) store_ch<CH>(vs + (size_t)k * stride, v[k]);
}

// ---------------------------------------------------------------------------
// forward (and the masked input gradient)
// ---------------------------------------------------------------------------

template <int M, bool MASKED, bool BIAS_RELU>
__global__ void __launch_bounds__(Cfg<M>::THREADS, Cfg<M>::kFwdBlocksPerSm)
winograd_fwd_kernel(const bf16* __restrict__ x,    // [N][H][W][C]
                    const bf16* __restrict__ ut,   // [NC][Co][C]
                    const bf16* __restrict__ b,    // [Co] (bias_relu)
                    const bf16* __restrict__ o,    // [N][H][W][C] (masked)
                    bf16* __restrict__ out,        // [N][H][W][Co]
                    int n_img, int H, int W, int C, int Co) {
  using K = Cfg<M>;
  constexpr int A = K::A, NC = K::NC, T = K::T, CPW = K::CPW, CH = K::CH;
  constexpr int MT = K::MT, NT = K::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* vs = reinterpret_cast<bf16*>(smem);       // [NC][T][kRowK]
  bf16* us = vs + (size_t)NC * T * kRowK;          // [NC][kBN][kRowK]
  float* ms = reinterpret_cast<float*>(smem);      // [NC][T][kRowN], after the K loop

  const int wt = W / M, ht = H / M;
  const long long total = (long long)n_img * ht * wt;
  const long long t0 = (long long)blockIdx.x * T;
  const int co0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_pix = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;

  float acc[CPW][MT][NT][4];
#pragma unroll
  for (int q = 0; q < CPW; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][j][e] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    __syncthreads();  // the previous chunk is no longer read
    constexpr int G = kKC / CH;  // channel groups per tile
    for (int e = threadIdx.x; e < T * G; e += K::THREADS) {
      const int cg = e % G, tl = e / G;
      const long long t = t0 + tl;
      const bool valid = t < total;
      const int tx = (int)(t % wt), ty = (int)((t / wt) % ht), n = (int)(t / ((long long)wt * ht));
      input_transform<M, CH, MASKED>(x, o, valid, n, ty * M - 1, tx * M - 1, H, W, C,
                                     k0 + cg * CH, vs + tl * kRowK + cg * CH, T * kRowK);
    }
    for (int e = threadIdx.x; e < NC * kBN * (kKC / 8); e += K::THREADS) {
      const int ch = e % (kKC / 8), row = e / (kKC / 8);  // row = xi * kBN + nn
      const int xi = row / kBN, nn = row % kBN;
      *reinterpret_cast<uint4*>(us + row * kRowK + ch * 8) =
          *reinterpret_cast<const uint4*>(ut + ((size_t)xi * Co + co0 + nn) * C + k0 + ch * 8);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const int xi = warp * CPW + q;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          stage1::ldsm_x4(a[mt], vs + ((xi * T + mt * 16 + a_pix) * kRowK + ks * 16 + a_k));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bb[4];
          stage1::ldsm_x4(bb, us + ((xi * kBN + j * 8 + b_n) * kRowK + ks * 16 + b_k));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            stage1::mma_bf16(acc[q][mt][j], a[mt], bb[0], bb[1]);
            stage1::mma_bf16(acc[q][mt][j + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }
  }

  __syncthreads();  // V and U are no longer read: M takes their place
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int xi = warp * CPW + q;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + (lane >> 2) + 8 * h, col = j * 8 + 2 * (lane & 3);
          *reinterpret_cast<float2*>(ms + (xi * T + row) * kRowN + col) =
              make_float2(acc[q][mt][j][2 * h], acc[q][mt][j][2 * h + 1]);
        }
  }
  __syncthreads();

  // output transform and epilogue, one thread per (tile, output channel)
  for (int e = threadIdx.x; e < T * kBN; e += K::THREADS) {
    const int nn = e % kBN, tl = e / kBN;
    const long long t = t0 + tl;
    if (t >= total) continue;
    const int tx = (int)(t % wt), ty = (int)((t / wt) % ht), n = (int)(t / ((long long)wt * ht));
    float macc[A][M];  // macc[i][l] = sum_j AT[l,j] M[i,j]
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int l = 0; l < M; ++l) {
        macc[i][l] = 0.f;
#pragma unroll
        for (int j = 0; j < A; ++j)
          cadd(macc[i][l], at<M>(l, j), ms[((i * A + j) * T + tl) * kRowN + nn]);
      }
    const int co = co0 + nn;
    const float bias = BIAS_RELU ? __bfloat162float(b[co]) : 0.f;
#pragma unroll
    for (int p = 0; p < M; ++p)
#pragma unroll
      for (int l = 0; l < M; ++l) {
        float y = 0.f;
#pragma unroll
        for (int i = 0; i < A; ++i) cadd(y, at<M>(p, i), macc[i][l]);
        if constexpr (BIAS_RELU) y = fmaxf(__fadd_rn(y, bias), 0.f);
        out[(((size_t)n * H + ty * M + p) * W + tx * M + l) * Co + co] = __float2bfloat16_rn(y);
      }
  }
}

// ---------------------------------------------------------------------------
// weight gradient: per-block partials of dU and db
// ---------------------------------------------------------------------------

template <int M, bool MASKED>
__global__ void __launch_bounds__(Cfg<M>::THREADS)
winograd_wgrad_kernel(const bf16* __restrict__ x,  // [N][H][W][C]
                      const bf16* __restrict__ g,  // [N][H][W][Co]
                      const bf16* __restrict__ o,  // [N][H][W][Co] (masked)
                      float* __restrict__ du_part,  // [parts][NC][C][Co]
                      float* __restrict__ db_part,  // [parts][Co]
                      int n_img, int H, int W, int C, int Co) {
  using K = Cfg<M>;
  constexpr int A = K::A, NC = K::NC, T = K::T, CPW = K::CPW, CH = K::CH;
  constexpr int MT = K::MT, NT = K::NT, RV = K::kRowV;
  constexpr int GN = kBN / CH;  // output-channel groups per tile
  static_assert(K::THREADS % GN == 0, "a thread keeps one output-channel group");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* vs = reinterpret_cast<bf16*>(smem);                        // [NC][kKC][RV]
  bf16* gs = vs + (size_t)NC * kKC * RV;                            // [NC][kKC][kRowN]
  float* red = reinterpret_cast<float*>(gs + (size_t)NC * kKC * kRowN);  // [THREADS][CH]

  const int wt = W / M, ht = H / M;
  const long long total = (long long)n_img * ht * wt;
  const long long chunks = (total + kKC - 1) / kKC;
  const int c0 = blockIdx.y * T, co0 = blockIdx.z * kBN;
  const bool with_db = blockIdx.y == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mat = lane >> 3, r8 = lane & 7;

  float acc[CPW][MT][NT][4];
#pragma unroll
  for (int q = 0; q < CPW; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][j][e] = 0.f;
  float dbacc[CH];
#pragma unroll
  for (int q = 0; q < CH; ++q) dbacc[q] = 0.f;

  for (long long ck = blockIdx.x; ck < chunks; ck += gridDim.x) {
    __syncthreads();  // the previous chunk is no longer read
    constexpr int GV = T / CH;
    for (int e = threadIdx.x; e < kKC * GV; e += K::THREADS) {
      const int cg = e % GV, tl = e / GV;
      const long long t = ck * kKC + tl;
      const bool valid = t < total;
      const int tx = (int)(t % wt), ty = (int)((t / wt) % ht), n = (int)(t / ((long long)wt * ht));
      input_transform<M, CH, false>(x, nullptr, valid, n, ty * M - 1, tx * M - 1, H, W, C,
                                    c0 + cg * CH, vs + tl * RV + cg * CH, kKC * RV);
    }
    for (int e = threadIdx.x; e < kKC * GN; e += K::THREADS) {
      const int cg = e % GN, tl = e / GN;  // cg == threadIdx.x % GN
      const long long t = ck * kKC + tl;
      const int co = co0 + cg * CH;
      float dz[M][M][CH];
#pragma unroll
      for (int p = 0; p < M; ++p)
#pragma unroll
        for (int l = 0; l < M; ++l)
#pragma unroll
          for (int q = 0; q < CH; ++q) dz[p][l][q] = 0.f;
      if (t < total) {
        const int tx = (int)(t % wt), ty = (int)((t / wt) % ht), n = (int)(t / ((long long)wt * ht));
#pragma unroll
        for (int p = 0; p < M; ++p)
#pragma unroll
          for (int l = 0; l < M; ++l) {
            const size_t off = (((size_t)n * H + ty * M + p) * W + tx * M + l) * Co + co;
            load_ch<CH>(g + off, dz[p][l]);
            if constexpr (MASKED) {
              float ov[CH];
              load_ch<CH>(o + off, ov);
#pragma unroll
              for (int q = 0; q < CH; ++q) dz[p][l][q] = ov[q] > 0.f ? dz[p][l][q] : 0.f;
            }
#pragma unroll
            for (int q = 0; q < CH; ++q) dbacc[q] += dz[p][l][q];
          }
      }
      float dmw[M][A][CH];  // dmw[p][j] = sum_l AT[l,j] dz[p,l]
#pragma unroll
      for (int p = 0; p < M; ++p)
#pragma unroll
        for (int j = 0; j < A; ++j)
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            dmw[p][j][q] = 0.f;
#pragma unroll
            for (int l = 0; l < M; ++l) cadd(dmw[p][j][q], at<M>(l, j), dz[p][l][q]);
          }
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < A; ++j) {
          float dm[CH];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            dm[q] = 0.f;
#pragma unroll
            for (int p = 0; p < M; ++p) cadd(dm[q], at<M>(p, i), dmw[p][j][q]);
          }
          store_ch<CH>(gs + ((i * A + j) * kKC + tl) * kRowN + cg * CH, dm);
        }
    }
    __syncthreads();

    // dU[xi] (rows c, columns co) += V[xi]^T dM[xi] over the chunk's tiles:
    // both are stored [tile][channel], so both load transposed
#pragma unroll
    for (int kb = 0; kb < kKC / 16; ++kb) {
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const int xi = warp * CPW + q;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          stage1::ldsm_x4_t(a[mt], vs + (xi * kKC + kb * 16 + 8 * (mat >> 1) + r8) * RV +
                                       mt * 16 + 8 * (mat & 1));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bb[4];
          stage1::ldsm_x4_t(bb, gs + (xi * kKC + kb * 16 + 8 * (mat & 1) + r8) * kRowN +
                                    (j + (mat >> 1)) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            stage1::mma_bf16(acc[q][mt][j], a[mt], bb[0], bb[1]);
            stage1::mma_bf16(acc[q][mt][j + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }
  }

  // the block's partial: fragment rows c = c0 + mt*16 + lane/4 (+8),
  // columns co = co0 + 8j + 2*(lane%4) + {0,1}
  float* part = du_part + (size_t)blockIdx.x * NC * C * Co;
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int xi = warp * CPW + q;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + mt * 16 + (lane >> 2) + 8 * h;
          const int co = co0 + j * 8 + 2 * (lane & 3);
          *reinterpret_cast<float2*>(part + ((size_t)xi * C + c) * Co + co) =
              make_float2(acc[q][mt][j][2 * h], acc[q][mt][j][2 * h + 1]);
        }
  }
  if (with_db) {  // thread th summed output channels co0 + CH*(th % GN) + q
#pragma unroll
    for (int q = 0; q < CH; ++q) red[threadIdx.x * CH + q] = dbacc[q];
    __syncthreads();
    for (int cc = threadIdx.x; cc < kBN; cc += K::THREADS) {
      float s = 0.f;
      for (int th = cc / CH; th < K::THREADS; th += GN) s += red[th * CH + cc % CH];
      db_part[(size_t)blockIdx.x * Co + co0 + cc] = s;
    }
  }
}

// the fixed-order sum of the partials, one thread per output element
__global__ void winograd_sum_kernel(const float* __restrict__ du_part,
                                    const float* __restrict__ db_part,
                                    float* __restrict__ du, float* __restrict__ db,
                                    int parts, long long n_du, int Co) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n_du) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += du_part[(size_t)p * n_du + e];
    du[e] = s;
  } else if (e < n_du + Co) {
    const int c = (int)(e - n_du);
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += db_part[(size_t)p * Co + c];
    db[c] = s;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int M, bool MASKED, bool BIAS_RELU>
cudaError_t launch_fwd(const void* x, const void* ut, const void* b, const void* o,
                       void* out, int n, int h, int w, int c, int co, cudaStream_t s) {
  using K = Cfg<M>;
  auto kernel = winograd_fwd_kernel<M, MASKED, BIAS_RELU>;
  cudaError_t err = prepare(kernel, K::kFwdSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)n * (h / M) * (w / M);
  const dim3 grid((unsigned)((tiles + K::T - 1) / K::T), co / kBN);
  kernel<<<grid, K::THREADS, K::kFwdSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ut),
      static_cast<const bf16*>(b), static_cast<const bf16*>(o), static_cast<bf16*>(out),
      n, h, w, c, co);
  return cudaGetLastError();
}

template <int M>
cudaError_t wgrad_parts(int n, int h, int w, int c, int co, int* parts) {
  using K = Cfg<M>;
  auto kernel = winograd_wgrad_kernel<M, false>;
  cudaError_t err = prepare(kernel, K::kWgradSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K::THREADS,
                                                           K::kWgradSmem)) != cudaSuccess)
    return err;
  const long long chunks = ((long long)n * (h / M) * (w / M) + kKC - 1) / kKC;
  const long long per_part = (long long)(c / K::T) * (co / kBN);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  long long p = (2 * resident + per_part - 1) / per_part;
  // the partials' scratch stays under 512 MiB
  const long long cap = (512ll << 20) / ((long long)K::NC * c * co * 4);
  if (p > cap) p = cap;
  if (p > chunks) p = chunks;
  *parts = (int)(p < 1 ? 1 : p);
  return cudaSuccess;
}

template <int M, bool MASKED>
cudaError_t launch_wgrad(const void* x, const void* g, const void* o, void* du_part,
                         void* db_part, int parts, void* du, void* db, int n, int h,
                         int w, int c, int co, cudaStream_t s) {
  using K = Cfg<M>;
  auto kernel = winograd_wgrad_kernel<M, MASKED>;
  cudaError_t err = prepare(kernel, K::kWgradSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(parts, c / K::T, co / kBN), K::THREADS, K::kWgradSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(o), static_cast<float*>(du_part),
      static_cast<float*>(db_part), n, h, w, c, co);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n_du = (long long)K::NC * c * co;
  winograd_sum_kernel<<<(unsigned)((n_du + co + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(du_part), static_cast<const float*>(db_part),
      static_cast<float*>(du), static_cast<float*>(db), parts, n_du, co);
  return cudaGetLastError();
}

bool shape_ok(int n, int h, int w, int c, int co, int m) {
  return (m == 2 || m == 4) && n >= 1 && h >= m && w >= m && h % m == 0 && w % m == 0 &&
         c > 0 && co > 0 && c % kKC == 0 && co % kBN == 0;
}

}  // namespace

// C entry, the forward. Device pointers, 16-byte aligned: x [N][H][W][C] bf16
// (in masked mode the cotangent), ut = U transposed [a*a][Co][C] bf16, b [Co]
// bf16 (read when bias_relu is 1), o [N][H][W][C] bf16 or null (non-null:
// masked mode), out [N][H][W][Co] bf16. m = 2 or 4; H, W multiples of m; C, Co
// multiples of 32. Returns a cudaError_t.
extern "C" int seg_winograd_fwd(const void* x, const void* ut, const void* b,
                                const void* o, void* out, int n, int h, int w, int c,
                                int co, int m, int bias_relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(n, h, w, c, co, m) || (bias_relu && b == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool masked = o != nullptr;
#define SEG_WFWD(MM, MK, BR)                                                 \
  if (m == MM && masked == MK && (bias_relu != 0) == BR)                     \
    return (int)launch_fwd<MM, MK, BR>(x, ut, b, o, out, n, h, w, c, co, s)
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

// The number of wgrad partials for this shape: the caller allocates
// du_part [parts][a*a][C][Co] and db_part [parts][Co] f32 and passes the same
// number to seg_winograd_wgrad. Returns parts > 0, or the negated cudaError_t.
extern "C" int seg_winograd_wgrad_parts(int n, int h, int w, int c, int co, int m) {
  if (!shape_ok(n, h, w, c, co, m)) return -(int)cudaErrorInvalidValue;
  int parts = 0;
  const cudaError_t err =
      m == 2 ? wgrad_parts<2>(n, h, w, c, co, &parts) : wgrad_parts<4>(n, h, w, c, co, &parts);
  return err == cudaSuccess ? parts : -(int)err;
}

// C entry, the weight gradient. x [N][H][W][C], g [N][H][W][Co] bf16, o g's
// shape or null (non-null: dz = g * (o > 0)); outputs du [a*a][C][Co] and db
// [Co] f32; scratch du_part, db_part as seg_winograd_wgrad_parts says.
// Returns a cudaError_t.
extern "C" int seg_winograd_wgrad(const void* x, const void* g, const void* o,
                                  void* du_part, void* db_part, int parts, void* du,
                                  void* db, int n, int h, int w, int c, int co, int m,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(n, h, w, c, co, m) || parts < 1) return (int)cudaErrorInvalidValue;
  const bool masked = o != nullptr;
#define SEG_WWG(MM, MK)                                                            \
  if (m == MM && masked == MK)                                                     \
    return (int)launch_wgrad<MM, MK>(x, g, o, du_part, db_part, parts, du, db, n, h, \
                                     w, c, co, s)
  SEG_WWG(2, false);
  SEG_WWG(2, true);
  SEG_WWG(4, false);
  SEG_WWG(4, true);
#undef SEG_WWG
  return (int)cudaErrorInvalidValue;
}
