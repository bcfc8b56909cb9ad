// Training input preprocess: per-example horizontal flip, crop at (oy, ox),
// then uint8 -> float32 (x - mean_c) * inv_std_c, in one pass.
//
// Replaces: semanticsegmentation_tensorflow_tpu/ops/pallas/preprocess.py:
// _normalize_kernel (pallas_normalize, under make_pallas_augment_fn). On the
// TPU the flip and crop ran in XLA and only the normalize was Pallas; here
// the three fuse, since flip and crop are pure byte movement.
//
// Contract (image [N][H][W][3] u8, params [N][3] int32 = (flip, oy, ox),
// out [N][ch][cw][3] f32):
//   sx  = ox + x, or W - 1 - (ox + x) when flip (flip the full width first,
//         then crop: preprocess.py:92-109)
//   out[n][y][x][c] = (float(image[n][oy + y][sx][c]) - mean_c) * inv_std_c
// with mean_c and inv_std_c the f32 roundings of the mean and of 1/std taken
// in double (preprocess.py:46), one subtraction and one multiplication each
// rounded (no FMA): bit-equal to the plain PyTorch version.
//
// What bounds it on the H100: the bytes. At 8x320x1152 it reads ~8.8 MB and
// writes ~35 MB (12 of the 15 bytes per pixel are the f32 output), ~13 us at
// 3.35 TB/s; the plain version gathers the u8 crop (writes and rereads it),
// converts, subtracts and multiplies in separate passes.
//
// Design: one thread per output pixel, one block row per output row; a warp
// reads 32 neighbouring source pixels (forward or mirrored) and writes 384
// contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ image, const int* __restrict__ params,
                  float* __restrict__ out, int H, int W, int ch, int cw,
                  float m0, float m1, float m2, float i0, float i1, float i2) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y, n = blockIdx.z;
  if (x >= cw) return;
  const int flip = params[3 * n], oy = params[3 * n + 1], ox = params[3 * n + 2];
  const int sx = flip ? W - 1 - (ox + x) : ox + x;
  const uint8_t* src = image + (((size_t)n * H + oy + y) * W + sx) * 3;
  float* dst = out + (((size_t)n * ch + y) * cw + x) * 3;
  dst[0] = __fmul_rn(__fsub_rn((float)src[0], m0), i0);
  dst[1] = __fmul_rn(__fsub_rn((float)src[1], m1), i1);
  dst[2] = __fmul_rn(__fsub_rn((float)src[2], m2), i2);
}

}  // namespace

// C entry. Device pointers: image [n][h][w][3] u8, params [n][3] int32
// (flip 0/1, oy, ox with oy + ch <= h and ox + cw <= w, checked by the
// caller), out [n][ch][cw][3] f32. Returns a cudaError_t (0 on success).
extern "C" int seg_preprocess(const void* image, const void* params, void* out, int n,
                              int h, int w, int ch, int cw, float m0, float m1,
                              float m2, float i0, float i1, float i2, void* stream) {
  if (n <= 0 || ch <= 0 || cw <= 0) return (int)cudaSuccess;
  if (ch > 65535 || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((cw + kThreads - 1) / kThreads, ch, n);
  preprocess_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(image), static_cast<const int*>(params),
      static_cast<float*>(out), h, w, ch, cw, m0, m1, m2, i0, i1, i2);
  return (int)cudaGetLastError();
}
