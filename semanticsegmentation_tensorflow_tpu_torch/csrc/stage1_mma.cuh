// Shared pieces of the stage1 kernels (stage1_tail.cu forward, stage1_bwd.cu
// backward): the ldmatrix loads that feed their wgmma products with A from
// registers (hopper.cuh), and the persistent grid every stage1 launch walks
// its tiles with.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stage1 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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
