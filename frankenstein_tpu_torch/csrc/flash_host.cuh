// A host function every kernel source shares: a kernel's registers and
// resident CTAs an SM, from the CUDA runtime, for the sources' occupancy
// entry points (fk_flash_attention_occupancy and the like). Returns 0 or a
// cudaError_t.
#pragma once

#include <cuda_runtime.h>

namespace fk {

// Registers a thread and resident CTAs an SM of ``kernel`` launched with
// ``threads`` threads and ``smem`` bytes of dynamic shared memory.
template <typename Kernel>
int kernel_occupancy(Kernel kernel, int threads, int smem, int* regs,
                     int* ctas) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  *regs = attr.numRegs;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                           threads, smem));
}

}  // namespace fk
