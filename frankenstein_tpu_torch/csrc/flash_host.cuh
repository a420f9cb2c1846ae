// Host functions the K6 / K7 sources share: flash_attention.cu and
// flash_attention_bwd.cu (the mma.sync kernels of mode slab, and the C
// entry points) dispatch modes dense and positions to
// flash_attention_dense.cu (the wgmma kernels), and every source reports
// its kernels' occupancy to fk_flash_attention_occupancy. Each returns 0
// or a cudaError_t.
#pragma once

#include <cuda_runtime.h>

namespace fk {

// flash_attention_dense.cu: K7 dense and K6 (sid: [B, T] int32 slab ids),
// forward and both backward passes.
int flash_dense_fwd(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int T, int H, int D, float scale,
                    cudaStream_t st);
int flash_dense_bwd(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int T,
                    int H, int D, float scale, cudaStream_t st);
int flash_positions_fwd(const void* q, const void* k, const void* v,
                        const void* sid, void* out, void* lse, int B, int T,
                        int H, int D, float scale, cudaStream_t st);
int flash_positions_bwd(const void* q, const void* k, const void* v,
                        const void* sid, const void* out, const void* dout,
                        const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int B, int T, int H, int D, float scale,
                        cudaStream_t st);

// Registers a thread and resident CTAs an SM of a pass (0 forward, 1 dq,
// 2 dk/dv) of mode slab's kernels (flash_attention.cu,
// flash_attention_bwd.cu) at head_dim D.
int flash_masked_fwd_occupancy(int mode, int D, int* regs, int* ctas);
int flash_masked_bwd_occupancy(int mode, int pass, int D, int* regs,
                               int* ctas);

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
