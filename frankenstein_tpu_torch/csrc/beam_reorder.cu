// K3: beam-search KV-cache reorder, in place.
//
// Replaces frankenstein_tpu/ops/pallas/beam_reorder.py:beam_reorder. Beam
// parents never leave their sentence's group of W rows: for each layer and
// group g, row g*W + n of the [L, B*W, S, E] cache becomes row
// g*W + parent[g*W + n] with parent in [0, W). Each beam row is a
// contiguous [S, E] run of row_bytes bytes; the bytes are copied as they
// are, so any dtype (bf16, int8 codes, f32) reorders alike.
//
// What bounds it on an H100: nothing but bytes, one read and one write of
// the cache (at the flagship beam shape, [12, 160, 64, 768] bf16, 189 MB a
// side), so the design is a plain streaming copy at full width:
//   * a block owns one (layer, group, 16-byte column range) of one side;
//     each thread owns one 16-byte column of that group and first loads it
//     from all W rows (the loads are all in flight at once), then writes
//     each row whose parent is another row. No block or thread ever writes
//     what another reads, so the permutation runs in place without a
//     second buffer, as the TPU kernel's aliased output does;
//   * rows whose parent is themselves are not written.
// One launch reorders both sides (blockIdx.z picks k or v).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_W = 16;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
beam_reorder_kernel(uint4* __restrict__ k, uint4* __restrict__ v,
                    const int* __restrict__ parent, int G, int W,
                    int row_vecs) {
  __shared__ uint4 stage[MAX_W * THREADS];   // 32 KB: one column, W rows
  __shared__ int src[MAX_W];
  const int lg = blockIdx.y;                 // layer * G + group
  const int g = lg % G;
  uint4* base = (blockIdx.z == 0 ? k : v) + size_t(lg) * W * row_vecs;
  if (threadIdx.x < W) src[threadIdx.x] = parent[g * W + threadIdx.x];
  __syncthreads();
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= row_vecs) return;
  uint4 vals[MAX_W];
#pragma unroll
  for (int r = 0; r < MAX_W; ++r)
    if (r < W) vals[r] = base[size_t(r) * row_vecs + c];
#pragma unroll
  for (int r = 0; r < MAX_W; ++r)
    if (r < W) stage[r * THREADS + threadIdx.x] = vals[r];
  for (int n = 0; n < W; ++n) {
    const int p = src[n];
    if (p != n)
      base[size_t(n) * row_vecs + c] = stage[p * THREADS + threadIdx.x];
  }
}

}  // namespace

// k_cache, v_cache: [L, G * W, S, E] device buffers of row_bytes = S * E *
// itemsize bytes per beam row (v_cache may be null: one side only);
// parent: [G * W] int32 on the device, values in [0, W). row_bytes % 16 ==
// 0, 16-byte aligned buffers, 1 <= W <= 16. Runs on `stream`, in place.
extern "C" int fk_beam_reorder(void* k_cache, void* v_cache,
                               const void* parent, int L, int G, int W,
                               int row_bytes, void* stream) {
  if (W < 1 || W > MAX_W || G < 1 || L < 1 || row_bytes % 16 != 0 ||
      static_cast<long long>(L) * G > 65535 || k_cache == nullptr)
    return int(cudaErrorInvalidValue);
  const int row_vecs = row_bytes / 16;
  const dim3 grid((row_vecs + THREADS - 1) / THREADS, L * G,
                  v_cache == nullptr ? 1 : 2);
  beam_reorder_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_cache), static_cast<uint4*>(v_cache),
      static_cast<const int*>(parent), G, W, row_vecs);
  return int(cudaGetLastError());
}
