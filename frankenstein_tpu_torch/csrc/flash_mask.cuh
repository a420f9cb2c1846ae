// The mask modes of K6 and K7, shared by the forward and both backward
// passes so that all three see the same visible (query, key) pairs
// (flash_attention_dense.cu: each mode a compile-time mode of its passes;
// K1's and K4's slab_of<kSlab>):
//   kDense      K7 unmasked: every key is visible to every query;
//   kSlab       K7 slab-causal: key j is visible to query i iff
//               j / P <= i / P (P = tokens per time slab);
//   kPositions  K6: key j is visible to query i iff sid[j] <= sid[i], with
//               sid the [B, N] int32 slab ids of a gathered token subset
//               (its original positions // P).
#pragma once

#include <cfloat>
#include <climits>

namespace fk {

enum MaskMode { kDense = 0, kSlab = 1, kPositions = 2 };

// The score of an invisible key: finfo(f32).min, the JAX kernel's NEG_INF.
inline constexpr float kMaskedScore = -FLT_MAX;

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Least and greatest of the n slab ids sid[0, n), in every lane of the
// calling warp (all 32 lanes must call).
__device__ __forceinline__ int2 slab_range(const int* __restrict__ sid,
                                           int n) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    lo = min(lo, sid[i]);
    hi = max(hi, sid[i]);
  }
  return make_int2(warp_min(lo), warp_max(hi));
}

// rng[j] = slab_range of column tile j (sid[j * BN, (j + 1) * BN)) for
// j < nt, rng[nt] that of the CTA's own rows sid[r0, r0 + rows), and
// rng[nt + 1 + w] that of its 64-row group w < NWG ((INT_MAX, INT_MIN)
// past the rows): by the warps of the CTA in turn (every thread must
// call), before the __syncthreads that publishes them.
template <int BN, int NWG>
__device__ __forceinline__ void slab_ranges(int2* rng,
                                            const int* __restrict__ sid,
                                            int nt, int r0, int rows) {
  for (int j = threadIdx.x / 32; j <= nt + NWG; j += blockDim.x / 32) {
    const int w = j - nt - 1;
    int2 r = make_int2(INT_MAX, INT_MIN);
    if (j < nt)
      r = slab_range(sid + j * BN, BN);
    else if (j == nt)
      r = slab_range(sid + r0, rows);
    else if (64 * w < rows)
      r = slab_range(sid + r0 + 64 * w, 64);
    if (threadIdx.x % 32 == 0) rng[j] = r;
  }
}

// Slab of token ``pos`` of a batch row: pos / P (kSlab) or sid[pos]
// (kPositions); 0 for kDense, where nothing is masked.
template <int MODE>
__device__ __forceinline__ int slab_of(const int* __restrict__ sid, int pos,
                                       int P) {
  if constexpr (MODE == kSlab) return pos / P;
  if constexpr (MODE == kPositions) return sid[pos];
  return 0;
}

}  // namespace fk
