// Pieces shared by the all-layer decode kernels K2 (fused_decode.cu) and K5
// (fused_llama_decode.cu): warp and block reductions, the split-K decode
// product with its fixed-order finalize, and the staging of cache rows.
//
// gemm_partial: part[z, B, N] = A[B, kz] (bf16) @ W[kz, N] for the depth
// slice kz of split z, f32 accumulation in nvcuda::wmma bf16 tiles; int8
// weights (w8a16) are read as int8 and widened exactly to bf16 in shared
// memory. W may be up to three matrices that share A and the depth (K5's
// q, k and v, or its gate and up), written side by side as the columns of
// one partial. splits_for picks the number of depth splits so that a few hundred
// CTAs stream disjoint weight tiles at once; finalize sums the partials of
// one output in split order (deterministic) and applies the w8 scale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int GEMM_BM = 32;    // batch rows per CTA
constexpr int GEMM_BN = 64;    // output lanes per CTA
constexpr int GEMM_BK = 128;   // depth per shared-memory stage
constexpr int GEMM_THREADS = 128;
constexpr int TARGET_CTAS = 4 * 132;   // ~4 CTAs per SM of an H100
constexpr int ROW_THREADS = 256;
constexpr int ATTN_THREADS = 128;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block (blockDim.x a multiple of 32, at most 1024).
__device__ float block_sum(float v) {
  __shared__ float part[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < int(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float out = total;
  __syncthreads();  // part/total are reused by the next call
  return out;
}

// 16 bytes of weights -> bf16 in shared memory (int8 codes widen exactly).
__device__ __forceinline__ void stage_weights(const bf16* src, bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void stage_weights(const int8_t* src, bf16* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* w = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 out[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16(float(w[i]));
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(out)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(out)[1];
}

// Up to three weight matrices [K, n[i]] (n[i] % GEMM_BN == 0) whose
// products fill the columns [n[0] + ... + n[i-1], ... + n[i]) of one
// [splits, B, N] partial, N the sum of the n[i].
struct GemmSegs {
  const void* w[3];
  int n[3];
  int count;
};

// part[z, B, N] = A[B, kz] (bf16) @ W[kz, N] for the depth slice kz of
// split z = blockIdx.z (K / gridDim.z rows), f32 accumulation; W is the
// side-by-side concatenation of the segments.
template <typename WT>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_partial(const bf16* __restrict__ A, const GemmSegs segs,
             float* __restrict__ part, int B, int K, int N) {
  constexpr int LDA = GEMM_BK + 8, LDW = GEMM_BN + 8, LDC = GEMM_BN + 4;
  constexpr int VEC = 16 / sizeof(WT);       // weights per 16-byte load
  constexpr int CPR = GEMM_BN / VEC;         // 16-byte loads per tile row
  __shared__ __align__(128) bf16 sA[GEMM_BM * LDA];
  __shared__ __align__(128) bf16 sW[GEMM_BK * LDW];
  __shared__ __align__(128) float sC[GEMM_BM * LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int n0 = blockIdx.x * GEMM_BN, m0 = blockIdx.y * GEMM_BM;
  const int kc = K / gridDim.z, kbeg = blockIdx.z * kc;
  // the segment of this CTA's columns (constant indices keep segs in the
  // parameter space, off the stack)
  const void* wseg = segs.w[0];
  int NW = segs.n[0], seg_off = 0;
  if (segs.count > 1 && n0 >= segs.n[0]) {
    wseg = segs.w[1];
    NW = segs.n[1];
    seg_off = segs.n[0];
    if (segs.count > 2 && n0 >= seg_off + segs.n[1]) {
      wseg = segs.w[2];
      NW = segs.n[2];
      seg_off += segs.n[1];
    }
  }
  const WT* __restrict__ W = static_cast<const WT*>(wseg);
  const int w0 = n0 - seg_off;   // this CTA's first column within W
  const int wm = warp >> 1, wn = warp & 1;   // 2 x 2 warps of 16 x 32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = kbeg; k0 < kbeg + kc; k0 += GEMM_BK) {
    // every 16-byte load of the stage is issued before any is waited on
    for (int idx = tid; idx < GEMM_BM * GEMM_BK / 8; idx += GEMM_THREADS) {
      const int r = idx / (GEMM_BK / 8), c = (idx % (GEMM_BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < B)
        val = *reinterpret_cast<const uint4*>(A + size_t(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(sA + r * LDA + c) = val;
    }
    for (int idx = tid; idx < GEMM_BK * CPR; idx += GEMM_THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * VEC;
      stage_weights(W + size_t(k0 + r) * NW + w0 + c, sW + r * LDW + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + wm * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sW + kk * LDW + wn * 32 + j * 16, LDW);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sC + wm * 16 * LDC + wn * 32 + j * 16, acc[j], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  float* pz = part + size_t(blockIdx.z) * B * N;
  for (int idx = tid; idx < GEMM_BM * GEMM_BN; idx += GEMM_THREADS) {
    const int r = idx / GEMM_BN, c = idx % GEMM_BN;
    if (m0 + r < B) pz[size_t(m0 + r) * N + n0 + c] = sC[r * LDC + c];
  }
}

// sum_z part[z, row, col] in split order, then * scale (w8a16): the
// product's f32 dot output as the JAX chain scales it.
// The caller adds the bias where the JAX chain does.
__device__ __forceinline__ float finalize(const float* __restrict__ part,
                                          int splits, size_t plane,
                                          size_t off, const float* scale,
                                          int col) {
  float y = 0.f;
  for (int z = 0; z < splits; ++z) y += part[z * plane + off];
  return scale == nullptr ? y : y * scale[col];
}

// Cache rows (CT = bf16 or int8 codes) are staged through shared memory
// ATTN_ROWS at a time with 16-byte loads, all issued before any is used.
constexpr int ATTN_ROWS = 64;

__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return float(v); }

// The new cache entry: bf16, or the int8 code of v at scale s.
__device__ __forceinline__ void put(bf16* dst, float v, float) {
  *dst = __float2bfloat16(v);
}
__device__ __forceinline__ void put(int8_t* dst, float v, float s) {
  *dst = static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// rows [0, rows) of D lanes, from a cache whose rows are E elements apart.
template <typename CT>
__device__ __forceinline__ void stage_rows(const CT* __restrict__ src,
                                           CT* dst, int rows, int D, int E) {
  constexpr int VEC = 16 / sizeof(CT);
  const int chunks = D / VEC;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * VEC;
    *reinterpret_cast<uint4*>(dst + r * D + c) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * E + c);
  }
}

// Depth splits of a [B, K] x [K, N] product: the largest divisor of the
// K / GEMM_BK depth steps that keeps the grid near TARGET_CTAS.
int splits_for(int B, int K, int N) {
  const int tiles = (N / GEMM_BN) * ((B + GEMM_BM - 1) / GEMM_BM);
  const int want = (TARGET_CTAS + tiles - 1) / tiles;
  const int steps = K / GEMM_BK;
  int best = 1;
  for (int s = 1; s <= steps && s <= want; ++s)
    if (steps % s == 0) best = s;
  return best;
}

template <typename WT>
cudaError_t gemm_segs(const bf16* A, const GemmSegs& segs, float* part,
                      int splits, int B, int K, cudaStream_t st) {
  int N = 0;
  for (int i = 0; i < segs.count; ++i) N += segs.n[i];
  const dim3 grid(N / GEMM_BN, (B + GEMM_BM - 1) / GEMM_BM, splits);
  gemm_partial<WT><<<grid, GEMM_THREADS, 0, st>>>(A, segs, part, B, K, N);
  return cudaGetLastError();
}

// One weight matrix: W + w_off is [K, N].
template <typename WT>
cudaError_t gemm(const bf16* A, const void* W, size_t w_off, float* part,
                 int splits, int B, int K, int N, cudaStream_t st) {
  const GemmSegs segs{{static_cast<const WT*>(W) + w_off, nullptr, nullptr},
                      {N, 0, 0}, 1};
  return gemm_segs<WT>(A, segs, part, splits, B, K, st);
}

#define FK_TRY(expr)                              \
  do {                                            \
    cudaError_t fk_err_ = (expr);                 \
    if (fk_err_ != cudaSuccess) return fk_err_;   \
  } while (0)

}  // namespace
