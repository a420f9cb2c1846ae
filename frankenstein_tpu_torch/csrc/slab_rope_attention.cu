// K1: slab-causal flash attention with in-kernel RoPE, forward only.
//
// Replaces frankenstein_tpu/ops/pallas/block_attention.py:_fwd_packed_rope_bte
// (kernel body _fwd_packed_rope_kernel), reached from
// slab_causal_attention_rope. Same contract:
//   q, k, v   [B, T, E] bf16, UNROTATED, head h = columns [h*D, (h+1)*D)
//   cos, sin  [T, D] f32, rope_cache[-T:] with each column repeated for the
//             adjacent lanes 2i, 2i+1 (suffix-aligned)
//   out       [B, T, E] bf16
//   lse       [B, H, T] f32, per-row logsumexp (kept for the backward, K4)
// Key j is visible to query i iff j / P <= i / P (P = tokens per time slab).
// Scale 1/sqrt(D); online softmax in f32 (exp through the hardware ex2
// unit, __expf: a few ulp, far below the bf16 rounding of the
// probabilities); probabilities cast to bf16 before the AV product, as the
// JAX kernel does.
//
// What bounds it on an H100: at D = 32 each score costs 2 x 32 MACs on the
// tensor cores but one exp and several f32 ops of softmax, so the kernel is
// bound by tensor-core issue and softmax work, not by bytes (K/V tiles are
// re-read per q-tile, mostly from L2). The design keeps everything between
// the two products in registers:
//   * one CTA per (batch, head, 128-row q-tile); 8 warps of 16 q rows;
//   * the q tile is rotated once in f32, rounded to bf16 and held as mma
//     A-fragments in registers; each K tile is rotated as it is loaded, V is
//     stored transposed so both B-fragments are single 32-bit loads;
//   * both products are mma.sync m16n8k16 bf16 with f32 accumulation; the
//     score accumulators of QK^T are re-packed in registers as the bf16
//     A-fragments of PV (flash-attention-2 layout), so scores and
//     probabilities never touch shared memory;
//   * the K/V loop stops at the end of the tile's last slab,
//     ((row_last / P) + 1) * P: future slabs are never loaded, a warp skips
//     the tiles past its rows' last slab, and only tiles that reach past a
//     warp's first slab are masked.
// wgmma, TMA and a pipelined K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fk::bf16;
using fk::lds32;
using fk::load_rotate8;
using fk::mma_bf16;
using fk::pack_bf16;

constexpr int BQ = 128;              // query rows per CTA
constexpr int BK = 64;               // keys per tile
constexpr int NWARPS = BQ / 16;      // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
slab_rope_attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, bf16* __restrict__ out,
                   float* __restrict__ lse, int T, int H, int P, float scale) {
  constexpr int CH = D / 8;      // 16-byte chunks per head row
  constexpr int LDQ = D + 8;     // row stride of sQ/sK: conflict-free frags
  constexpr int LDV = BK + 8;    // row stride of the transposed V tile
  constexpr int NT = BK / 8;     // score n-tiles per K tile
  constexpr int OT = D / 8;      // output n-tiles
  __shared__ __align__(16) bf16 sQ[BQ * LDQ];
  __shared__ __align__(16) bf16 sK[BK * LDQ];
  __shared__ __align__(16) bf16 sVt[D * LDV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const size_t base = size_t(b) * T * E + size_t(h) * D;

  for (int idx = tid; idx < BQ * CH; idx += NTHREADS) {
    const int r = idx / CH, c = (idx % CH) * 8, pos = q0 + r;
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) =
        load_rotate8(q + base + size_t(pos) * E + c,
                     cos_t + size_t(pos) * D + c, sin_t + size_t(pos) * D + c);
  }
  __syncthreads();

  // the warp's 16 rotated q rows as A-fragments, one per 16-wide d step
  uint32_t qa[D / 16][4];
  const bf16* sQ_w = sQ + warp * 16 * LDQ;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = lds32(sQ_w + g * LDQ + kk * 16 + 2 * t);
    qa[kk][1] = lds32(sQ_w + (g + 8) * LDQ + kk * 16 + 2 * t);
    qa[kk][2] = lds32(sQ_w + g * LDQ + kk * 16 + 8 + 2 * t);
    qa[kk][3] = lds32(sQ_w + (g + 8) * LDQ + kk * 16 + 8 + 2 * t);
  }

  const int row_first = q0 + warp * 16;
  const int kend_warp = min(T, ((row_first + 15) / P + 1) * P);
  const int kend = min(T, ((q0 + BQ - 1) / P + 1) * P);
  const int row0 = row_first + g, row1 = row0 + 8;   // this thread's rows
  const int slab0 = row0 / P, slab1 = row1 / P;

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous K, V tile consumed
    for (int idx = tid; idx < BK * CH; idx += NTHREADS) {
      const int r = idx / CH, c = (idx % CH) * 8, pos = k0 + r;
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) =
          load_rotate8(k + base + size_t(pos) * E + c,
                       cos_t + size_t(pos) * D + c,
                       sin_t + size_t(pos) * D + c);
      uint4 raw = *reinterpret_cast<const uint4*>(v + base + size_t(pos) * E +
                                                   c);
      const bf16* vv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(c + i) * LDV + r] = vv[i];
    }
    __syncthreads();
    if (k0 >= kend_warp) continue;  // warp-uniform: tile is in a future slab

    // S = Q K^T: rows (g, g+8), keys 8j + 2t + {0, 1}
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = sK + (j * 8 + g) * LDQ + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[j], qa[kk], lds32(krow + kk * 16),
                 lds32(krow + kk * 16 + 8));
    }

    const bool need_mask = (k0 + BK - 1) / P > row_first / P;
    float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = s[j][e] * scale, c = s[j][2 + e] * scale;
        if (need_mask) {
          const int key_slab = (k0 + j * 8 + 2 * t + e) / P;
          if (key_slab > slab0) a = -FLT_MAX;
          if (key_slab > slab1) c = -FLT_MAX;
        }
        s[j][e] = a;
        s[j][2 + e] = c;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, c);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __expf(s[j][e] - mn0);
        s[j][2 + e] = __expf(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;   // per-thread partial; quad-reduced at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: the score tiles 2kk, 2kk+1 are the A-fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      fk::repack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const bf16* vrow = sVt + (n * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(o[n], pa, lds32(vrow), lds32(vrow + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  bf16* out0 = out + base + size_t(row0) * E + 2 * t;
  bf16* out1 = out + base + size_t(row1) * E + 2 * t;
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    *reinterpret_cast<uint32_t*>(out0 + n * 8) =
        pack_bf16(o[n][0] / l0, o[n][1] / l0);
    *reinterpret_cast<uint32_t*>(out1 + n * 8) =
        pack_bf16(o[n][2] / l1, o[n][3] / l1);
  }
  if (t == 0) {
    float* lrow = lse + (size_t(b) * H + h) * T;
    lrow[row0] = m0 + logf(l0);
    lrow[row1] = m1 + logf(l1);
  }
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda/slab_attention.py):
// T % 128 == 0, D in {32, 64}, contiguous bf16 q/k/v, f32 [T, D] tables.
extern "C" int fk_slab_rope_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* cos_t,
                                          const void* sin_t, void* out,
                                          void* lse, int B, int T, int H,
                                          int D, int P, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T % BQ != 0 || P <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid(T / BQ, H, B);
  auto args = [&](auto kernel) {
    kernel<<<grid, NTHREADS, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<bf16*>(out),
        static_cast<float*>(lse), T, H, P, scale);
    return int(cudaGetLastError());
  };
  if (D == 32) return args(slab_rope_attn_fwd<32>);
  if (D == 64) return args(slab_rope_attn_fwd<64>);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
