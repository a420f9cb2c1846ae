// K7 slab: slab-causal flash attention over folded q/k/v without RoPE,
// forward only (the backward is flash_attention_bwd.cu). Modes dense (K7
// unmasked) and positions (K6) run the wgmma kernels of
// flash_attention_dense.cu; this file's C entry point dispatches them
// there.
//
// Replaces, in frankenstein_tpu/ops/pallas/block_attention.py, _fwd /
// _fwd_packed (kernels _fwd_tri_kernel, _fwd_packed_kernel), reached from
// slab_causal_attention[_folded] (slab-causal, no RoPE). Contract:
//   q, k, v   [B, T, E] bf16, head h = columns [h*D, (h+1)*D)
//   sid       unused by mode slab (the C entry point takes K6's slab ids)
//   out       [B, T, E] bf16
//   lse       [B, H, T] f32, per-row logsumexp (kept for the backward)
// Key j is visible to query i iff j / P <= i / P (flash_mask.cuh). Scale
// 1/sqrt(D); s = (q k^T) * scale in f32, masked scores set to -FLT_MAX
// (finfo(f32).min, as the JAX kernel's NEG_INF); online softmax in f32
// whose l sums the unrounded exps; p cast to bf16 before the AV product;
// lse = m + log(l).
//
// What bounds it on an H100: at D = 32 each visible (query, key) pair
// costs 2 x 32 MACs on the tensor cores but one exp and several f32 ops of
// softmax, so the kernel is bound by tensor-core throughput and softmax
// work, not by bytes (K/V tiles are re-read per q-tile, mostly from L2). The
// design:
//   * one CTA per (batch, head, 128-row q-tile); 8 warps of 16 q rows;
//   * the q tile is held as mma A-fragments in registers; V is stored
//     transposed so both B-fragments are single 32-bit loads;
//   * both products are mma.sync m16n8k16 bf16 with f32 accumulation, the
//     score accumulators re-packed in registers as the bf16 A-fragments of
//     PV (mma_bf16.cuh), so scores and probabilities never touch shared
//     memory;
//   * pruning: the key loop ends at the end of the q tile's last slab, as
//     K1's does; a warp skips the tiles past its own rows' slabs, and only
//     tiles that reach past a warp's least slab are masked.
// Every row sees at least its own key, so no row's l is 0.
// The wgmma / TMA design of flash_attention_dense.cu is later work here
// (ROADMAP: fold K7 slab onto K4's passes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "flash_host.cuh"
#include "flash_mask.cuh"
#include "mma_bf16.cuh"

namespace {

using fk::bf16;
using fk::lds32;
using fk::mma_bf16;
using fk::pack_bf16;

constexpr int BQ = 128;              // query rows per CTA
constexpr int BK = 64;               // keys per tile
constexpr int NWARPS = BQ / 16;      // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ sid,
               bf16* __restrict__ out, float* __restrict__ lse, int T, int H,
               int P, float scale) {
  constexpr int CH = D / 8;      // 16-byte chunks per head row
  constexpr int LDQ = D + 8;     // row stride of sQ/sK: conflict-free frags
  constexpr int LDV = BK + 8;    // row stride of the transposed V tile
  constexpr int NT = BK / 8;     // score n-tiles per K tile
  constexpr int OT = D / 8;      // output n-tiles
  static_assert(MODE == fk::kSlab, "modes dense and positions run the "
                "wgmma kernels of flash_attention_dense.cu");
  __shared__ __align__(16) bf16 sQ[BQ * LDQ];
  __shared__ __align__(16) bf16 sK[BK * LDQ];
  __shared__ __align__(16) bf16 sVt[D * LDV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const size_t base = size_t(b) * T * E + size_t(h) * D;

  for (int idx = tid; idx < BQ * CH; idx += NTHREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) =
        *reinterpret_cast<const uint4*>(q + base + size_t(q0 + r) * E + c);
  }
  __syncthreads();

  // the warp's 16 q rows as A-fragments, one per 16-wide d step
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
  const int row0 = row_first + g, row1 = row0 + 8;   // this thread's rows
  const int slab0 = fk::slab_of<MODE>(sid, row0, P);
  const int slab1 = fk::slab_of<MODE>(sid, row1, P);
  // least / greatest slab of the warp's rows, and the end of the key loop
  const int warp_lo = row_first / P;
  const int warp_hi = (row_first + 15) / P;
  const int kend = min(T, ((q0 + BQ - 1) / P + 1) * P);

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    // least / greatest slab of the key tile
    const int2 kr = make_int2(k0 / P, (k0 + BK - 1) / P);
    __syncthreads();  // previous K, V tile consumed
    for (int idx = tid; idx < BK * CH; idx += NTHREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const size_t off = base + size_t(k0 + r) * E + c;
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) =
          *reinterpret_cast<const uint4*>(k + off);
      uint4 raw = *reinterpret_cast<const uint4*>(v + off);
      const bf16* vv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(c + i) * LDV + r] = vv[i];
    }
    __syncthreads();
    if (kr.x > warp_hi) continue;  // warp-uniform

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

    const bool need_mask = kr.y > warp_lo;
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

template <int D>
int launch_fwd(dim3 grid, cudaStream_t st, const bf16* q, const bf16* k,
               const bf16* v, bf16* out, float* lse, int T, int H, int P,
               float scale) {
  flash_attn_fwd<D, fk::kSlab><<<grid, NTHREADS, 0, st>>>(
      q, k, v, nullptr, out, lse, T, H, P, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda/flash_attention.py):
// T % 128 == 0, D in {32, 64}, contiguous bf16 q/k/v, P > 0 for kSlab, a
// contiguous int32 [B, T] sid for kPositions.
extern "C" int fk_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* sid,
                                      void* out, void* lse, int B, int T,
                                      int H, int D, int mode, int P,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T % BQ != 0 || (mode == fk::kSlab && P <= 0) ||
      (mode == fk::kPositions && sid == nullptr))
    return int(cudaErrorInvalidValue);
  if (mode == fk::kDense)
    return fk::flash_dense_fwd(q, k, v, out, lse, B, T, H, D, scale, st);
  if (mode == fk::kPositions)
    return fk::flash_positions_fwd(q, k, v, sid, out, lse, B, T, H, D, scale,
                                   st);
  if (mode != fk::kSlab) return int(cudaErrorInvalidValue);
  const dim3 grid(T / BQ, H, B);
  auto run = [&](auto launch) {
    return launch(grid, st, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<bf16*>(out), static_cast<float*>(lse), T, H, P,
                  scale);
  };
  if (D == 32) return run(launch_fwd<32>);
  if (D == 64) return run(launch_fwd<64>);
  return int(cudaErrorInvalidValue);
}

namespace fk {

int flash_masked_fwd_occupancy(int mode, int D, int* regs, int* ctas) {
  auto read = [&](auto kernel) {
    return kernel_occupancy(kernel, NTHREADS, 0, regs, ctas);
  };
  if (mode == kSlab && D == 32) return read(flash_attn_fwd<32, kSlab>);
  if (mode == kSlab && D == 64) return read(flash_attn_fwd<64, kSlab>);
  return int(cudaErrorInvalidValue);
}

}  // namespace fk
