// The probes and K10's K pre-pass: slab-causal flash attention with
// in-kernel RoPE, forward only, on mma.sync, the design K1 and K10 ran
// before their wgmma redesigns (slab_rope_attention_fwd.cu,
// slab_rope_attention_int8.cu), kept as the probes' kernel (ROPE = false,
// every mode below); and the pre-pass that rotates and quantizes K, which
// production K10 runs before its own kernels (fk_slab_rope_k_quant, ROPE
// = true).
//
// K1's contract, which the bf16 modes compute (without the rotation) and
// the int8 modes with int8 scores; K1 replaces
// frankenstein_tpu/ops/pallas/block_attention.py: _fwd_packed_rope_bte
// (kernel body _fwd_packed_rope_kernel), reached from
// slab_causal_attention_rope:
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
// K10's arithmetic (block_attention.py: 1351-1356, 1370-1379, 1392-1403,
// 1411-1426), which the int8 modes keep:
//   * Q (rounded to bf16) per (row, head): s_q = max|q| / 127 + 1e-12 in
//     f32, codes round_half_even(q / s_q), an IEEE division;
//   * rotated K per (1024-row key chunk, head): s_k the same over the
//     chunk's rows and the head's lanes, codes round_half_even(k / s_k);
//   * score = (float(int32 dot(q8, k8)) * (scale * s_k)) * s_q, in that
//     order, then the slab mask and the online softmax; V, the
//     probabilities and the AV product stay bf16 with f32 accumulation; lse
//     from the dequantized scores (K4 runs on K10's out and lse).
// The K scale is a max over 1024 rows, many of the main kernel's 64-key
// tiles, so a pre-pass (rope_absmax_k, then rope_quantize_k, over small
// row tiles) rotates K, takes each chunk's max and writes the codes
// [B, T, E] int8 and the scales [B, H, T/1024] f32; since 1024 % 64 == 0
// each K tile has one scale. The kernel's int8 modes take each Q row's max
// (row-local) and hold the int8 A-fragments in registers; QK is mma.sync
// m16n8k32 s8 x s8 -> s32, one mma per 16x8 score tile at D=32, and the
// int32 accumulators convert in registers, after which the code is the
// bf16 modes'.
//
// The design, which the probes price: at D = 32 each score costs 2 x 32
// MACs on the tensor cores but one exp and several f32 ops of softmax, so
// the kernel is bound by tensor-core issue and softmax work, not by bytes
// (K/V tiles are re-read per q-tile, mostly from L2). Everything between
// the two products stays in registers:
//   * one CTA per (batch, head, 128-row q-tile); 8 warps of 16 q rows;
//   * the q tile is held as mma A-fragments in registers; V is stored
//     transposed so both B-fragments are single 32-bit loads;
//   * both products are mma.sync with f32 (s32) accumulation; the score
//     accumulators of QK^T are re-packed in registers as the bf16
//     A-fragments of PV (flash-attention-2 layout), so scores and
//     probabilities never touch shared memory;
//   * the K/V loop stops at the end of the tile's last slab,
//     ((row_last / P) + 1) * P: future slabs are never loaded, a warp skips
//     the tiles past its rows' last slab, and only tiles that reach past a
//     warp's first slab are masked.
// On an H100 the probes put about half of this design's time in the
// products and a fifth in the registers its runtime mask branch holds (123
// a thread: 2 CTAs an SM where the branchless body fits 3); PERF.md has
// the split. K1's and K10's wgmma forwards answer them: a TMA ring, a mask
// only in a compile-time instance, exp2, one rotation a key.
//
// The probes (fk_slab_attention_probe) replace tools/attn_probe.py:
// _variant_call and tools/int8_attr_probe.py:_call, which price the
// components of the packed TPU forward by timing variants with one
// removed. Here each variant is a compile-time mode of this kernel
// (template parameters ROPE and VARIANT; every probe branch is behind
// if constexpr), instantiated at D = 32 with ROPE = false:
//   PROD with ROPE = false   K1's math (K10's with INT8) on unrotated q, k
//   DOTS_ONLY                scores * scale rounded to bf16 as PV's
//                            A-fragments: no mask, max, exp, sum or
//                            rescale; out = the accumulator, lse = 0
//   NO_KBD                   V copied row-major as 16-byte chunks (the
//                            layout step that plays the TPU's
//                            block-diagonal staging; values wrong)
//   NO_MASK, MASK_ALL        need_mask forced false, or true on every tile
//   EXP2                     scale * log2(e) in the QK epilogue, exp2f,
//                            lse = m * ln 2 + ln l
//   INT8_DOTS_ONLY           cast-only codes round(8x), raw int32 scores
//                            to bf16, DOTS_ONLY's PV
//   INT8_CHEAP_DEQUANT       K10's codes, epilogue convert * scale only
//   INT8_NOQUANT             cast-only codes round(8x) (no max reductions
//                            in Q or the pre-pass), epilogue convert * scale

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fk::absmax_scale;
using fk::bf16;
using fk::lds32;
using fk::load_rotate8;
using fk::mma_bf16;
using fk::mma_s8;
using fk::pack_bf16;
using fk::quantize_s8;

constexpr int BQ = 128;              // query rows per CTA
constexpr int BK = 64;               // keys per tile
constexpr int NWARPS = BQ / 16;      // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int KCHUNK = 1024;         // rows per K scale (K10)
static_assert(NTHREADS == 2 * BQ, "K10 quantizes Q with two threads a row");
static_assert(KCHUNK % BK == 0, "a K tile must sit in one scale chunk");

// The probes' cast-only int8 code: round half to even of 8 v (the JAX
// probes' round(8 x); |v| < 15.9 keeps it in range).
__device__ __forceinline__ int8_t cast_code(float v) {
  return static_cast<int8_t>(__float2int_rn(8.f * v));
}

// Kernel modes; the numbers are fk_slab_attention_probe's `variant`
// (ops/cuda/slab_probe.py:PROBE_VARIANTS).
enum Variant : int {
  PROD = 0,
  DOTS_ONLY = 1,
  NO_KBD = 2,
  NO_MASK = 3,
  MASK_ALL = 4,
  EXP2 = 5,
  INT8_FULL = 6,   // PROD with INT8 (K10's arithmetic)
  INT8_DOTS_ONLY = 7,
  INT8_CHEAP_DEQUANT = 8,
  INT8_NOQUANT = 9,
};

// 8 bf16 lanes of x at src, rotated with the position's table rows (ROPE)
// or as stored.
template <bool ROPE>
__device__ __forceinline__ uint4 stage8(const bf16* __restrict__ src,
                                        const float* __restrict__ cos_row,
                                        const float* __restrict__ sin_row) {
  if constexpr (ROPE) return load_rotate8(src, cos_row, sin_row);
  return *reinterpret_cast<const uint4*>(src);
}

// INT8 = false: K1's math (k is the bf16 input, k8 and ks unused).
// INT8 = true: K10's (k unused; k8 [B, T, E] and ks [B, H, T / KCHUNK] from
// rope_quantize_k).
// ROPE = false (every instance, the probes'): q and k tiles are staged as
// stored; cos_t and sin_t are unused. VARIANT: a probe mode (enum Variant),
// PROD for K1's or K10's math.
template <int D, bool INT8, bool ROPE, int VARIANT>
__global__ void __launch_bounds__(NTHREADS)
slab_rope_attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const int8_t* __restrict__ k8,
                   const float* __restrict__ ks, const bf16* __restrict__ v,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, bf16* __restrict__ out,
                   float* __restrict__ lse, int T, int H, int P, float scale) {
  constexpr bool DOTS = VARIANT == DOTS_ONLY || VARIANT == INT8_DOTS_ONLY;
  constexpr bool CAST = VARIANT == INT8_DOTS_ONLY || VARIANT == INT8_NOQUANT;
  constexpr bool SCALE_ONLY =
      VARIANT == INT8_CHEAP_DEQUANT || VARIANT == INT8_NOQUANT;
  static_assert(INT8 == (VARIANT >= INT8_FULL) || VARIANT == PROD,
                "an int8 mode needs INT8, a bf16 mode needs !INT8");
  constexpr int CH = D / 8;      // 16-byte chunks per bf16 head row
  constexpr int LDQ = D + 8;     // row stride of sQ/sK: conflict-free frags
  constexpr int LD8 = D + 16;    // byte stride of int8 rows: conflict-free
  constexpr int LDV = BK + 8;    // row stride of the transposed V tile
  constexpr int NT = BK / 8;     // score n-tiles per K tile
  constexpr int OT = D / 8;      // output n-tiles
  // NO_KBD stores V row-major (stride LDQ) in the same buffer and reads it
  // with the transposed layout's fragment loads: it is zeroed once, so
  // every word those loads reach holds a finite value.
  constexpr int SV = VARIANT == NO_KBD ? BK * LDQ : D * LDV;
  static_assert(SV >= D * LDV, "NO_KBD's reads stay inside the buffer");
  __shared__ __align__(16) bf16 sQ[BQ * LDQ];
  __shared__ __align__(16) bf16 sK[INT8 ? 8 : BK * LDQ];
  __shared__ __align__(16) int8_t sK8[INT8 ? BK * LD8 : 16];
  __shared__ __align__(16) int8_t sQ8[INT8 ? BQ * LD8 : 16];
  __shared__ float sQs[INT8 ? BQ : 1];
  __shared__ __align__(16) bf16 sVt[SV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const size_t base = size_t(b) * T * E + size_t(h) * D;

  if constexpr (VARIANT == NO_KBD) {
    for (int idx = tid; idx < SV / 2; idx += NTHREADS)
      reinterpret_cast<uint32_t*>(sVt)[idx] = 0u;
  }
  for (int idx = tid; idx < BQ * CH; idx += NTHREADS) {
    const int r = idx / CH, c = (idx % CH) * 8, pos = q0 + r;
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) =
        stage8<ROPE>(q + base + size_t(pos) * E + c,
                     cos_t + size_t(pos) * D + c, sin_t + size_t(pos) * D + c);
  }
  __syncthreads();

  // the warp's 16 rotated q rows as A-fragments, one per 16-wide (bf16) or
  // 32-wide (int8) d step; K10 also keeps its rows' Q scales
  uint32_t qa[INT8 ? D / 32 : D / 16][4];
  float sq0 = 1.f, sq1 = 1.f;
  if constexpr (INT8) {
    {
      const int r = tid >> 1, half = tid & 1;
      const bf16* src = sQ + r * LDQ + half * (D / 2);
      if constexpr (CAST) {
        int8_t* dst = sQ8 + r * LD8 + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; ++c)
          dst[c] = cast_code(__bfloat162float(src[c]));
      } else {
        float mx = 0.f;
#pragma unroll
        for (int c = 0; c < D / 2; ++c)
          mx = fmaxf(mx, fabsf(__bfloat162float(src[c])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float s = absmax_scale(mx);
        int8_t* dst = sQ8 + r * LD8 + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; ++c)
          dst[c] = quantize_s8(__bfloat162float(src[c]), s);
        if (half == 0) sQs[r] = s;
      }
    }
    __syncthreads();
    const int8_t* w8 = sQ8 + warp * 16 * LD8;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      qa[kk][0] = lds32(w8 + g * LD8 + kk * 32 + 4 * t);
      qa[kk][1] = lds32(w8 + (g + 8) * LD8 + kk * 32 + 4 * t);
      qa[kk][2] = lds32(w8 + g * LD8 + kk * 32 + 16 + 4 * t);
      qa[kk][3] = lds32(w8 + (g + 8) * LD8 + kk * 32 + 16 + 4 * t);
    }
    if constexpr (!CAST) {
      sq0 = sQs[warp * 16 + g];
      sq1 = sQs[warp * 16 + g + 8];
    }
  } else {
    const bf16* sQ_w = sQ + warp * 16 * LDQ;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = lds32(sQ_w + g * LDQ + kk * 16 + 2 * t);
      qa[kk][1] = lds32(sQ_w + (g + 8) * LDQ + kk * 16 + 2 * t);
      qa[kk][2] = lds32(sQ_w + g * LDQ + kk * 16 + 8 + 2 * t);
      qa[kk][3] = lds32(sQ_w + (g + 8) * LDQ + kk * 16 + 8 + 2 * t);
    }
  }

  const int row_first = q0 + warp * 16;
  const int kend_warp = min(T, ((row_first + 15) / P + 1) * P);
  const int kend = min(T, ((q0 + BQ - 1) / P + 1) * P);
  const int row0 = row_first + g, row1 = row0 + 8;   // this thread's rows
  const int slab0 = row0 / P, slab1 = row1 / P;
  const float* ks_bh = INT8 ? ks + (size_t(b) * H + h) * (T / KCHUNK)
                            : nullptr;

  // exp of a score difference: base 2 under EXP2 (log2(e) in the scale)
  const auto ex = [](float x) {
    if constexpr (VARIANT == EXP2) return exp2f(x);
    else return __expf(x);
  };
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous K, V tile consumed
    for (int idx = tid; idx < BK * CH; idx += NTHREADS) {
      const int r = idx / CH, c = (idx % CH) * 8, pos = k0 + r;
      if constexpr (INT8) {
        if (c % 16 == 0)   // a 16-byte chunk of codes covers two bf16 chunks
          *reinterpret_cast<uint4*>(sK8 + r * LD8 + c) =
              *reinterpret_cast<const uint4*>(k8 + base + size_t(pos) * E +
                                              c);
      } else {
        *reinterpret_cast<uint4*>(sK + r * LDQ + c) =
            stage8<ROPE>(k + base + size_t(pos) * E + c,
                         cos_t + size_t(pos) * D + c,
                         sin_t + size_t(pos) * D + c);
      }
      uint4 raw = *reinterpret_cast<const uint4*>(v + base + size_t(pos) * E +
                                                   c);
      if constexpr (VARIANT == NO_KBD) {
        *reinterpret_cast<uint4*>(sVt + r * LDQ + c) = raw;
      } else {
        const bf16* vv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) sVt[(c + i) * LDV + r] = vv[i];
      }
    }
    __syncthreads();
    if (k0 >= kend_warp) continue;  // warp-uniform: tile is in a future slab

    // S = Q K^T, scaled: rows (g, g+8), keys 8j + 2t + {0, 1}
    float s[NT][4];
    if constexpr (INT8) {
      const float ssk =
          VARIANT == PROD ? __fmul_rn(scale, ks_bh[k0 / KCHUNK]) : scale;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        int si[4] = {0, 0, 0, 0};
        const int8_t* krow = sK8 + (j * 8 + g) * LD8 + 4 * t;
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          mma_s8(si, qa[kk], lds32(krow + kk * 32), lds32(krow + kk * 32 + 16));
        if constexpr (VARIANT == PROD) {
          s[j][0] = __fmul_rn(__fmul_rn(__int2float_rn(si[0]), ssk), sq0);
          s[j][1] = __fmul_rn(__fmul_rn(__int2float_rn(si[1]), ssk), sq0);
          s[j][2] = __fmul_rn(__fmul_rn(__int2float_rn(si[2]), ssk), sq1);
          s[j][3] = __fmul_rn(__fmul_rn(__int2float_rn(si[3]), ssk), sq1);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = SCALE_ONLY ? __fmul_rn(__int2float_rn(si[e]), ssk)
                                 : __int2float_rn(si[e]);
        }
      }
    } else {
      // EXP2 folds log2(e) into the scale, so the softmax runs in base 2
      const float sc = VARIANT == EXP2 ? scale * 1.44269504088896341f : scale;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const bf16* krow = sK + (j * 8 + g) * LDQ + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[j], qa[kk], lds32(krow + kk * 16),
                   lds32(krow + kk * 16 + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sc;
      }
    }

    if constexpr (DOTS) {   // the scores straight into PV, no softmax
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
      continue;
    }

    const bool need_mask =
        VARIANT == MASK_ALL ||
        (VARIANT != NO_MASK && (k0 + BK - 1) / P > row_first / P);
    float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = s[j][e], c = s[j][2 + e];
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
    const float alpha0 = ex(m0 - mn0), alpha1 = ex(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = ex(s[j][e] - mn0);
        s[j][2 + e] = ex(s[j][2 + e] - mn1);
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

  if constexpr (DOTS) {   // the raw accumulator; lse 0
    bf16* out0 = out + base + size_t(row0) * E + 2 * t;
    bf16* out1 = out + base + size_t(row1) * E + 2 * t;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<uint32_t*>(out0 + n * 8) = pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(out1 + n * 8) = pack_bf16(o[n][2], o[n][3]);
    }
    if (t == 0) {
      float* lrow = lse + (size_t(b) * H + h) * T;
      lrow[row0] = lrow[row1] = 0.f;
    }
    return;
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
    if constexpr (VARIANT == EXP2) {   // m is in log2 units
      lrow[row0] = m0 * 0.693147180559945309f + logf(l0);
      lrow[row1] = m1 * 0.693147180559945309f + logf(l1);
    } else {
      lrow[row0] = m0 + logf(l0);
      lrow[row1] = m1 + logf(l1);
    }
  }
}

// K10's pre-pass, two kernels over tiles of ROWS K rows (one 8-lane piece
// a thread): rope_absmax_k rotates K (the rotation K1 applies, rounded to
// bf16) and folds each tile's max |k| into its chunk's max with an atomic
// max on the float's bits (non-negative floats order as their bits do);
// rope_quantize_k rotates again, takes the chunk's scale and writes the
// codes, and the chunk's first tile writes the scale. K is read twice, the
// second time mostly from L2. The probes run them with ROPE = false (K as
// stored) and, for the cast-only modes, rope_quantize_k alone with CAST:
// codes round(8 k), no chunk max and no scale.
constexpr int QK_THREADS = 256;

template <int D>
struct QkTile {
  static constexpr int CH = D / 8;              // pieces a row
  static constexpr int ROWS = QK_THREADS / CH;  // 64 at D=32, 32 at D=64
  static_assert(KCHUNK % ROWS == 0, "a tile must sit in one chunk");

  // the chunk of this CTA's tile in the [B, H, T / KCHUNK] scale arrays
  static __device__ __forceinline__ size_t slot(int T, int H) {
    return (size_t(blockIdx.z) * H + blockIdx.y) * (T / KCHUNK) +
           blockIdx.x * ROWS / KCHUNK;
  }

  // this thread's 8 rotated (ROPE) or stored lanes; returns their offset
  // in k
  template <bool ROPE>
  static __device__ __forceinline__ size_t rotated(const bf16* k,
                                                   const float* cos_t,
                                                   const float* sin_t, int T,
                                                   int H, float (&f)[8]) {
    const int r = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
    const int pos = blockIdx.x * ROWS + r;
    const size_t off = (size_t(blockIdx.z) * T + pos) * (H * D) +
                       size_t(blockIdx.y) * D + c;
    uint4 rot = stage8<ROPE>(k + off, cos_t + size_t(pos) * D + c,
                             sin_t + size_t(pos) * D + c);
    const bf16* rv = reinterpret_cast<const bf16*>(&rot);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(rv[i]);
    return off;
  }
};

template <int D, bool ROPE>
__global__ void __launch_bounds__(QK_THREADS)
rope_absmax_k(const bf16* __restrict__ k, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, unsigned* __restrict__ amax,
              int T, int H) {
  __shared__ float red[QK_THREADS / 32];
  float f[8];
  QkTile<D>::template rotated<ROPE>(k, cos_t, sin_t, T, H, f);
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(f[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < QK_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
    atomicMax(amax + QkTile<D>::slot(T, H), __float_as_uint(mx));
  }
}

template <int D, bool ROPE, bool CAST>
__global__ void __launch_bounds__(QK_THREADS)
rope_quantize_k(const bf16* __restrict__ k, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t,
                const unsigned* __restrict__ amax, int8_t* __restrict__ k8,
                float* __restrict__ ks, int T, int H) {
  float s = 0.f;
  if constexpr (!CAST) {
    const size_t slot = QkTile<D>::slot(T, H);
    s = absmax_scale(__uint_as_float(amax[slot]));
    if (threadIdx.x == 0 && (blockIdx.x * QkTile<D>::ROWS) % KCHUNK == 0)
      ks[slot] = s;
  }
  float f[8];
  const size_t off =
      QkTile<D>::template rotated<ROPE>(k, cos_t, sin_t, T, H, f);
  uint2 codes;
  int8_t* c8 = reinterpret_cast<int8_t*>(&codes);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    c8[i] = CAST ? cast_code(f[i]) : quantize_s8(f[i], s);
  *reinterpret_cast<uint2*>(k8 + off) = codes;
}

}  // namespace

// Shapes are checked by the Python wrappers (ops/cuda/slab_attention.py,
// ops/cuda/slab_probe.py): T % 1024 == 0 for the int8 modes, D in {32,
// 64}, contiguous bf16 q/k/v, f32 [T, D] tables.

// K10's K pre-pass (production K10 runs it before
// slab_rope_attention_int8.cu's kernels): codes k8 [B, T, E] int8, scales
// ks [B, H, T/1024]; amax [B, H, T/1024] u32 scratch, zero on entry.
extern "C" int fk_slab_rope_k_quant(const void* k, const void* cos_t,
                                    const void* sin_t, void* amax, void* k8,
                                    void* ks, int B, int T, int H, int D,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T % KCHUNK != 0) return int(cudaErrorInvalidValue);
  auto run = [&](auto absmax, auto quant, int rows) {
    const dim3 grid(T / rows, H, B);
    absmax<<<grid, QK_THREADS, 0, st>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<unsigned*>(amax), T, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    quant<<<grid, QK_THREADS, 0, st>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<const unsigned*>(amax),
        static_cast<int8_t*>(k8), static_cast<float*>(ks), T, H);
    return int(cudaGetLastError());
  };
  if (D == 32)
    return run(rope_absmax_k<32, true>, rope_quantize_k<32, true, false>,
               QkTile<32>::ROWS);
  if (D == 64)
    return run(rope_absmax_k<64, true>, rope_quantize_k<64, true, false>,
               QkTile<64>::ROWS);
  return int(cudaErrorInvalidValue);
}

// f(the D = 32 kernel of probe mode `variant`), on unrotated q and k.
template <typename F>
int with_mode(int variant, F f) {
  switch (variant) {
    case PROD: return f(slab_rope_attn_fwd<32, false, false, PROD>);
    case DOTS_ONLY: return f(slab_rope_attn_fwd<32, false, false, DOTS_ONLY>);
    case NO_KBD: return f(slab_rope_attn_fwd<32, false, false, NO_KBD>);
    case NO_MASK: return f(slab_rope_attn_fwd<32, false, false, NO_MASK>);
    case MASK_ALL: return f(slab_rope_attn_fwd<32, false, false, MASK_ALL>);
    case EXP2: return f(slab_rope_attn_fwd<32, false, false, EXP2>);
    case INT8_FULL: return f(slab_rope_attn_fwd<32, true, false, PROD>);
    case INT8_DOTS_ONLY:
      return f(slab_rope_attn_fwd<32, true, false, INT8_DOTS_ONLY>);
    case INT8_CHEAP_DEQUANT:
      return f(slab_rope_attn_fwd<32, true, false, INT8_CHEAP_DEQUANT>);
    default: return f(slab_rope_attn_fwd<32, true, false, INT8_NOQUANT>);
  }
}

// The probes: `variant` is a mode of enum Variant, run on UNROTATED q, k
// at D = 32 (no tables). `stages` & 1 runs an int8 mode's K pre-pass into
// k8 and ks (amax [B, H, T/1024] u32 scratch, zero on entry; the cast-only
// modes need neither amax nor ks), `stages` & 2 the attention kernel on
// k8 and ks as they stand. A bf16 mode reads k and runs its kernel alone.
extern "C" int fk_slab_attention_probe(const void* q, const void* k,
                                       const void* v, void* amax, void* k8,
                                       void* ks, void* out, void* lse, int B,
                                       int T, int H, int D, int P,
                                       float scale, int variant, int stages,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T % BQ != 0 || P <= 0 || D != 32 || variant < PROD ||
      variant > INT8_NOQUANT)
    return int(cudaErrorInvalidValue);
  const bool int8 = variant >= INT8_FULL;
  if (int8 && T % KCHUNK != 0) return int(cudaErrorInvalidValue);
  if (int8 && (stages & 1)) {
    const dim3 grid(T / QkTile<32>::ROWS, H, B);
    const bool cast = variant == INT8_DOTS_ONLY || variant == INT8_NOQUANT;
    if (!cast) {
      rope_absmax_k<32, false><<<grid, QK_THREADS, 0, st>>>(
          static_cast<const bf16*>(k), nullptr, nullptr,
          static_cast<unsigned*>(amax), T, H);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
    auto quant = cast ? rope_quantize_k<32, false, true>
                      : rope_quantize_k<32, false, false>;
    quant<<<grid, QK_THREADS, 0, st>>>(
        static_cast<const bf16*>(k), nullptr, nullptr,
        static_cast<const unsigned*>(amax), static_cast<int8_t*>(k8),
        static_cast<float*>(ks), T, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (!(stages & 2)) return 0;
  const dim3 grid(T / BQ, H, B);
  return with_mode(variant, [&](auto kernel) {
    kernel<<<grid, NTHREADS, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const int8_t*>(k8), static_cast<const float*>(ks),
        static_cast<const bf16*>(v), nullptr, nullptr,
        static_cast<bf16*>(out), static_cast<float*>(lse), T, H, P, scale);
    return int(cudaGetLastError());
  });
}

// Registers a thread and resident CTAs an SM of the D = 32 instance of a
// probe mode, from the CUDA runtime. Production K1's are
// fk_slab_rope_attention_fwd_occupancy's (slab_rope_attention_fwd.cu),
// production K10's fk_slab_rope_attention_fwd_int8_occupancy's
// (slab_rope_attention_int8.cu).
extern "C" int fk_slab_attention_occupancy(int variant, int* regs,
                                           int* ctas) {
  if (variant < PROD || variant > INT8_NOQUANT)
    return int(cudaErrorInvalidValue);
  return with_mode(variant, [&](auto kernel) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return int(err);
    *regs = attr.numRegs;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                             NTHREADS, 0));
  });
}

extern "C" const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
