// K9: the fused pre-norm SwiGLU MLP sublayer, forward only, for Hopper
// (sm_90a):
//   out = x + w2 (silu(w1 h) * w3 h),  h = LayerNorm(x) or RMSNorm(x)
//
// Replaces frankenstein_tpu/ops/pallas/fused_mlp.py:_fused_call (kernel
// _kernel, its pallas_call at :135), reached from fused_norm_swiglu. The
// backward is autograd through the recomputed module chain, as the JAX
// package's custom VJP is (ops/cuda/fused_mlp.py:FusedNormSwiGLU).
// Contract (R rows = the flattened B*T, any count; the tail tile is masked):
//   x        [R, E] bf16, E in {64, 128, 192, 256}
//   nw, nb   [E] f32 (nb null: RMSNorm, or a LayerNorm without bias)
//   w1, w3   [hidden, E] bf16 (nn.Linear's [out, in]), hidden % 32 == 0
//   w2       [E, hidden] bf16
//   out      [R, E] bf16
// Rounding points are the TPU kernel's: norm statistics in f32; h =
// bf16(f32(bf16(normed)) * nw + nb); a = bf16(h w1^T) and b = bf16(h w3^T),
// accumulated in f32; g = bf16(bf16(silu_f32(a)) * b); y = g w2^T in f32;
// out = bf16(x + bf16(y)). One launch, no atomics on any value, a fixed
// order of every sum: two launches are bitwise equal.
//
// What bounds it on an H100: 6 R E hidden operations against 4 R E bytes of
// activations and 6 E hidden bytes of weights: at E = 256, hidden = 1024
// about 1500 operations a byte, far above the card's ~295, so the tensor
// cores bound it (0.313 ms at R = 32 * 6144). The [R, hidden] activations
// never leave the SM, and the design answers the rest so:
//   * a CTA is NWG consumer warpgroups of 64 rows each (128 rows at the
//     flagship's row counts, 64 where that leaves SMs idle); every product
//     is a wgmma;
//   * the weights stream through a ring of ST stages by TMA, one stage a
//     hidden chunk of NC = 32 columns: the chunk's w1 and w3 rows stacked
//     as one [2 NC, E] K-major tile (so a and b are ONE m64n64 product a
//     k-step, which keeps the shared-memory reads of h at half of two
//     m64n32 products) and its w2 columns as an [E, NC] K-major tile, all
//     128- or 64-byte swizzled as wgmma reads them;
//   * every CTA reads all 6 E hidden bytes of weights (1.5 MB at the
//     flagship width) from L2, 12 KB a row at 128-row CTAs;
//   * the first thread issues the first ST chunks before the norm, so
//     they land while it runs; after that the last of the CTA's warps to
//     release a stage refills it (a count in shared memory), so no warp
//     waits for another to issue;
//   * there is no producer warp: a ninth warp would put three warps on an
//     SM sub-partition and hold every thread to 168 registers, and y alone
//     takes E / 2 = 128 (E = 256). Eight warps leave 255;
//   * the norm prologue: each warp normalises 16 rows (statistics by warp
//     shuffles) and writes h as bf16 into shared memory in the 128-byte
//     swizzled K-major layout wgmma reads, then a proxy fence;
//   * per chunk: [a | b] = h [w1c | w3c]^T as SS wgmma (E / 16 k-steps of
//     m64n64k16), the gate in registers, g re-packed as the A-fragments of
//     an RS wgmma y += g w2c^T (m64nEk16, NC / 16 k-steps) that runs while
//     the warpgroup waits for the next chunk's [a | b]; the other
//     warpgroup's products fill the tensor cores while this one gates;
//   * y, the warpgroup's 64 rows by E, stays in f32 registers across the
//     hidden loop; the epilogue adds the residual (x read again, mostly
//     from L2) and writes bf16.
// The shapes (MlpOf: warpgroups, chunk, stages) were held against their
// neighbours on the card by tools/k9_shape_sweep.py, beside designs tried
// and not kept (PERF.md): a two-CTA cluster sharing each chunk by TMA
// multicast, a start chunk of each CTA's own, the next chunk's [a | b]
// run under this one's gate, h's A-fragments held in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_host.cuh"
#include "hopper_blocks.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fk;

constexpr int kLayerNorm = 0, kRmsNorm = 1;
constexpr int SMEM_MAX = 232448;   // a CTA's shared memory on an H100

template <int N>
struct WgmmaRSK;

#include "fused_mlp_wgmma.cuh"

// NWG consumer warpgroups of 64 rows at width E, hidden chunks of NC
// columns in a ring of ST stages. Shared memory: h as E / 64 column blocks of [BM rows][128 bytes]; a
// stage is the stacked w1 | w3 chunk as E / 64 column blocks of [2 NC
// rows][128 bytes], then the w2 chunk [E rows][NC * 2 bytes]; the ring's
// full barriers and release counts.
template <int E_, int NWG_, int NC_, int ST_>
struct MlpPass {
  static constexpr int E = E_, NWG = NWG_, NC = NC_, ST = ST_;
  static constexpr int BM = 64 * NWG, THREADS = 128 * NWG;
  static constexpr int KB = E / 64;
  static constexpr int H_BLOCK = BM * 128, H_BYTES = KB * H_BLOCK;
  static constexpr int W13_BLOCK = 2 * NC * 128, W13 = KB * W13_BLOCK;
  static constexpr int W2 = E * NC * 2, STAGE = W13 + W2;
  static constexpr int OFF_W = H_BYTES;
  static constexpr int OFF_BAR = OFF_W + ST * STAGE;
  static constexpr int OFF_REL = OFF_BAR + 8 * ST;
  static constexpr int SMEM = OFF_REL + 4 * ST + 1024;
  static_assert(E % 64 == 0 && E <= 256, "E in {64, 128, 192, 256}");
  static_assert(NC == 32 || NC == 64, "a w2 chunk row of 64 or 128 bytes");
  static_assert(W2 % 1024 == 0 && H_BLOCK % 1024 == 0,
                "every tile at the 128-byte swizzle's 1024-byte repeat");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one CTA");
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// g = bf16(bf16(silu(a)) * b), a and b rounded to bf16 first (the
// products' outputs), silu in f32 through ex2.
__device__ __forceinline__ float gate(float a, float b) {
  const float ar = round_bf16(a);
  const float s = round_bf16(__fdividef(ar, 1.f + ex2(-ar * kLog2e)));
  return round_bf16(__fmul_rn(s, round_bf16(b)));
}

// Stage s <- hidden chunk n: the w1 and w3 rows [n NC, (n + 1) NC) as
// column blocks of 64, and w2's columns of the chunk.
template <class C>
__device__ __forceinline__ void load_chunk(uint8_t* stage, uint64_t* full,
                                           const CUtensorMap* tw1,
                                           const CUtensorMap* tw3,
                                           const CUtensorMap* tw2, int n) {
  mbar_expect_tx(full, C::STAGE);
#pragma unroll
  for (int kb = 0; kb < C::KB; ++kb) {
    tma_load(stage + kb * C::W13_BLOCK, tw1, full, kb * 64, n * C::NC, 0);
    tma_load(stage + kb * C::W13_BLOCK + C::NC * 128, tw3, full, kb * 64,
             n * C::NC, 0);
  }
  tma_load(stage + C::W13, tw2, full, n * C::NC, 0, 0);
}

// One CTA per BM rows. Every thread is a consumer; see the source note for
// who loads the weights.
template <class C, int KIND>
__global__ void __launch_bounds__(C::THREADS, 1)
    fused_norm_swiglu_wgmma(const __grid_constant__ CUtensorMap tw1,
                            const __grid_constant__ CUtensorMap tw3,
                            const __grid_constant__ CUtensorMap tw2,
                            const bf16* __restrict__ x,
                            const float* __restrict__ nw,
                            const float* __restrict__ nb,
                            bf16* __restrict__ out, int R, int hidden,
                            float eps) {
  constexpr int E = C::E, NC = C::NC, ST = C::ST;
  constexpr int WARPS = 4 * C::NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  unsigned* rel = reinterpret_cast<unsigned*>(smem + C::OFF_REL);
  const int tid = threadIdx.x;
  const int nch = hidden / NC;
  const int row0 = blockIdx.x * C::BM;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      rel[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int n = 0; n < min(ST, nch); ++n)
      load_chunk<C>(smem + C::OFF_W + n * C::STAGE, &full[n], &tw1, &tw3,
                    &tw2, n);

  const int cw = warpgroup_index(), warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // prologue: the warp's 16 rows, normalised, as bf16 h in the swizzled
  // layout. Lane l holds columns [8l, 8l + 8) when 8l < E: 16-byte chunk
  // l % 8 of column block l / 8, at chunk (l % 8) ^ (row % 8) of its row.
  {
    const int c = lane * 8;
    const bool mine = c < E;
    float w[8], bias[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = mine ? nw[c + i] : 0.f;
      bias[i] = (mine && nb != nullptr) ? nb[c + i] : 0.f;
    }
    uint8_t* hcol = smem + (lane / 8) * C::H_BLOCK;
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int row = row0 + cw * 64 + r;
      float v[8];
      if (mine && row < R) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(x + size_t(row) * E + c);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(xv[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      float normed[8];
      if constexpr (KIND == kLayerNorm) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += v[i];
        const float mu = warp_sum(s) / float(E);
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = mine ? v[i] - mu : 0.f;
          q += d * d;
        }
        const float rstd = 1.0f / sqrtf(warp_sum(q) / float(E) + eps);
#pragma unroll
        for (int i = 0; i < 8; ++i) normed[i] = __fmul_rn(v[i] - mu, rstd);
      } else {
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) q += v[i] * v[i];
        const float rstd = 1.0f / sqrtf(warp_sum(q) / float(E) + eps);
#pragma unroll
        for (int i = 0; i < 8; ++i) normed[i] = __fmul_rn(v[i], rstd);
      }
      if (mine) {
        uint4 packed;
        uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float h0 = __fadd_rn(
              __fmul_rn(round_bf16(normed[2 * i]), w[2 * i]), bias[2 * i]);
          const float h1 = __fadd_rn(
              __fmul_rn(round_bf16(normed[2 * i + 1]), w[2 * i + 1]),
              bias[2 * i + 1]);
          p[i] = pack_bf16(h0, h1);
        }
        const int rr = cw * 64 + r;
        *reinterpret_cast<uint4*>(hcol + rr * 128 +
                                  (((lane % 8) ^ (rr % 8)) * 16)) = packed;
      }
    }
  }
  // h, written by the generic proxy, is read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(cw);

  // Release chunk n's stage: the last of the CTA's warps to do so refills
  // it with chunk n + ST.
  auto release = [&](int n) {
    if (lane != 0) return;
    const int s = n % ST;
    if (atomicAdd(&rel[s], 1u) % WARPS == WARPS - 1 && n + ST < nch)
      load_chunk<C>(smem + C::OFF_W + s * C::STAGE, &full[s], &tw1, &tw3,
                    &tw2, n + ST);
  };

  const uint32_t h_addr = smem_u32(smem) + cw * 64 * 128;
  const uint32_t w_base = smem_u32(smem + C::OFF_W);
  float y[E / 2], ab[NC];
  uint32_t ga[NC / 16][4];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) y[i] = 0.f;
  for (int n = 0; n < nch; ++n) {
    const int s = n % ST;
    const uint32_t w13 = w_base + s * C::STAGE;
    mbar_wait(&full[s], (n / ST) & 1);
    // [a | b] = h [w1c | w3c]^T, queued behind the previous chunk's y
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
      WgmmaSS<2 * NC>::mma(
          ab,
          kmajor_desc<128>(h_addr + (kk / 4) * C::H_BLOCK + (kk % 4) * 32),
          kmajor_desc<128>(w13 + (kk / 4) * C::W13_BLOCK + (kk % 4) * 32),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ab);
    fence_regs(y);
    fence_regs(ga);
    if (n > 0) release(n - 1);
    // the gate: a is columns [0, NC) of the product, b columns [NC, 2 NC),
    // in the same thread
    float gv[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) gv[i] = gate(ab[i], ab[i + NC / 2]);
    to_a<NC>(ga, gv);
    // y += g w2c^T, in flight until the next chunk's wait
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
      WgmmaRSK<E>::mma(y, ga[kk],
                       kmajor_desc<2 * NC>(w13 + C::W13 + kk * 32));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(y);
  fence_regs(ga);
  release(nch - 1);

  // out = bf16(x + bf16(y)): rows g and g + 8 of the warp's 16, columns
  // 8n + 2t + {0, 1}
  const int r_lo = row0 + cw * 64 + warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < E / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r_lo < R) {
      const size_t off = size_t(r_lo) * E + c;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(x + off);
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(__bfloat162float(xv.x) + round_bf16(y[4 * n]),
                    __bfloat162float(xv.y) + round_bf16(y[4 * n + 1]));
    }
    if (r_hi < R) {
      const size_t off = size_t(r_hi) * E + c;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(x + off);
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(__bfloat162float(xv.x) + round_bf16(y[4 * n + 2]),
                    __bfloat162float(xv.y) + round_bf16(y[4 * n + 3]));
    }
  }
}

// ---- host ---------------------------------------------------------------------

// The production instances: width E and consumer warpgroups; hidden chunk
// and ring stages (held against their neighbours on an H100 by
// tools/k9_shape_sweep.py, which rewrites this line; PERF.md).
template <int E, int NWG>
using MlpOf = MlpPass<E, NWG, 32, E == 256 && NWG == 2 ? 3 : 4>;

// Two warpgroups a CTA (half the weight reads a row) where their CTAs
// still fill half the SMs, one otherwise (a few thousand rows: twice the
// CTAs).
int warpgroups(int R) {
  static int sms = 0;
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) !=
          cudaSuccess)
    sms = 132;
  return 2 * ((R + 127) / 128) >= sms ? 2 : 1;
}

template <class C, int KIND>
int launch(const void* x, const void* nw, const void* nb, const void* w1,
           const void* w3, const void* w2, void* out, int R, int hidden,
           float eps, cudaStream_t st) {
  constexpr int E = C::E;
  CUtensorMap tw1, tw3, tw2;
  if (!tile_map_rows(&tw1, w1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 1,
                     hidden, E, 64, C::NC) ||
      !tile_map_rows(&tw3, w3, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 1,
                     hidden, E, 64, C::NC) ||
      !tile_map_rows(&tw2, w2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 1, E,
                     hidden, C::NC, E))
    return int(cudaErrorInvalidValue);
  auto kernel = fused_norm_swiglu_wgmma<C, KIND>;
  cudaError_t err = prepare<C>(kernel);
  if (err != cudaSuccess) return int(err);
  kernel<<<(R + C::BM - 1) / C::BM, C::THREADS, C::SMEM, st>>>(
      tw1, tw3, tw2, static_cast<const bf16*>(x),
      static_cast<const float*>(nw), static_cast<const float*>(nb),
      static_cast<bf16*>(out), R, hidden, eps);
  return int(cudaGetLastError());
}

// f(the instance of width E and W warpgroups, the norm as a type), or
// cudaErrorInvalidValue for a shape without one.
template <int W, typename F>
int with_width(int E, int kind, F f) {
  auto by_kind = [&](auto c) {
    if (kind == kLayerNorm)
      return f(c, std::integral_constant<int, kLayerNorm>());
    if (kind == kRmsNorm) return f(c, std::integral_constant<int, kRmsNorm>());
    return int(cudaErrorInvalidValue);
  };
  switch (E) {
    case 64: return by_kind(MlpOf<64, W>());
    case 128: return by_kind(MlpOf<128, W>());
    case 192: return by_kind(MlpOf<192, W>());
    case 256: return by_kind(MlpOf<256, W>());
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename F>
int with_instance(int E, int kind, int nwg, F f) {
  if (nwg == 1) return with_width<1>(E, kind, f);
  if (nwg == 2) return with_width<2>(E, kind, f);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda/fused_mlp.py):
// contiguous bf16 x, weights and out, f32 norm parameters, E in {64, 128,
// 192, 256}, hidden % 64 == 0. kind 0 = LayerNorm, 1 = RMSNorm.
extern "C" int fk_fused_norm_swiglu(const void* x, const void* nw,
                                    const void* nb, const void* w1,
                                    const void* w3, const void* w2, void* out,
                                    int R, int E, int hidden, int kind,
                                    float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 0 || hidden <= 0 || hidden % 32 != 0)
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  return with_instance(E, kind, warpgroups(R), [&](auto c, auto kind_c) {
    using C = decltype(c);
    return launch<C, decltype(kind_c)::value>(x, nw, nb, w1, w3, w2, out, R,
                                              hidden, eps, st);
  });
}

// Registers a thread and resident CTAs an SM of the instance of width E,
// norm ``kind`` and ``nwg`` consumer warpgroups (1 or 2; 0: the one a
// launch of R rows takes).
extern "C" int fk_fused_norm_swiglu_occupancy(int E, int kind, int nwg,
                                              int R, int* regs, int* ctas) {
  return with_instance(E, kind, nwg > 0 ? nwg : warpgroups(R),
                       [&](auto c, auto kind_c) {
                         using C = decltype(c);
                         return occupancy<C>(
                             fused_norm_swiglu_wgmma<C, decltype(kind_c)::value>,
                             regs, ctas);
                       });
}
