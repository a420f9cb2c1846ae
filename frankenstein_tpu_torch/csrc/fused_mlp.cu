// K9: the fused pre-norm SwiGLU MLP sublayer, forward only:
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
// out = bf16(x + bf16(y)).
//
// What bounds it on an H100: 6 R E hidden operations against 4 R E bytes of
// activations and 6 E hidden bytes of weights. At E = 256, hidden = 1024
// that is about 1500 operations a byte, far above the card's ~295, so the
// tensor cores bound it. The eager chain it replaces writes the [R, hidden]
// activations to device memory and reads them back several times; here
// they never leave the SM:
//   * one CTA of 8 warps per 128-row tile, each warp owning 16 rows;
//   * the prologue normalises the tile (one row per warp step, statistics
//     by warp shuffles) into shared memory as bf16 h;
//   * the hidden dimension is walked in chunks of 32 columns: the chunk's
//     w1 and w3 rows and w2 columns stream into shared memory with cp.async
//     while the previous chunk computes (two stages);
//   * a and b are mma.sync m16n8k16 products with f32 accumulators; the
//     gate runs in registers and its bf16 values are re-packed in registers
//     as the A-fragments of the y product (mma_bf16.cuh), so g never
//     touches shared memory;
//   * y, the warp's 16 rows by E, stays in f32 registers across the loop;
//   * the epilogue adds the residual (x read again, mostly from L2) and
//     writes bf16.
// Every CTA reads all 6 E hidden bytes of weights (1.5 MB at the flagship
// width) from L2; 128-row tiles keep that at 12 KB of L2 reads per row.
// wgmma, TMA multicast of the weight chunks and a persistent CTA that keeps
// the weights resident are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fk::bf16;
using fk::lds32;
using fk::mma_bf16;
using fk::pack_bf16;

constexpr int BM = 128;               // rows per CTA
constexpr int NWARPS = BM / 16;       // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int NC = 32;                // hidden columns per chunk
constexpr int LDC = NC + 8;           // row stride of the w2 chunk
constexpr int kLayerNorm = 0, kRmsNorm = 1;

// Shared memory in bf16 elements: h, then two stages of (w1, w3, w2)
// chunks. Strides of E + 8 and NC + 8 keep every fragment load
// conflict-free.
template <int E>
struct Smem {
  static constexpr int LDH = E + 8;
  static constexpr int H = BM * LDH;
  static constexpr int W13 = NC * LDH;
  static constexpr int W2 = E * LDC;
  static constexpr int STAGE = 2 * W13 + W2;
  static constexpr size_t BYTES = size_t(H + 2 * STAGE) * sizeof(bf16);
};

__device__ __forceinline__ void cp_async16(bf16* smem, const bf16* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage the hidden columns [c0, c0 + NC): w1 and w3 rows, w2 columns.
template <int E>
__device__ __forceinline__ void load_chunk(bf16* stage, const bf16* w1,
                                           const bf16* w3, const bf16* w2,
                                           int c0, int hidden, int tid) {
  using S = Smem<E>;
  constexpr int CH = E / 8;       // 16-byte pieces of a w1 / w3 row
  bf16* s1 = stage;
  bf16* s3 = stage + S::W13;
  bf16* s2 = stage + 2 * S::W13;
  for (int idx = tid; idx < NC * CH; idx += NTHREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const size_t off = size_t(c0 + r) * E + c;
    cp_async16(s1 + r * S::LDH + c, w1 + off);
    cp_async16(s3 + r * S::LDH + c, w3 + off);
  }
  constexpr int CH2 = NC / 8;     // 16-byte pieces of a w2 row's chunk
  for (int idx = tid; idx < E * CH2; idx += NTHREADS) {
    const int r = idx / CH2, c = (idx % CH2) * 8;
    cp_async16(s2 + r * LDC + c, w2 + size_t(r) * hidden + c0 + c);
  }
}

// g = bf16(bf16(silu(a)) * b) on one C-fragment, a and b rounded to bf16
// first (the products' outputs), silu in f32.
__device__ __forceinline__ void gate(float (&g)[4], const float (&a)[4],
                                     const float (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ar = round_bf16(a[i]);
    const float s = round_bf16(ar / (1.0f + expf(-ar)));
    g[i] = round_bf16(__fmul_rn(s, round_bf16(b[i])));
  }
}

template <int E, int KIND>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_norm_swiglu_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ nw,
                         const float* __restrict__ nb,
                         const bf16* __restrict__ w1,
                         const bf16* __restrict__ w3,
                         const bf16* __restrict__ w2, bf16* __restrict__ out,
                         int R, int hidden, float eps) {
  using S = Smem<E>;
  constexpr int LDH = S::LDH;
  constexpr int NT = E / 8;        // y n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sH = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sH + S::H;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int row0 = blockIdx.x * BM;
  const int nchunks = hidden / NC;

  load_chunk<E>(sW, w1, w3, w2, 0, hidden, tid);
  cp_async_commit();

  // prologue, overlapping the first chunk's loads: the warp's 16 rows,
  // normalised, as bf16 h. Lane l holds columns [8l, 8l + 8) when 8l < E.
  {
    const int c = lane * 8;
    const bool mine = c < E;
    float w[8], bias[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = mine ? nw[c + i] : 0.f;
      bias[i] = (mine && nb != nullptr) ? nb[c + i] : 0.f;
    }
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int row = row0 + r;
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
        *reinterpret_cast<uint4*>(sH + r * LDH + c) = packed;
      }
    }
  }

  // y: rows (g, g + 8) of the warp, columns 8n + 2t + {0, 1}
  float y[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
  const bf16* sHw = sH + warp * 16 * LDH;

  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      load_chunk<E>(sW + ((ch + 1) & 1) * S::STAGE, w1, w3, w2,
                    (ch + 1) * NC, hidden, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk ch (and, the first time, h) visible to all
    const bf16* s1 = sW + (ch & 1) * S::STAGE;
    const bf16* s3 = s1 + S::W13;
    const bf16* s2 = s1 + 2 * S::W13;

    // a = h w1_chunk^T, b = h w3_chunk^T: 16 rows x NC columns each
    float a[NC / 8][4], b[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[j][i] = b[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk) {
      uint32_t ha[4];
      ha[0] = lds32(sHw + g * LDH + kk * 16 + 2 * t);
      ha[1] = lds32(sHw + (g + 8) * LDH + kk * 16 + 2 * t);
      ha[2] = lds32(sHw + g * LDH + kk * 16 + 8 + 2 * t);
      ha[3] = lds32(sHw + (g + 8) * LDH + kk * 16 + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const bf16* r1 = s1 + (j * 8 + g) * LDH + kk * 16 + 2 * t;
        const bf16* r3 = s3 + (j * 8 + g) * LDH + kk * 16 + 2 * t;
        mma_bf16(a[j], ha, lds32(r1), lds32(r1 + 8));
        mma_bf16(b[j], ha, lds32(r3), lds32(r3 + 8));
      }
    }

    // the gate in registers; the n-tiles 2kk, 2kk + 1 of g are the
    // A-fragment of hidden step kk of y += g w2_chunk^T
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk) {
      float g0[4], g1[4];
      gate(g0, a[2 * kk], b[2 * kk]);
      gate(g1, a[2 * kk + 1], b[2 * kk + 1]);
      uint32_t ga[4];
      fk::repack_a(ga, g0, g1);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* r2 = s2 + (n * 8 + g) * LDC + kk * 16 + 2 * t;
        mma_bf16(y[n], ga, lds32(r2), lds32(r2 + 8));
      }
    }
    __syncthreads();   // stage (ch & 1) free for chunk ch + 2
  }

  // out = bf16(x + bf16(y))
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r_lo < R) {
      const size_t off = size_t(r_lo) * E + c;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(x + off);
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(__bfloat162float(xv.x) + round_bf16(y[n][0]),
                    __bfloat162float(xv.y) + round_bf16(y[n][1]));
    }
    if (r_hi < R) {
      const size_t off = size_t(r_hi) * E + c;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(x + off);
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(__bfloat162float(xv.x) + round_bf16(y[n][2]),
                    __bfloat162float(xv.y) + round_bf16(y[n][3]));
    }
  }
}

template <int E, int KIND>
int launch(const bf16* x, const float* nw, const float* nb, const bf16* w1,
           const bf16* w3, const bf16* w2, bf16* out, int R, int hidden,
           float eps, cudaStream_t st) {
  auto kernel = fused_norm_swiglu_kernel<E, KIND>;
  constexpr size_t smem = Smem<E>::BYTES;
  static bool opted_in = false;   // above 48 KB only after opting in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    opted_in = true;
  }
  kernel<<<(R + BM - 1) / BM, NTHREADS, smem, st>>>(x, nw, nb, w1, w3, w2,
                                                     out, R, hidden, eps);
  return int(cudaGetLastError());
}

template <int KIND>
int launch_kind(int E, const bf16* x, const float* nw, const float* nb,
                const bf16* w1, const bf16* w3, const bf16* w2, bf16* out,
                int R, int hidden, float eps, cudaStream_t st) {
  switch (E) {
    case 64:
      return launch<64, KIND>(x, nw, nb, w1, w3, w2, out, R, hidden, eps, st);
    case 128:
      return launch<128, KIND>(x, nw, nb, w1, w3, w2, out, R, hidden, eps,
                               st);
    case 192:
      return launch<192, KIND>(x, nw, nb, w1, w3, w2, out, R, hidden, eps,
                               st);
    case 256:
      return launch<256, KIND>(x, nw, nb, w1, w3, w2, out, R, hidden, eps,
                               st);
    default:
      return int(cudaErrorInvalidValue);
  }
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
  if (R < 0 || hidden <= 0 || hidden % NC != 0)
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  auto run = [&](auto launcher) {
    return launcher(E, static_cast<const bf16*>(x),
                    static_cast<const float*>(nw),
                    static_cast<const float*>(nb),
                    static_cast<const bf16*>(w1), static_cast<const bf16*>(w3),
                    static_cast<const bf16*>(w2), static_cast<bf16*>(out), R,
                    hidden, eps, st);
  };
  if (kind == kLayerNorm) return run(launch_kind<kLayerNorm>);
  if (kind == kRmsNorm) return run(launch_kind<kRmsNorm>);
  return int(cudaErrorInvalidValue);
}
