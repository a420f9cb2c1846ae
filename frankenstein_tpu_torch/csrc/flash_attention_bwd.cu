// K7 slab backward: the gradients of flash_attention.cu's slab-causal
// mode. Modes dense (K7 unmasked) and positions (K6) run the wgmma passes
// of flash_attention_dense.cu; this file's C entry point dispatches them
// there.
//
// Replaces frankenstein_tpu/ops/pallas/block_attention.py:_bwd (kernel
// bodies _bwd_dq_tri_kernel and _bwd_dkv_tri_kernel) and _bwd_packed
// (kernels _bwd_dq_packed_kernel, _bwd_dkv_packed_kernel, from
// _slab_attention_bwd: K7 slab). Contract:
//   q, k, v   [B, T, E] bf16, as the forward took them
//   sid       unused by mode slab (the C entry point takes K6's slab ids)
//   out       [B, T, E] bf16, the forward's output
//   lse       [B, H, T] f32, the forward's per-row logsumexp
//   dout      [B, T, E] bf16, the gradient of out
//   delta     [B, H, T] f32 workspace: rowsum(f32(out) * f32(dout)) per
//             head, written by the dq pass and read by the dk/dv pass
//   dq, dk, dv [B, T, E] bf16
// The visible pairs are the forward's (flash_mask.cuh).
//
// What it computes, with the JAX kernels' rounding points:
//   s = (q k^T) * scale, p = exp(s - lse) (0 where masked),
//   dp = dout v^T, ds = bf16(p * (dp - delta) * scale),
//   dq = ds k, dk = ds^T q, dv = bf16(p)^T dout,
// every product bf16 x bf16 with f32 accumulation, and dq, dk, dv rounded
// once to bf16. The recomputed p uses the forward's own score expression,
// so its rows sum to 1 against the forward's lse.
//
// Two passes, no atomics, a fixed order of every sum: deterministic, as K4
// (slab_rope_attention_bwd.cu), whose layout this follows without RoPE.
//   * dq pass: one CTA per (batch, head, 128-row query block), 8 warps of 16
//     rows. q and dout are held as mma A-fragments. The CTA first writes
//     delta for its rows (fused here, as K4 fuses it). The key loop stops at
//     the end of the block's last slab; a warp skips tiles past its rows'
//     slabs and masks only tiles that reach past its least slab.
//   * dk/dv pass: one CTA per (batch, head, 128-key block), 8 warps of 16
//     keys, k and v held as A-fragments. It mirrors the pruning: it starts
//     at the first query tile of the block's first slab. Runs after the dq
//     pass on the same stream, which orders the delta it reads.
// The score accumulators are re-packed in registers as the bf16
// A-fragments of the next product (mma_bf16.cuh), so s, p, dp and ds never
// touch shared memory; the operands a product needs transposed (k in the
// dq pass, q and dout in the dk/dv pass) are stored a second time,
// transposed, as their tiles load.
//
// What bounds it on an H100: 3 products of D per visible (query, key) pair
// in the dq pass and 4 in the dk/dv pass, against the forward's 2, plus an
// exp in each pass; at D = 32 that is tensor-core throughput and f32 work
// per score, not bytes. The wgmma / TMA design of flash_attention_dense.cu
// is later work here (ROADMAP: fold K7 slab onto K4's passes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
using fk::repack_a;

constexpr int BM = 128;              // rows a CTA owns: queries (dq), keys (dk/dv)
constexpr int BN = 64;               // columns per inner tile: keys (dq), queries (dk/dv)
constexpr int NWARPS = BM / 16;      // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ sid,
                  const bf16* __restrict__ out, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, int T, int H, int P, float scale) {
  constexpr int CH = D / 8;      // 16-byte chunks per head row
  constexpr int LDR = D + 8;     // row stride of row-major tiles
  constexpr int LDT = BN + 8;    // row stride of the transposed K tile
  constexpr int NT = BN / 8;     // score n-tiles per key tile
  constexpr int OT = D / 8;      // dq n-tiles
  // prologue: sQ, sdO [BM][LDR]; loop: sK, sV [BN][LDR], sKt [D][LDT]
  constexpr int PRO = 2 * BM * LDR, LOOP = 2 * BN * LDR + D * LDT;
  __shared__ __align__(16) bf16 smem[PRO > LOOP ? PRO : LOOP];
  __shared__ float sDelta[BM];
  static_assert(MODE == fk::kSlab, "modes dense and positions run the "
                "wgmma passes of flash_attention_dense.cu");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const size_t base = size_t(b) * T * E + size_t(h) * D;
  const size_t lbase = (size_t(b) * H + h) * T;

  bf16* sQ = smem;
  bf16* sdO = smem + BM * LDR;
  for (int idx = tid; idx < BM * CH; idx += NTHREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const size_t off = base + size_t(q0 + r) * E + c;
    *reinterpret_cast<uint4*>(sQ + r * LDR + c) =
        *reinterpret_cast<const uint4*>(q + off);
    *reinterpret_cast<uint4*>(sdO + r * LDR + c) =
        *reinterpret_cast<const uint4*>(dout + off);
  }
  if (tid < BM) {   // delta = rowsum(out * dout): f32 products, summed in order
    const size_t row = base + size_t(q0 + tid) * E;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      uint4 ro = *reinterpret_cast<const uint4*>(out + row + c);
      uint4 rd = *reinterpret_cast<const uint4*>(dout + row + c);
      const bf16* o8 = reinterpret_cast<const bf16*>(&ro);
      const bf16* d8 = reinterpret_cast<const bf16*>(&rd);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(o8[i]),
                                       __bfloat162float(d8[i])));
    }
    sDelta[tid] = acc;
    delta[lbase + q0 + tid] = acc;
  }
  __syncthreads();

  // the warp's 16 q rows and dout rows as A-fragments
  uint32_t qa[D / 16][4], da[D / 16][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = lds32(sQ + (wr + g) * LDR + c);
    qa[kk][1] = lds32(sQ + (wr + g + 8) * LDR + c);
    qa[kk][2] = lds32(sQ + (wr + g) * LDR + c + 8);
    qa[kk][3] = lds32(sQ + (wr + g + 8) * LDR + c + 8);
    da[kk][0] = lds32(sdO + (wr + g) * LDR + c);
    da[kk][1] = lds32(sdO + (wr + g + 8) * LDR + c);
    da[kk][2] = lds32(sdO + (wr + g) * LDR + c + 8);
    da[kk][3] = lds32(sdO + (wr + g + 8) * LDR + c + 8);
  }

  const int row_first = q0 + wr;
  const int row0 = row_first + g, row1 = row0 + 8;   // this thread's rows
  const int slab0 = fk::slab_of<MODE>(sid, row0, P);
  const int slab1 = fk::slab_of<MODE>(sid, row1, P);
  const int warp_lo = row_first / P;
  const int warp_hi = (row_first + 15) / P;
  const int kend = min(T, ((q0 + BM - 1) / P + 1) * P);
  const float lse0 = lse[lbase + row0], lse1 = lse[lbase + row1];
  const float dl0 = sDelta[wr + g], dl1 = sDelta[wr + g + 8];

  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  bf16* sK = smem;
  bf16* sV = smem + BN * LDR;
  bf16* sKt = smem + 2 * BN * LDR;
  for (int k0 = 0; k0 < kend; k0 += BN) {
    // least / greatest slab of the key tile
    const int2 kr = make_int2(k0 / P, (k0 + BN - 1) / P);
    __syncthreads();  // prologue fragments / previous tiles consumed
    for (int idx = tid; idx < BN * CH; idx += NTHREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const size_t off = base + size_t(k0 + r) * E + c;
      const uint4 kv = *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(sK + r * LDR + c) = kv;
      const bf16* k8 = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sKt[(c + i) * LDT + r] = k8[i];
      *reinterpret_cast<uint4*>(sV + r * LDR + c) =
          *reinterpret_cast<const uint4*>(v + off);
    }
    __syncthreads();
    if (kr.x > warp_hi) continue;  // warp-uniform

    // S = Q K^T and dP = dO V^T: rows (g, g+8), keys 8j + 2t + {0, 1}
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const bf16* krow = sK + (j * 8 + g) * LDR + 2 * t;
      const bf16* vrow = sV + (j * 8 + g) * LDR + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[j], qa[kk], lds32(krow + kk * 16), lds32(krow + kk * 16 + 8));
        mma_bf16(dp[j], da[kk], lds32(vrow + kk * 16),
                 lds32(vrow + kk * 16 + 8));
      }
    }

    // ds = p * (dp - delta) * scale, in place of s
    const bool need_mask = kr.y > warp_lo;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = __expf(s[j][e] * scale - lse0);
        float p1 = __expf(s[j][2 + e] * scale - lse1);
        if (need_mask) {
          const int key_slab = (k0 + j * 8 + 2 * t + e) / P;
          if (key_slab > slab0) p0 = 0.f;
          if (key_slab > slab1) p1 = 0.f;
        }
        s[j][e] = (p0 * (dp[j][e] - dl0)) * scale;
        s[j][2 + e] = (p1 * (dp[j][2 + e] - dl1)) * scale;
      }
    }

    // dQ += dS K: the ds tiles 2kk, 2kk+1 are the A-fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      repack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const bf16* ktrow = sKt + (n * 8 + g) * LDT + kk * 16 + 2 * t;
        mma_bf16(acc[n], a, lds32(ktrow), lds32(ktrow + 8));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + base + size_t(row0) * E + c) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(dq + base + size_t(row1) * E + c) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ sid,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int T, int H, int P, float scale) {
  constexpr int CH = D / 8;
  constexpr int LDR = D + 8;
  constexpr int LDT = BN + 8;
  constexpr int NT = BN / 8;     // score n-tiles per query tile
  constexpr int OT = D / 8;      // dk / dv n-tiles
  // prologue: sK, sV [BM][LDR]; loop: sQ, sdO [BN][LDR], sQt, sdOt [D][LDT]
  constexpr int PRO = 2 * BM * LDR, LOOP = 2 * BN * LDR + 2 * D * LDT;
  __shared__ __align__(16) bf16 smem[PRO > LOOP ? PRO : LOOP];
  __shared__ float sL[BN], sDl[BN];
  static_assert(MODE == fk::kSlab, "modes dense and positions run the "
                "wgmma passes of flash_attention_dense.cu");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const size_t base = size_t(b) * T * E + size_t(h) * D;
  const size_t lbase = (size_t(b) * H + h) * T;

  bf16* sK = smem;
  bf16* sV = smem + BM * LDR;
  for (int idx = tid; idx < BM * CH; idx += NTHREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const size_t off = base + size_t(j0 + r) * E + c;
    *reinterpret_cast<uint4*>(sK + r * LDR + c) =
        *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(sV + r * LDR + c) =
        *reinterpret_cast<const uint4*>(v + off);
  }
  __syncthreads();

  // the warp's 16 k rows and v rows as A-fragments
  uint32_t ka[D / 16][4], va[D / 16][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    ka[kk][0] = lds32(sK + (wr + g) * LDR + c);
    ka[kk][1] = lds32(sK + (wr + g + 8) * LDR + c);
    ka[kk][2] = lds32(sK + (wr + g) * LDR + c + 8);
    ka[kk][3] = lds32(sK + (wr + g + 8) * LDR + c + 8);
    va[kk][0] = lds32(sV + (wr + g) * LDR + c);
    va[kk][1] = lds32(sV + (wr + g + 8) * LDR + c);
    va[kk][2] = lds32(sV + (wr + g) * LDR + c + 8);
    va[kk][3] = lds32(sV + (wr + g + 8) * LDR + c + 8);
  }

  const int key_first = j0 + wr;
  const int key0 = key_first + g, key1 = key0 + 8;  // this thread's keys
  const int kslab0 = fk::slab_of<MODE>(sid, key0, P);
  const int kslab1 = fk::slab_of<MODE>(sid, key1, P);
  // least / greatest slab of the warp's keys, and the first query tile
  const int warp_lo = key_first / P;
  const int warp_hi = (key_first + 15) / P;
  const int qstart = ((j0 / P) * P / BN) * BN;

  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  bf16* sQ = smem;
  bf16* sdO = smem + BN * LDR;
  bf16* sQt = smem + 2 * BN * LDR;
  bf16* sdOt = sQt + D * LDT;
  for (int q0 = qstart; q0 < T; q0 += BN) {
    // least / greatest slab of the query tile
    const int2 qr = make_int2(q0 / P, (q0 + BN - 1) / P);
    __syncthreads();  // prologue fragments / previous tiles consumed
    for (int idx = tid; idx < BN * CH; idx += NTHREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const size_t off = base + size_t(q0 + r) * E + c;
      const uint4 qv = *reinterpret_cast<const uint4*>(q + off);
      const uint4 dr = *reinterpret_cast<const uint4*>(dout + off);
      *reinterpret_cast<uint4*>(sQ + r * LDR + c) = qv;
      *reinterpret_cast<uint4*>(sdO + r * LDR + c) = dr;
      const bf16* q8 = reinterpret_cast<const bf16*>(&qv);
      const bf16* d8 = reinterpret_cast<const bf16*>(&dr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sQt[(c + i) * LDT + r] = q8[i];
        sdOt[(c + i) * LDT + r] = d8[i];
      }
    }
    if (tid < BN) {
      sL[tid] = lse[lbase + q0 + tid];
      sDl[tid] = delta[lbase + q0 + tid];
    }
    __syncthreads();
    if (qr.y < warp_lo) continue;  // warp-uniform

    // S^T = K Q^T and dP^T = V dO^T: keys (g, g+8), queries 8j + 2t + {0, 1}
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      const bf16* qrow = sQ + (j * 8 + g) * LDR + 2 * t;
      const bf16* drow = sdO + (j * 8 + g) * LDR + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(st[j], ka[kk], lds32(qrow + kk * 16), lds32(qrow + kk * 16 + 8));
        mma_bf16(dpt[j], va[kk], lds32(drow + kk * 16),
                 lds32(drow + kk * 16 + 8));
      }
    }

    // p^T in place of st, ds^T = p^T * (dp^T - delta) * scale in place of dpt
    const bool need_mask = qr.x < warp_hi;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const float l = sL[col], dl = sDl[col];
        float p0 = __expf(st[j][e] * scale - l);
        float p1 = __expf(st[j][2 + e] * scale - l);
        if (need_mask) {
          const int q_slab = (q0 + col) / P;
          if (q_slab < kslab0) p0 = 0.f;
          if (q_slab < kslab1) p1 = 0.f;
        }
        st[j][e] = p0;
        st[j][2 + e] = p1;
        dpt[j][e] = (p0 * (dpt[j][e] - dl)) * scale;
        dpt[j][2 + e] = (p1 * (dpt[j][2 + e] - dl)) * scale;
      }
    }

    // dV += bf16(P)^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      repack_a(pa, st[2 * kk], st[2 * kk + 1]);
      repack_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const bf16* dorow = sdOt + (n * 8 + g) * LDT + kk * 16 + 2 * t;
        const bf16* qtrow = sQt + (n * 8 + g) * LDT + kk * 16 + 2 * t;
        mma_bf16(dva[n], pa, lds32(dorow), lds32(dorow + 8));
        mma_bf16(dka[n], dsa, lds32(qtrow), lds32(qtrow + 8));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + 2 * t;
    const size_t off0 = base + size_t(key0) * E + c;
    const size_t off1 = base + size_t(key1) * E + c;
    *reinterpret_cast<uint32_t*>(dv + off0) = pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(dv + off1) = pack_bf16(dva[n][2], dva[n][3]);
    *reinterpret_cast<uint32_t*>(dk + off0) = pack_bf16(dka[n][0], dka[n][1]);
    *reinterpret_cast<uint32_t*>(dk + off1) = pack_bf16(dka[n][2], dka[n][3]);
  }
}

template <int D, int MODE>
int launch_bwd(dim3 grid, cudaStream_t st, const bf16* q, const bf16* k,
               const bf16* v, const int* sid, const bf16* out,
               const bf16* dout, const float* lse, float* delta, bf16* dq,
               bf16* dk, bf16* dv, int T, int H, int P, float scale) {
  flash_attn_bwd_dq<D, MODE><<<grid, NTHREADS, 0, st>>>(
      q, k, v, sid, out, dout, lse, delta, dq, T, H, P, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_attn_bwd_dkv<D, MODE><<<grid, NTHREADS, 0, st>>>(
      q, k, v, sid, dout, lse, delta, dk, dv, T, H, P, scale);
  return int(cudaGetLastError());
}


}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda/flash_attention.py):
// T % 128 == 0, D in {32, 64}, contiguous bf16 [B, T, E] tensors, f32
// [B, H, T] lse and delta, P > 0 for kSlab, an int32 [B, T] sid for
// kPositions. Launches the dq pass, then the dk/dv pass, on ``stream``.
extern "C" int fk_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* sid,
    const void* out, const void* dout, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int B, int T, int H, int D, int mode,
    int P, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T % BM != 0 || (mode == fk::kSlab && P <= 0) ||
      (mode == fk::kPositions && sid == nullptr))
    return int(cudaErrorInvalidValue);
  if (mode == fk::kDense)
    return fk::flash_dense_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv, B,
                               T, H, D, scale, st);
  if (mode == fk::kPositions)
    return fk::flash_positions_bwd(q, k, v, sid, out, dout, lse, delta, dq,
                                   dk, dv, B, T, H, D, scale, st);
  if (mode != fk::kSlab) return int(cudaErrorInvalidValue);
  const dim3 grid(T / BM, H, B);
  auto run = [&](auto launch) {
    return launch(grid, st, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  nullptr, static_cast<const bf16*>(out),
                  static_cast<const bf16*>(dout),
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv), T, H, P, scale);
  };
  if (D == 32) return run(launch_bwd<32, fk::kSlab>);
  if (D == 64) return run(launch_bwd<64, fk::kSlab>);
  return int(cudaErrorInvalidValue);
}

namespace fk {

int flash_masked_bwd_occupancy(int mode, int pass, int D, int* regs,
                               int* ctas) {
  auto read = [&](auto kernel) {
    return kernel_occupancy(kernel, NTHREADS, 0, regs, ctas);
  };
  auto of_mode = [&](auto dq_kernel, auto dkv_kernel) {
    if (pass == 1) return read(dq_kernel);
    if (pass == 2) return read(dkv_kernel);
    return int(cudaErrorInvalidValue);
  };
  if (mode == kSlab && D == 32)
    return of_mode(flash_attn_bwd_dq<32, kSlab>, flash_attn_bwd_dkv<32, kSlab>);
  if (mode == kSlab && D == 64)
    return of_mode(flash_attn_bwd_dq<64, kSlab>, flash_attn_bwd_dkv<64, kSlab>);
  return int(cudaErrorInvalidValue);
}

}  // namespace fk
