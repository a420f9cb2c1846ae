// K8: the decode step's head in one chain of three kernels: the final
// LayerNorm, the tied LM head, the top-k (ties to the lowest vocab index)
// and the exact full-vocab logsumexp. The [B, V] logits never reach device
// memory.
//
// Replaces frankenstein_tpu/ops/pallas/lm_head_topk.py:lm_head_topk (kernel
// _kernel, its pallas_call at :98), reached from GPT.decode_step_topk. Same
// arithmetic:
//   h       = bf16(((x - mu) * rsqrt(var + eps)) * w + b), statistics and
//             affine in f32, rounded to the table's dtype (the JAX kernel's
//             h.astype(w_ref.dtype)); eps as given
//   logits  = h . wte[v], bf16 products summed in f32
//   top-k   = the k largest logits, ties to the lowest vocab index
//   logz    = log sum_v exp(logits[v]), exact
// Contract:
//   x       [B, E] bf16, any B, E % 8 == 0
//   ln_w/b  [E] f32
//   wte     [V, E] bf16, read as stored (no transposed copy)
//   vals    [B, k] f32, descending; idx [B, k] int64; logz [B] f32; k <= 32
//   scratch h [B16, E16] bf16, cand_val / cand_idx [B, n_tiles, k],
//           tile_m / tile_se [B, n_tiles] (n_tiles = ceil(V / VT)),
//           allocated by the wrapper (ops/cuda/lm_head_topk.py)
//
// What bounds it on an H100: the table, 2 V E bytes (77.3 MB at GPT-2's
// 50304 x 768), against 2 B E V operations (9.9 GFLOP at B=128), so bytes
// bound it at every batch up to several hundred rows. The design reads the
// table once a step, whatever B is:
//   * a pre-pass (one warp per row) writes h, zero-padded to [B16, E16]; it
//     stays in L2 (196 KB at B=128);
//   * the main kernel gives each CTA one slab of VT = 128 vocab rows,
//     copied into shared memory once with cp.async (198 KB at E=768, the
//     widest E that fits; wider tables take the plain route, as the
//     wrapper's gate says): the slab's rows are exactly the column-major B
//     operand of mma.sync, so every B-fragment is one 32-bit shared load;
//   * each 16-row batch tile of h is copied into shared memory once a CTA
//     (the next while the current tile's top-k runs), and each of the VT / 8
//     warps takes its A-fragments there for mma.sync m16n8k16 bf16 with f32
//     accumulation over its 8 vocab rows. (The first version read the
//     A-fragments from L2 in every warp: 618 MB of L2 traffic a step at
//     B=128, and twice this kernel's time.)
//   * the tile's logits go through shared memory, where one warp per batch
//     row takes (max, sum-exp) and the top-k by k passes of a warp argmax
//     on order-preserving integer keys (redux.sync: the largest key, then
//     the lowest index among the lanes that hold it);
//   * a merge kernel (one CTA per batch row) takes the top-k of the
//     n_tiles * k candidates with the same rule (the global top-k under the
//     order (value desc, index asc) is always among the tiles' own top-k),
//     and combines the tiles' (max, sum-exp) into logz.
// Latency, not bandwidth, holds it at about 10x its bound (PERF.md): one
// CTA an SM, the slab's load not overlapped with compute, and each warp's
// mma and top-k chains serial. A pipelined slab, wgmma and a persistent grid
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fk::bf16;
using fk::lds32;
using fk::mma_bf16;

constexpr int BT = 16;                    // batch rows per mma tile
constexpr int VT = 128;                   // vocab rows per CTA (a slab)
constexpr int SENT = 0x7fffffff;          // index of an empty candidate
constexpr int MERGE_THREADS = 256;
constexpr int SMEM_MAX = 232448;          // the opt-in limit of a block

__device__ __forceinline__ void cp_async16(bf16* smem, const bf16* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Order-preserving unsigned key of a float (larger float, larger key), so
// a warp takes a max with one redux.sync. -0 is added to +0 first, so the
// two zeros tie as they compare. Key 0 marks an empty slot and ranks last.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The warp's best (key, index): the largest key, then the lowest index.
// Every lane gets it; the lane that holds it can remove it, indices being
// unique.
__device__ __forceinline__ void warp_best(uint32_t& key, int& idx) {
  const uint32_t wk = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == wk ? idx : SENT);
  key = wk;
}

// Pre-pass: h [B16, E16] bf16, one warp per row, zero outside [B, E).
__global__ void lm_head_norm(const bf16* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ bias,
                             bf16* __restrict__ h, int B, int B16, int E,
                             int E16, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B16) return;
  bf16* hrow = h + size_t(row) * E16;
  if (row >= B) {
    for (int c = lane; c < E16; c += 32) hrow[c] = __float2bfloat16_rn(0.f);
    return;
  }
  const bf16* xrow = x + size_t(row) * E;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += __bfloat162float(xrow[c]);
  const float mu = __fdiv_rn(warp_sum(s), float(E));
  float q = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = __fsub_rn(__bfloat162float(xrow[c]), mu);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(warp_sum(q), float(E));
  const float rs = __fdiv_rn(1.f, sqrtf(__fadd_rn(var, eps)));
  for (int c = lane; c < E16; c += 32) {
    float v = 0.f;
    if (c < E) {
      const float n = __fmul_rn(__fsub_rn(__bfloat162float(xrow[c]), mu), rs);
      v = __fadd_rn(__fmul_rn(n, w[c]), bias[c]);
    }
    hrow[c] = __float2bfloat16_rn(v);
  }
}

// Main kernel: one CTA per VT-row vocab slab; writes each batch row's k
// best (value, index) of the slab and the slab's (max, sum-exp).
__global__ void __launch_bounds__(VT * 4)
lm_head_tiles(const bf16* __restrict__ h, const bf16* __restrict__ wte,
              float* __restrict__ cand_val, int* __restrict__ cand_idx,
              float* __restrict__ tile_m, float* __restrict__ tile_se, int B,
              int V, int E, int E16, int k, int n_tiles) {
  constexpr int NWARPS = VT / 8;            // 8 vocab rows per warp
  constexpr int NTHREADS = NWARPS * 32;
  constexpr int LDL = VT + 4;               // row stride of the logits tile
  constexpr int PER = VT / 32;              // logits per lane in the top-k
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDW = E16 + 8;                  // conflict-free A/B-fragments
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sH = sW + size_t(VT) * LDW;         // the batch tile of h
  float* sL = reinterpret_cast<float*>(sH + size_t(BT) * LDW);   // logits

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, v0 = tile * VT;
  const int ch = E / 8, ch16 = E16 / 8;

  // h is zero-padded to [B16, E16]: a batch tile copies as it is
  auto load_h = [&](int bt) {
    for (int i = tid; i < BT * ch16; i += NTHREADS) {
      const int r = i / ch16, c = i % ch16;
      cp_async16(sH + r * LDW + c * 8, h + size_t(bt * BT + r) * E16 + c * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // the slab, once; rows past V and columns past E are zero
  for (int i = tid; i < VT * ch16; i += NTHREADS) {
    const int r = i / ch16, c = i % ch16;
    bf16* dst = sW + r * LDW + c * 8;
    if (v0 + r < V && c < ch)
      cp_async16(dst, wte + size_t(v0 + r) * E + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  load_h(0);

  const bf16* w0 = sW + (warp * 8 + g) * LDW + 2 * t;   // the warp's n-tile
  const bf16* a0 = sH + g * LDW + 2 * t;                // rows g, g + 8
  const bf16* a1 = a0 + 8 * LDW;
  const int ksteps = E16 / 16;
  const int n_bt = (B + BT - 1) / BT;
  for (int bt = 0; bt < n_bt; ++bt) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();                        // h's tile (and the slab) in

    // two accumulators (even and odd k-steps) halve the mma chain
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int kk = 0; kk < ksteps; ++kk) {
      const int o = kk * 16;
      const uint32_t a[4] = {lds32(a0 + o), lds32(a1 + o), lds32(a0 + o + 8),
                             lds32(a1 + o + 8)};
      mma_bf16(acc[kk & 1], a, lds32(w0 + o), lds32(w0 + o + 8));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = warp * 8 + 2 * t + e;
      sL[g * LDL + c] = acc[0][e] + acc[1][e];
      sL[(g + 8) * LDL + c] = acc[0][2 + e] + acc[1][2 + e];
    }
    __syncthreads();                        // sL written, sH read
    if (bt + 1 < n_bt) load_h(bt + 1);

    for (int r = warp; r < BT; r += NWARPS) {
      const int row = bt * BT + r;
      if (row >= B) break;                  // warp-uniform
      float val[PER];
      uint32_t key[PER];
      int col[PER];
      uint32_t mk = 0u;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int c = lane + 32 * p;
        const bool live = v0 + c < V;
        val[p] = live ? sL[r * LDL + c] : -INFINITY;
        key[p] = live ? order_key(val[p]) : 0u;
        col[p] = live ? v0 + c : SENT;
        mk = max(mk, key[p]);
      }
      const float m = key_value(__reduce_max_sync(0xffffffffu, mk));
      float se = 0.f;
#pragma unroll
      for (int p = 0; p < PER; ++p) se += expf(val[p] - m);
      se = warp_sum(se);
      const size_t slot = size_t(row) * n_tiles + tile;
      if (lane == 0) {
        tile_m[slot] = m;
        tile_se[slot] = se;
      }
      for (int i = 0; i < k; ++i) {
        uint32_t bk = 0u;
        int bi = SENT;
#pragma unroll
        for (int p = 0; p < PER; ++p)
          if (key[p] > bk || (key[p] == bk && col[p] < bi)) {
            bk = key[p];
            bi = col[p];
          }
        warp_best(bk, bi);
        if (lane == 0) {
          cand_val[slot * k + i] = bi == SENT ? -INFINITY : key_value(bk);
          cand_idx[slot * k + i] = bi;
        }
#pragma unroll
        for (int p = 0; p < PER; ++p)
          if (col[p] == bi && bi != SENT) {
            key[p] = 0u;
            col[p] = SENT;
          }
      }
    }
    // the next round's first barrier orders these sL reads before its
    // writes
  }
}

// Merge: one CTA per batch row. The row's n_tiles * k candidates go to
// shared memory as (key, index); k passes of a block argmax take the top-k
// in order, the thread that holds each winner removing it.
__global__ void __launch_bounds__(MERGE_THREADS)
lm_head_merge(const float* __restrict__ cand_val,
              const int* __restrict__ cand_idx,
              const float* __restrict__ tile_m,
              const float* __restrict__ tile_se, float* __restrict__ vals,
              long long* __restrict__ idx, float* __restrict__ logz,
              int n_tiles, int k) {
  constexpr int NW = MERGE_THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[NW];
  __shared__ uint32_t red_k[NW];
  __shared__ int red_i[NW];
  const int n = n_tiles * k, row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  uint32_t* sk = reinterpret_cast<uint32_t*>(smem);
  int* si = reinterpret_cast<int*>(smem + size_t(n) * sizeof(uint32_t));
  const size_t base = size_t(row) * n;
  for (int j = tid; j < n; j += MERGE_THREADS) {
    si[j] = cand_idx[base + j];
    sk[j] = si[j] == SENT ? 0u : order_key(cand_val[base + j]);
  }

  // logz = mg + log(sum_j se_j exp(m_j - mg)), as lm_head_topk.py:130-131
  const float* m = tile_m + size_t(row) * n_tiles;
  const float* se = tile_se + size_t(row) * n_tiles;
  uint32_t mk = 0u;
  for (int j = tid; j < n_tiles; j += MERGE_THREADS)
    mk = max(mk, order_key(m[j]));
  mk = __reduce_max_sync(0xffffffffu, mk);
  if (lane == 0) red_k[warp] = mk;
  __syncthreads();
  for (int w = 0; w < NW; ++w) mk = max(mk, red_k[w]);
  const float mg = key_value(mk);
  float s = 0.f;
  for (int j = tid; j < n_tiles; j += MERGE_THREADS)
    s += se[j] * expf(m[j] - mg);
  s = warp_sum(s);
  if (lane == 0) red_v[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < NW; ++w) total += red_v[w];
    logz[row] = mg + logf(total);
  }

  for (int out = 0; out < k; ++out) {
    uint32_t bk = 0u;
    int bi = SENT, bp = 0;
    for (int j = tid; j < n; j += MERGE_THREADS)
      if (sk[j] > bk || (sk[j] == bk && si[j] < bi)) {
        bk = sk[j];
        bi = si[j];
        bp = j;
      }
    uint32_t wk = bk;
    int wi = bi;
    warp_best(wk, wi);
    __syncthreads();                        // red_* of the last pass read
    if (lane == 0) {
      red_k[warp] = wk;
      red_i[warp] = wi;
    }
    __syncthreads();
    uint32_t gk = red_k[0];
    int gi = red_i[0];
    for (int w = 1; w < NW; ++w)
      if (red_k[w] > gk || (red_k[w] == gk && red_i[w] < gi)) {
        gk = red_k[w];
        gi = red_i[w];
      }
    if (gi != SENT && bi == gi) {           // the owner removes it
      sk[bp] = 0u;
      si[bp] = SENT;
    }
    if (tid == 0) {
      vals[size_t(row) * k + out] = gi == SENT ? -INFINITY : key_value(gk);
      idx[size_t(row) * k + out] = gi;
    }
    __syncthreads();                        // the removal is seen
  }
}

size_t tile_smem(int E16) {
  return size_t(VT + BT) * (E16 + 8) * sizeof(bf16) +
         size_t(BT) * (VT + 4) * sizeof(float);
}

int launch_tiles(const bf16* h, const bf16* wte, float* cv, int* ci,
                 float* tm, float* tse, int B, int V, int E, int E16, int k,
                 int n_tiles, cudaStream_t st) {
  auto kernel = lm_head_tiles;
  static bool opted_in = false;   // above 48 KB only after opting in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return int(err);
    opted_in = true;
  }
  const size_t smem = tile_smem(E16);
  if (smem > size_t(SMEM_MAX)) return int(cudaErrorInvalidValue);
  kernel<<<n_tiles, VT * 4, smem, st>>>(h, wte, cv, ci, tm, tse, B, V, E, E16,
                                        k, n_tiles);
  return int(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda/lm_head_topk.py), whose
// _plan sizes the scratch for VT-row slabs and refuses an E too wide for them.
extern "C" int fk_lm_head_topk(const void* x, const void* ln_w,
                               const void* ln_b, const void* wte, void* h,
                               void* cand_val, void* cand_idx, void* tile_m,
                               void* tile_se, void* vals, void* idx,
                               void* logz, int B, int E, int V, int k,
                               float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || E <= 0 || E % 8 || k <= 0 || k > 32 || k > V)
    return int(cudaErrorInvalidValue);
  const int B16 = (B + BT - 1) / BT * BT, E16 = (E + 15) / 16 * 16;
  const int n_tiles = (V + VT - 1) / VT;
  lm_head_norm<<<(B16 * 32 + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(h), B, B16, E, E16,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  auto* hh = static_cast<const bf16*>(h);
  auto* ww = static_cast<const bf16*>(wte);
  auto* cv = static_cast<float*>(cand_val);
  auto* ci = static_cast<int*>(cand_idx);
  auto* tm = static_cast<float*>(tile_m);
  auto* tse = static_cast<float*>(tile_se);
  const int rc = launch_tiles(hh, ww, cv, ci, tm, tse, B, V, E, E16, k,
                              n_tiles, st);
  if (rc != 0) return rc;

  static bool merge_opted_in = false;
  if (!merge_opted_in) {
    err = cudaFuncSetAttribute(lm_head_merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX - 1024);
    if (err != cudaSuccess) return int(err);
    merge_opted_in = true;
  }
  const size_t merge_smem = size_t(n_tiles) * k * 8;   // a key and an index
  if (merge_smem > size_t(SMEM_MAX - 1024)) return int(cudaErrorInvalidValue);
  lm_head_merge<<<B, MERGE_THREADS, merge_smem, st>>>(
      cv, ci, tm, tse, static_cast<float*>(vals),
      static_cast<long long*>(idx), static_cast<float*>(logz), n_tiles, k);
  return int(cudaGetLastError());
}
