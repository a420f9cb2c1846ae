// K8: the decode step's head for Hopper (sm_90a): the final LayerNorm, the
// tied LM head, the top-k (ties to the lowest vocab index) and the exact
// full-vocab logsumexp, in two launches. The [B, V] logits never reach
// device memory.
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
//   x       [B, E] bf16, any B, E % 8 == 0 (any width: E is streamed)
//   ln_w/b  [E] f32
//   wte     [V, E] bf16, read as stored (no transposed copy), any V
//   vals    [B, k] f32, descending; idx [B, k] int64; logz [B] f32;
//           1 <= k <= 32, k <= V
//   scratch h [B, E] bf16; cand [B, G, KP] (order key, index) pairs (KP =
//           k rounded up to even) and part [B, G] (max, sum-exp) pairs, one
//           list a CTA and batch row; bar [64] int32, zero before the first
//           call (the kernel leaves it zero); G the grid, at most one CTA an
//           SM; all allocated and kept by the wrapper
//           (ops/cuda/lm_head_topk.py)
// Two launches on one stream, no float atomics and a fixed order of every
// sum and every selection: two calls are bitwise equal.
//
// What bounds it on an H100: the table, 2 V E bytes (77.3 MB at GPT-2's
// 50304 x 768), against 2 B E V operations (9.9 GFLOP at B=128: 0.010 ms
// of tensor cores), so bytes bound it at every batch up to several hundred
// rows: 0.0231 ms at 3.35 TB/s. The design streams the table once a call
// (once a chunk of 128 batch rows beyond 128), whatever B is, and hides
// what it can under that stream:
//   * pre-pass: one warp a batch row writes h (the JAX kernel's rounding
//     point); h stays in L2 (196 KB at B=128);
//   * main kernel, a persistent cooperative grid of G CTAs, one an SM: CTA
//     c walks a contiguous range of 128-row vocab blocks in ascending
//     order. A producer warp streams, by TMA with the 128-byte swizzle,
//     64-column chunks of the block's table rows together with the same
//     columns of h (rows past V or B and columns past E arrive as zeros)
//     through a ring of as many stages, up to eight, as shared memory holds;
//   * the vocab is M and the batch N: each of two consumer warpgroups
//     runs wgmma m64nNk16 with both operands K-major as TMA stored them,
//     its 64 table rows against the N batch rows (B rounded up to one of
//     the instances' widths, 8 to 128, in batch chunks of 128 beyond). Its
//     accumulator, N / 2 f32 a thread, stays in registers across E, then
//     goes to a staging tile in shared memory, one batch column's 128
//     logits side by side, and the consumers go on to the next block;
//   * two epilogue warpgroups fold the staged block while the next
//     block's products run: each of their warps owns N / 8 batch rows and
//     takes them a row at a time, four logits a lane. The block's max (one
//     redux.sync) moves the row's running max; each lane keeps its own
//     sum-exp of the row in shared memory (no sum across lanes until the
//     walk ends). While the warp's best remaining logit beats the k-th
//     entry of the row's sorted top-k list (shared memory) under (value
//     desc, index asc) it is inserted: redux.sync for the best, a ballot
//     for its place, the shift through shared memory. Two named barriers
//     hand the tile over (drained, filled). Rows past V are masked by
//     index, out of both the top-k and the sum-exp;
//   * after its range each CTA writes its k candidates and (m, se) a row;
//     a grid barrier (an arrival count that the last CTA resets), then
//     each batch row is merged by one warp: its G sorted lists, read into
//     shared memory by the whole CTA, give the top-k by k rounds of a warp
//     argmax over the lists' heads (redux.sync on the order key, then the
//     lowest index), and logz = mg + log(sum_c se_c exp(m_c - mg)) in a
//     fixed order.
// Seventeen warps hold ptxas to 96 registers a thread, which an
// accumulator of 128 batch rows (64) takes and one of 160 does not. Each
// vocab block re-reads h from L2, B / 128 of the table's bytes: the
// epilogue, not L2, binds first (PERF.md).
// What holds it above its bound (PERF.md, PR 16): the epilogue's chains of
// dependent warp-wide reductions and shared-memory round trips, a few
// hundred cycles a draw and up to k draws a row and block; at B=128 a
// warp's rows take longer than a block's products and stream. Tried on
// an H100 and not kept (no faster, or slower): the consumers folding the
// last block between their own chunks' products (0.092 ms at B=128), or
// after them (0.093), four rows' chains side by side in a warp, each
// lane's logits sorted and the block's draws merged by ranks, a row to
// each group of 8 lanes (0.123), one thread a batch row (0.17), lists in
// the lanes' registers, two accumulators for the short products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_host.cuh"
#include "hopper_blocks.cuh"

namespace {

using namespace fk;

constexpr int VB = 128;                  // vocab rows a block (2 x m64)
constexpr int KC = 64;                   // E columns a ring stage (128 B)
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int CWARPS = CONSUMERS / 32;
constexpr int FOLDERS = 256;             // two epilogue warpgroups
constexpr int PRODUCER = CONSUMERS + FOLDERS;   // the producer warp's first
constexpr int THREADS = PRODUCER + 32;
constexpr int WARPS = THREADS / 32;
constexpr int W_BYTES = VB * KC * 2;     // a stage's table rows
constexpr int LD = VB + 4;               // a staged batch column (floats)
constexpr int MAX_STAGES = 8;
constexpr int MAX_GRID = 256;            // 32 * MAXT lists a merged row
constexpr int MAXT = MAX_GRID / 32;
constexpr int SMEM_MAX = 232448;         // the opt-in limit of a block
constexpr int NORM_THREADS = 256;
constexpr int SENT = 0x7fffffff;         // index of an empty candidate
constexpr unsigned BARRIER_POLLS = 1u << 28;

// Batch width N of an instance: its accumulator (N / 2 f32 a thread), its
// share of a ring stage and the batch rows a consumer warp owns.
template <int N_>
struct Head {
  static constexpr int N = N_, Q = N_ / CWARPS;
  static constexpr int STAGE = W_BYTES + N * KC * 2;
};

template <int N>
struct HeadMma;

#include "lm_head_wgmma.cuh"

// Byte offsets of a CTA's shared memory from its 1024-aligned base: the
// ring, the staging tile (batch column c's logits at [c * LD]), each row's
// lanes' sum-exp ([row * 32 + lane]), its running max, its top-k list (key
// and index, [row * k + j]), the ring's barriers. The merge reuses [0,
// bytes) once the walk is done.
struct Layout {
  int staging, ps, m, key, idx, bar, bytes;
  __host__ __device__ Layout(int n, int stage, int st, int k) {
    staging = st * stage;
    ps = staging + n * LD * 4;
    m = ps + n * 32 * 4;
    key = m + n * 4;
    idx = key + n * k * 4;
    bar = idx + n * k * 4;
    bytes = bar + 2 * st * 8;
  }
};

// Ring stages an instance fits beside the rest of its shared memory at
// top-k k (0 if not two).
template <class C>
int stages(int k) {
  const Layout fixed(C::N, 0, 0, k);
  const int st = (SMEM_MAX - 1024 - fixed.bytes) / (C::STAGE + 16);
  return st < 2 ? 0 : (st < MAX_STAGES ? st : MAX_STAGES);
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

// (key a, index a) ranks before (key b, index b): larger value, then lower
// index.
__device__ __forceinline__ bool ahead(uint32_t ka, int ia, uint32_t kb,
                                      int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// The warp's best (key, index): the largest key, then the lowest index.
__device__ __forceinline__ void warp_best(uint32_t& key, int& idx) {
  const uint32_t wk = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == wk ? idx : SENT);
  key = wk;
}

// The consumers and the epilogue warps meet: the staging tile drained (1)
// and filled (2).
__device__ __forceinline__ void tile_drained() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS + FOLDERS) : "memory");
}

__device__ __forceinline__ void tile_filled() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS + FOLDERS) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Pre-pass: h [B, E] bf16, one warp a row.
__global__ void __launch_bounds__(NORM_THREADS)
    lm_head_norm(const bf16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ h, int B,
                 int E, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const bf16* xrow = x + size_t(row) * E;
  bf16* hrow = h + size_t(row) * E;
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
  for (int c = lane; c < E; c += 32) {
    const float n = __fmul_rn(__fsub_rn(__bfloat162float(xrow[c]), mu), rs);
    hrow[c] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(n, w[c]), bias[c]));
  }
}

// Block v0's logits of batch row c (col[vl], vl = lane + 32 i) folded into
// the row's state, by one warp: its running max m[c] and the lanes' own
// sum-exp ps[c * 32 + lane], then its sorted top-k list (lkey / lidx
// [c * k + j]) takes each logit that beats its k-th entry, best first.
__device__ __forceinline__ void fold_row(const float* col, int c, int v0,
                                         int V, int k, float* ps, float* m,
                                         uint32_t* lkey, int* lidx,
                                         int lane) {
  float x[4];
  uint32_t key[4];
  uint32_t mk = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int vl = lane + 32 * i;
    x[i] = col[vl];
    key[i] = v0 + vl < V ? order_key(x[i]) : 0u;   // rows past V: out
    mk = max(mk, key[i]);
  }
  const float m0 = m[c];
  const float m1 = fmaxf(m0, key_value(__reduce_max_sync(0xffffffffu, mk)));
  const float base = -m1 * kLog2e;
  float sum = ps[c * 32 + lane] * ex2((m0 - m1) * kLog2e);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (key[i] != 0u) sum += ex2(fmaf(x[i], kLog2e, base));
  ps[c * 32 + lane] = sum;
  __syncwarp();
  if (lane == 0) m[c] = m1;

  uint32_t* lk = lkey + c * k;
  int* li = lidx + c * k;
  uint32_t mine = lane < k ? lk[lane] : 0u;
  int mine_i = lane < k ? li[lane] : SENT;
  uint32_t tk = lk[k - 1];
  int ti = li[k - 1];
  for (;;) {
    // the warp's best logit not yet taken: ascending i is ascending index
    uint32_t bk = 0u;
    int bi = SENT;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (key[i] > bk) {
        bk = key[i];
        bi = v0 + lane + 32 * i;
      }
    warp_best(bk, bi);
    if (!ahead(bk, bi, tk, ti)) break;   // it does not beat the k-th
    const int pos = __popc(
        __ballot_sync(0xffffffffu, lane < k && ahead(mine, mine_i, bk, bi)));
    if (lane >= pos && lane + 1 < k) {   // the entries it beats move down
      lk[lane + 1] = mine;
      li[lane + 1] = mine_i;
    }
    if (lane == pos) {
      lk[pos] = bk;
      li[pos] = bi;
    }
    __syncwarp();
    if (lane < k) {
      mine = lk[lane];
      mine_i = li[lane];
    }
    tk = lk[k - 1];
    ti = li[k - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (v0 + lane + 32 * i == bi) key[i] = 0u;
    __syncwarp();
  }
}

// Batch row b's top-k and logz from the G CTAs' sorted lists (buf: G * KP
// pairs in shared memory), by one warp.
__device__ __forceinline__ void merge_row(const uint2* buf,
                                          const float2* __restrict__ part,
                                          float* vals, long long* idx,
                                          float* logz, int b, int G, int k,
                                          int kp, int lane) {
  const float2* pp = part + size_t(b) * G;
  uint32_t mk = 0u;
  for (int j = lane; j < G; j += 32) mk = max(mk, order_key(__ldcg(pp + j).x));
  const float mg = key_value(__reduce_max_sync(0xffffffffu, mk));
  float s = 0.f;
  for (int j = lane; j < G; j += 32) {
    const float2 q = __ldcg(pp + j);
    s += q.y * ex2((q.x - mg) * kLog2e);
  }
  s = warp_sum(s);
  if (lane == 0) logz[b] = mg + logf(s);

  // the heads of the lists j = lane + 32 t
  uint32_t hk[MAXT];
  int hi[MAXT], hp[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const int j = lane + 32 * t;
    hp[t] = 0;
    hk[t] = 0u;
    hi[t] = SENT;
    if (j < G) {
      const uint2 e = buf[j * kp];
      hk[t] = e.x;
      hi[t] = int(e.y);
    }
  }
  for (int r = 0; r < k; ++r) {
    uint32_t bk = 0u;
    int bi = SENT, bt = 0;
#pragma unroll
    for (int t = 0; t < MAXT; ++t)
      if (ahead(hk[t], hi[t], bk, bi)) {
        bk = hk[t];
        bi = hi[t];
        bt = t;
      }
    uint32_t wk = bk;
    int wi = bi;
    warp_best(wk, wi);
    if (lane == 0) {
      vals[size_t(b) * k + r] = wi == SENT ? -INFINITY : key_value(wk);
      idx[size_t(b) * k + r] = wi;
    }
    if (wi != SENT && bi == wi) {   // the owner advances that list
#pragma unroll
      for (int t = 0; t < MAXT; ++t)
        if (t == bt) {
          const int j = lane + 32 * t;
          ++hp[t];
          hk[t] = 0u;
          hi[t] = SENT;
          if (hp[t] < k) {
            const uint2 e = buf[j * kp + hp[t]];
            hk[t] = e.x;
            hi[t] = int(e.y);
          }
        }
    }
  }
}

// One CTA an SM (blockIdx.x = c of G): vocab blocks [c nblk / G, (c + 1)
// nblk / G) for each batch chunk of N rows, then the grid barrier, then
// the merge of rows c, c + G, ...
template <class C>
__global__ void __launch_bounds__(THREADS, 1)
    lm_head_topk_wgmma(const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap th,
                       uint2* __restrict__ cand, float2* __restrict__ part,
                       unsigned* __restrict__ bar, float* __restrict__ vals,
                       long long* __restrict__ idx,
                       float* __restrict__ logz, int B, int V, int E, int k,
                       int st) {
  constexpr int N = C::N, Q = C::Q;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Layout L(N, C::STAGE, st, k);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + st;
  float* stg = reinterpret_cast<float*>(smem + L.staging);
  float* s_ps = reinterpret_cast<float*>(smem + L.ps);
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + L.key);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx);
  const int G = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int nblk = (V + VB - 1) / VB;
  const int blk0 = int(int64_t(cta) * nblk / G);
  const int blk1 = int(int64_t(cta + 1) * nblk / G);
  const int nkc = (E + KC - 1) / KC, nch = (B + N - 1) / N;
  const int kp = k + (k & 1);
  if (tid == 0) {
    for (int s = 0; s < st; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = tid % 32;
  if (tid >= PRODUCER) {
    if (tid == PRODUCER) {
      int n = 0;
      for (int ch = 0; ch < nch; ++ch)
        for (int blk = blk0; blk < blk1; ++blk)
          for (int kc = 0; kc < nkc; ++kc, ++n) {
            const int s = n % st;
            uint8_t* stage = smem + s * C::STAGE;
            mbar_wait(&empty[s], ((n / st) & 1) ^ 1);
            mbar_expect_tx(&full[s], C::STAGE);
            tma_load(stage, &tw, &full[s], kc * KC, blk * VB, 0);
            tma_load(stage + W_BYTES, &th, &full[s], kc * KC, ch * N, 0);
          }
    }
  } else if (tid < CONSUMERS) {  // consumers: the products
    const int cw = tid / 128, warp = (tid / 32) % 4;
    const int g = lane / 4, t = lane % 4;
    const uint32_t ring = smem_u32(smem);
    float acc[N / 2];
    int n = 0;
    for (int ch = 0; ch < nch; ++ch)
      for (int blk = blk0; blk < blk1; ++blk) {
        // logits^T (64 table rows x N batch rows) over E, a stage a chunk
        for (int kc = 0; kc < nkc; ++kc, ++n) {
          const int s = n % st;
          const uint32_t a = ring + s * C::STAGE + cw * 64 * 128;
          const uint32_t hb = ring + s * C::STAGE + W_BYTES;
          mbar_wait(&full[s], (n / st) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            HeadMma<N>::mma(acc, kmajor_desc<128>(a + kk * 32),
                            kmajor_desc<128>(hb + kk * 32), kc > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<1>();   // the previous chunk's products are done
          if (kc > 0 && lane == 0) mbar_arrive(&empty[(n - 1) % st]);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[(n - 1) % st]);
        // stage the block (batch column c's 128 logits at [c * LD]) once
        // the epilogue warps have folded the last one
        tile_drained();
        const int r = cw * 64 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* col = stg + (8 * j + 2 * t + e) * LD;
            col[r] = acc[4 * j + e];
            col[r + 8] = acc[4 * j + 2 + e];
          }
        tile_filled();
      }
  } else {  // the epilogue: warp fw folds rows c = fw + 8 q of each block
    const int fw = (tid - CONSUMERS) / 32;
    for (int ch = 0; ch < nch; ++ch) {
      const int b0 = ch * N;
      for (int q = 0; q < Q; ++q) {   // running max, lanes' sum-exp, list
        const int c = fw + CWARPS * q;
        s_ps[c * 32 + lane] = 0.f;
        if (lane == 0) s_m[c] = -INFINITY;
        for (int j = lane; j < k; j += 32) {
          s_key[c * k + j] = 0u;
          s_idx[c * k + j] = SENT;
        }
      }
      __syncwarp();
      for (int blk = blk0; blk < blk1; ++blk) {
        tile_drained();
        tile_filled();
        for (int q = 0; q < Q; ++q) {
          const int c = fw + CWARPS * q;
          if (b0 + c < B)
            fold_row(stg + c * LD, c, blk * VB, V, k, s_ps, s_m, s_key,
                     s_idx, lane);
        }
      }
      __syncwarp();
      // the chunk's lists and (m, se), row b's at [b, cta]
      for (int q = 0; q < Q; ++q) {
        const int c = fw + CWARPS * q, b = b0 + c;
        if (b >= B) continue;
        const size_t at = size_t(b) * G + cta;
        const float se = warp_sum(s_ps[c * 32 + lane]);
        if (lane < k)
          cand[at * kp + lane] =
              make_uint2(s_key[c * k + lane], uint32_t(s_idx[c * k + lane]));
        if (lane == 0) part[at] = make_float2(s_m[c], se);
      }
    }
  }

  // every CTA's lists written: the grid barrier
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    add_release(bar, 1u);
    for (unsigned polls = 0; load_acquire(bar) < unsigned(G); ++polls)
      if (polls == BARRIER_POLLS) __trap();
  }
  __syncthreads();

  // the merge: rows cta, cta + G, ..., as many at once as their lists fit
  // the shared memory, read in by the whole CTA, then one a warp
  const int row_pairs = G * kp;   // uint2 a row, an even count
  int per_pass = L.bytes / (row_pairs * 8);
  per_pass = per_pass < WARPS ? per_pass : WARPS;
  const int rows = (B - cta + G - 1) / G;
  uint2* buf = reinterpret_cast<uint2*>(smem);
  for (int r0 = 0; r0 < rows; r0 += per_pass) {
    const int nr = min(per_pass, rows - r0);
    for (int i = tid; i < nr * row_pairs / 2; i += THREADS) {
      const int rr = i / (row_pairs / 2), off = i % (row_pairs / 2);
      const uint4* src = reinterpret_cast<const uint4*>(
          cand + size_t(cta + (r0 + rr) * G) * row_pairs);
      reinterpret_cast<uint4*>(buf + size_t(rr) * row_pairs)[off] =
          __ldcg(src + off);
    }
    __syncthreads();
    const int w = tid / 32;
    if (w < nr)
      merge_row(buf + size_t(w) * row_pairs, part, vals, idx, logz,
                cta + (r0 + w) * G, G, k, kp, lane);
    __syncthreads();
  }

  // the last CTA out resets the barrier for the next launch
  if (tid == 0 && atomicAdd(bar + 32, 1u) == unsigned(G) - 1) {
    atomicExch(bar, 0u);
    atomicExch(bar + 32, 0u);
  }
}

// f(the instance whose width N takes a chunk of B rows).
template <typename F>
int with_width(int B, F f) {
  if (B <= 8) return f(Head<8>());
  if (B <= 16) return f(Head<16>());
  if (B <= 32) return f(Head<32>());
  if (B <= 64) return f(Head<64>());
  return f(Head<128>());
}

// The instance's ring stages and dynamic shared memory at top-k k and grid
// G, or an error where they do not fit.
template <class C>
int plan(int k, int G, int* st, int* smem) {
  *st = stages<C>(k);
  if (*st == 0) return int(cudaErrorInvalidValue);
  const Layout L(C::N, C::STAGE, *st, k);
  if (L.bytes < G * (k + (k & 1)) * 8)   // a merged row's lists
    return int(cudaErrorInvalidValue);
  *smem = L.bytes + 1024;
  return 0;
}

template <class C>
int launch(const void* h, const void* wte, void* cand, void* part, void* bar,
           void* vals, void* idx, void* logz, int B, int E, int V, int k,
           int G, cudaStream_t stream) {
  int st = 0, smem = 0;
  int err = plan<C>(k, G, &st, &smem);
  if (err != 0) return err;
  CUtensorMap tw, th;
  if (!tile_map_rows(&tw, wte, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 1, V, E,
                     KC, VB) ||
      !tile_map_rows(&th, h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 1, B, E,
                     KC, C::N))
    return int(cudaErrorInvalidValue);
  auto kernel = lm_head_topk_wgmma<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  auto* cp = static_cast<uint2*>(cand);
  auto* pp = static_cast<float2*>(part);
  auto* bp = static_cast<unsigned*>(bar);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<long long*>(idx);
  auto* zp = static_cast<float*>(logz);
  void* args[] = {&tw, &th, &cp, &pp, &bp, &vp, &ip, &zp,
                  &B,  &V,  &E,  &k,  &st};
  // cooperative: a grid the card cannot hold at once is refused, never hung
  return int(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                         dim3(G), dim3(THREADS), args,
                                         size_t(smem), stream));
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda/lm_head_topk.py),
// which keeps the scratch for a grid of G CTAs (at most one an SM and one a
// vocab block, and at most 256).
extern "C" int fk_lm_head_topk(const void* x, const void* ln_w,
                               const void* ln_b, const void* wte, void* h,
                               void* cand, void* part, void* bar, void* vals,
                               void* idx, void* logz, int B, int E, int V,
                               int k, int G, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || E <= 0 || E % 8 || k <= 0 || k > 32 || k > V || G <= 0 ||
      G > MAX_GRID || G > (V + VB - 1) / VB)
    return int(cudaErrorInvalidValue);
  lm_head_norm<<<(B * 32 + NORM_THREADS - 1) / NORM_THREADS, NORM_THREADS, 0,
                 st>>>(static_cast<const bf16*>(x),
                       static_cast<const float*>(ln_w),
                       static_cast<const float*>(ln_b), static_cast<bf16*>(h),
                       B, E, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return with_width(B, [&](auto c) {
    return launch<decltype(c)>(h, wte, cand, part, bar, vals, idx, logz, B, E,
                               V, k, G, st);
  });
}

// out: the batch width N of the instance a B-row call runs, its ring
// stages and dynamic shared memory at top-k k and grid G, registers a
// thread, resident CTAs an SM, and local-memory bytes a thread (spills).
extern "C" int fk_lm_head_topk_info(int B, int k, int G, int* out) {
  if (B <= 0 || k <= 0 || k > 32 || G <= 0 || G > MAX_GRID)
    return int(cudaErrorInvalidValue);
  return with_width(B, [&](auto c) {
    using C = decltype(c);
    int st = 0, smem = 0;
    const int err = plan<C>(k, G, &st, &smem);
    if (err != 0) return err;
    auto kernel = lm_head_topk_wgmma<C>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return int(e);
    int ctas = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, THREADS,
                                                      smem);
    if (e != cudaSuccess) return int(e);
    const int vals[6] = {C::N, st, smem, attr.numRegs, ctas,
                         int(attr.localSizeBytes)};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
  });
}
