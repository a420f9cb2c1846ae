// The routing of LFM2-MoE's dropless experts (models/moe.py:RoutedExperts)
// in two kernels: moe_route (router, top-k, counting sort by expert and the
// offsets, one launch a layer) and moe_combine (the unsort and each row's
// weighted sum of its k expert outputs).
//
// Replaces no TPU kernel: the JAX package has no LFM2 and no dropless
// layer. It was added because the routing, done by some twenty PyTorch
// kernels of a few microseconds each (f32 GEMM, sigmoid, topk, gather, the
// normalisation, a radix sort, searchsorted, the count's cast and add, the
// unsort's index_copy_, the weights' cast, bmm), took ~100 us a layer at a
// decode step of 160 rows, for work the card does in ~2 us.
//
// What bounds it on an H100: at a decode step (N = 160 rows, dim 2048, 32
// experts, top 4) the bytes are h (1.3 MB f32), the gate (128 KB bf16) and
// the experts' outputs (2.6 MB bf16), ~1.5 us at 3.35 TB/s; the scores are
// 10 MFLOP of f32 FMA. So each kernel is held by its launch and the chain
// of dependent steps inside it, and the design keeps that chain short:
//   * moe_route scores each tile of ROWS rows in one of two ways, f32
//     FMA on operands widened exactly either way (h f32, the gate and the
//     bias bf16, as the served LFM2 holds them). Few rows (a decode
//     step): a cluster of CL CTAs a tile, CTA c scoring its rows against
//     experts [8c, 8c + 8): each thread loads its 8 dims of the 4 rows and
//     the 8 gate rows at once (one trip to memory), the 256 threads' sums
//     are folded by shuffles and shared memory, and the scores go to the
//     first CTA of the cluster through distributed shared memory; the
//     others stop there. Many rows (the prefill): a CTA owns a run of rows
//     (at most two CTAs an SM, so the gate is read by few CTAs) and walks
//     it in tiles, each tile's rows copied to shared memory while the tile
//     before is scored (cp.async, double-buffered); warps split the
//     experts, lanes the dim, a warp's lanes summed by shuffles. A warp
//     a row then ranks every expert by s + bias against the others (NaN
//     first, ties to the lower index: torch.sort's stable order, so the
//     ranks are distinct even on a NaN row) in one pass, weighs its top k and writes each
//     pair's rank among its group's pairs of the same expert (a group: a
//     cluster's tile, or a CTA's run); at the end the group writes its
//     count of each expert, expert-major ([E, groups]). The last group to
//     finish (an arrival count the caller owns, reset by it) scans the counts flat into
//     shared memory, which gives each (expert, group) its first sorted
//     position and each expert its end offset, and places every pair: the
//     sort is stable in (row, choice) order. No second launch, and only
//     the small arrays (choices, ranks, counts) are read again, from L2.
//   * moe_combine: a thread 8 columns (16 bytes) of a row: the row's k
//     weights rounded to bf16 (as weights.to(cdt)), its k
//     expert outputs gathered at their sorted positions, summed in f32,
//     rounded once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;               // rows a tile
constexpr int MAX_E = 64;
constexpr int MAX_K = 8;
constexpr int MAX_D = 8192;
constexpr int MAX_BASES = 11264;      // experts x groups the last scans
constexpr int SPLIT_ROWS = 512;       // at most, rows scored by clusters
constexpr int EPC = 8;                // experts a CTA of a cluster scores
constexpr unsigned FULL = 0xffffffffu;

struct RouteArgs {
  const float* h;          // [N, D]
  const __nv_bfloat16* gate;   // [E, D]
  const __nv_bfloat16* bias;   // [E], or null
  int n, d, e, k, norm;
  int tiles_per_cta;       // tiles of ROWS rows a group owns
  float scaling;
  int* chosen;             // [N, k]
  float* weights;          // [N, k]
  int* pos;                // [N, k]: the rank in the group, then the place
  int* rows;               // [N * k]
  int* ends;               // [E]
  long long* ends_sum;     // [E] or null: the running sum of ends
  int* counts;             // [E, groups]
  unsigned* arrived;       // groups done, left 0
};

// the launch over n rows: groups (a cluster of `cluster` CTAs a tile when
// the rows are few and the experts more than EPC, else one CTA a run of
// tiles, at most two an SM), at most MAX_BASES / e of them; tiles a group;
// dynamic shared memory (two tiles, and the last group's bases)
struct Plan {
  int groups, cluster, tiles_per_cta;
  size_t smem;
};

Plan plan(int n, int d, int e, int sms) {
  Plan p;
  const int tiles = (n + ROWS - 1) / ROWS;
  p.cluster = 1;
  if (e > EPC && n <= SPLIT_ROWS && tiles <= MAX_BASES / e)
    while (p.cluster * EPC < e) p.cluster *= 2;
  const int most = p.cluster > 1 ? tiles : min(2 * sms, MAX_BASES / e);
  const int groups = min(tiles, most);
  p.tiles_per_cta = (tiles + groups - 1) / groups;
  p.groups = (tiles + p.tiles_per_cta - 1) / p.tiles_per_cta;
  p.smem = max(p.cluster > 1 ? 0 : size_t(2) * ROWS * d * sizeof(float),
               sizeof(int) * e * p.groups);
  return p;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(pair[0]);
  const float2 hi = __bfloat1622float2(pair[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void load8g(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pair[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8g(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float bias_of(const RouteArgs& a, int e) {
  return a.bias == nullptr ? 0.f : __bfloat162float(a.bias[e]);
}

// (v, i) before (w, j): NaN before any number, else the larger value;
// ties (NaN and NaN too) to the lower index. A total order, as
// torch.sort(descending=True, stable=True) has.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  const bool nv = isnan(v), nw = isnan(w);
  if (nv != nw) return nv;
  if (!nv && v != w) return v > w;
  return i < j;
}

// got[0..4) = p[i..i+4) that lie below hi (0 past it), read from L2
__device__ __forceinline__ void load4_l2(const int* p, int i, int hi,
                                         int (&got)[4]) {
  if (i + 4 <= hi) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(p + i));
    got[0] = v.x; got[1] = v.y; got[2] = v.z; got[3] = v.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) got[u] = i + u < hi ? __ldcg(p + i + u) : 0;
  }
}

// exclusive prefix of v over the CTA's threads
__device__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < WARPS ? warp_sums[lane] : 0;
    int w = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    if (lane < WARPS) warp_sums[lane] = w - own;
  }
  __syncthreads();
  return x - v + warp_sums[warp];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// the bytes [0, n) of src into dst, 16 at a time, by the whole CTA
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           size_t n) {
  for (size_t i = threadIdx.x; i < n / 16; i += THREADS)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
}

// acc[j][r] += the lane's 4 dims [o, o + 4) of row r (a tile in shared
// memory) times those of the warp's expert j
template <int EPW>
__device__ __forceinline__ void fma4(float (&acc)[EPW][ROWS],
                                     const float* tile, int d, int nr,
                                     const __nv_bfloat16* const (&grow)[EPW],
                                     int o) {
  float g[EPW][4];
#pragma unroll
  for (int j = 0; j < EPW; ++j) load4(grow[j] + o, g[j]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float x[4];
    load4(tile + min(r, nr - 1) * d + o, x);
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][r] = fmaf(x[i], g[j][i], acc[j][r]);
  }
}

// the scores s = sigmoid(h @ gate^T) of the tile's nr rows (in shared
// memory) into s_score, and s + bias into s_pick. Warp w takes
// experts w, w + WARPS, .. (EPW of them; an index past E reads expert E - 1
// and is dropped); in each 256 dims, lane l takes dims 4l.. and 128 + 4l..
template <int EPW>
__device__ void score_tile(const RouteArgs& a, int nr, const float* tile,
                           const float* s_bias,
                           float (&s_score)[ROWS][MAX_E],
                           float (&s_pick)[ROWS][MAX_E]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = a.d;
  const __nv_bfloat16* grow[EPW];
#pragma unroll
  for (int j = 0; j < EPW; ++j)
    grow[j] = a.gate + size_t(min(warp + j * WARPS, a.e - 1)) * d;
  float acc[EPW][ROWS];
#pragma unroll
  for (int j = 0; j < EPW; ++j)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[j][r] = 0.f;
  int c = 0;
#pragma unroll 2
  for (; c + 256 <= d; c += 256) {
    fma4<EPW>(acc, tile, d, nr, grow, c + 4 * lane);
    fma4<EPW>(acc, tile, d, nr, grow, c + 128 + 4 * lane);
  }
  if (c + 4 * lane < d) fma4<EPW>(acc, tile, d, nr, grow, c + 4 * lane);
  if (c + 128 + 4 * lane < d)
    fma4<EPW>(acc, tile, d, nr, grow, c + 128 + 4 * lane);
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    const int e = warp + j * WARPS;
    if (e < a.e) {               // the same for the whole warp
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float v = acc[j][r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(FULL, v, off);
        if (lane == 0 && r < nr) {
          const float s = 1.f / (1.f + expf(-v));
          s_score[r][e] = s;
          s_pick[r][e] = s + s_bias[e];
        }
      }
    }
  }
  __syncthreads();
}

// a warp a row of the tile: each expert's rank by s + bias against every
// other (`before`'s order); the top k into s_sel, weighed by their
// scores summed in rank order, written out
__device__ void select_tile(const RouteArgs& a, int r0, int nr,
                            const float (&s_score)[ROWS][MAX_E],
                            const float (&s_pick)[ROWS][MAX_E],
                            int (&s_sel)[ROWS][MAX_K]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nr) {
    const int r = warp, n = r0 + r;
    for (int e = lane; e < a.e; e += 32) {
      const float v = s_pick[r][e];
      int rank = 0;
      for (int f = 0; f < a.e; ++f) rank += before(s_pick[r][f], f, v, e);
      if (rank < a.k) s_sel[r][rank] = e;
    }
    __syncwarp();
    float sum = 0.f;
    for (int j = 0; j < a.k; ++j) sum += s_score[r][s_sel[r][j]];
    if (lane < a.k) {
      const int e = s_sel[r][lane];
      float w = a.norm ? s_score[r][e] / (sum + 1e-6f) : s_score[r][e];
      if (a.scaling != 1.f) w *= a.scaling;
      a.chosen[n * a.k + lane] = e;
      a.weights[n * a.k + lane] = w;
    }
  }
  __syncthreads();
}

// the warp's N sums of each lane folded so lane l holds the warp's sum of
// index l: at each step a lane keeps the half of its sums its lane bit
// picks and adds its partner's copy of that half (N - 1 shuffles)
template <int N, int M>
__device__ __forceinline__ void fold(float (&v)[M], int lane) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool upper = lane & H;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, H);
    }
    fold<H>(v, lane);
  }
}

// a cluster's tile, rows [r0, r0 + nr), against experts [e0, e0 + EPC):
// thread t takes dims [8t, 8t + 8) (and every 8 x THREADS on), loads them
// from every row and expert at once, and sums its 32 (row, expert)
// products; a warp's sums are folded so lane l holds (l / 8, l % 8), the
// warps' through `red`; the scores are written into the cluster's first
// CTA's s_score and s_pick
__device__ void split_scores(const RouteArgs& a, int r0, int nr, int e0,
                             float* red, float* lead_score,
                             float* lead_pick) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, d = a.d;
  const float bias = t < ROWS * EPC ? bias_of(a, min(e0 + t % EPC, a.e - 1))
                                    : 0.f;
  float v[ROWS * EPC];
#pragma unroll
  for (int i = 0; i < ROWS * EPC; ++i) v[i] = 0.f;
  for (int o = 8 * t; o < d; o += 8 * THREADS) {
    float g[EPC][8];
#pragma unroll
    for (int j = 0; j < EPC; ++j)
      load8g(a.gate + size_t(min(e0 + j, a.e - 1)) * d + o, g[j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float x[8];
      load8g(a.h + size_t(r0 + min(r, nr - 1)) * d + o, x);
#pragma unroll
      for (int j = 0; j < EPC; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[r * EPC + j] = fmaf(x[i], g[j][i], v[r * EPC + j]);
    }
  }
  fold<ROWS * EPC>(v, lane);
  red[warp * 32 + lane] = v[0];
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t < ROWS * EPC) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w * 32 + t];
    const int r = t / EPC, e = e0 + t % EPC;
    if (r < nr && e < a.e) {
      const float s = 1.f / (1.f + expf(-sum));
      lead_score[r * MAX_E + e] = s;
      lead_pick[r * MAX_E + e] = s + bias;
    }
  }
}

// one tile's choices (s_sel, written out) and each of its pairs' rank
// among its group's pairs of the same expert (row order), added to the
// group's running count of each expert (s_run)
__device__ void choose_tile(const RouteArgs& a, int r0, int nr,
                            const float (&s_score)[ROWS][MAX_E],
                            const float (&s_pick)[ROWS][MAX_E],
                            int (&s_sel)[ROWS][MAX_K], int* s_run) {
  const int t = threadIdx.x;
  select_tile(a, r0, nr, s_score, s_pick, s_sel);
  if (t < nr * a.k) {
    const int r = t / a.k, j = t % a.k, e = s_sel[r][j];
    int rank = s_run[e];
    for (int r2 = 0; r2 < r; ++r2)
      for (int j2 = 0; j2 < a.k; ++j2) rank += s_sel[r2][j2] == e;
    a.pos[(r0 + r) * a.k + j] = rank;
  }
  __syncthreads();
  if (t < a.e) {
    int count = 0;
    for (int r = 0; r < nr; ++r)
      for (int j = 0; j < a.k; ++j) count += s_sel[r][j] == t;
    s_run[t] += count;
  }
}

template <int EPW, int CL>
__global__ void __launch_bounds__(THREADS) moe_route(RouteArgs a) {
  // dynamic: two tiles' rows [2][ROWS, D] f32 (CL == 1); in the last
  // group's scan, the first position of each (expert, group)
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ float s_score[ROWS][MAX_E];
  __shared__ float s_pick[ROWS][MAX_E];
  __shared__ float s_bias[MAX_E];
  __shared__ float s_red[WARPS * 32];
  __shared__ int s_sel[ROWS][MAX_K];
  __shared__ int s_run[MAX_E];
  __shared__ int s_warp[WARPS];
  __shared__ int s_last;
  const int t = threadIdx.x, d = a.d;
  const int group = blockIdx.x / CL, groups = gridDim.x / CL;
  const int span = a.tiles_per_cta * ROWS;      // the group's rows
  const int row_lo = group * span, row_hi = min(a.n, row_lo + span);
  if (t < a.e) s_run[t] = 0;

  if constexpr (CL > 1) {
    // 1. the cluster's one tile: each CTA's experts scored into the first
    //    CTA, which alone goes on (the first barrier, arrived at here and
    //    waited on before the writes, makes sure every CTA of the cluster
    //    has started)
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    split_scores(a, row_lo, row_hi - row_lo,
                    int(cluster.block_rank()) * EPC, s_red,
                    cluster.map_shared_rank(&s_score[0][0], 0),
                    cluster.map_shared_rank(&s_pick[0][0], 0));
    cluster.sync();
    if (cluster.block_rank() != 0) return;
    choose_tile(a, row_lo, row_hi - row_lo, s_score, s_pick, s_sel, s_run);
  } else {
    // 1. tile by tile (the next one's rows copied meanwhile): scores,
    //    choices, ranks, the running count
    copy_async(s_dyn, a.h + size_t(row_lo) * d,
               sizeof(float) * min(ROWS, row_hi - row_lo) * d);
    cp_async_commit();
    if (t < a.e) s_bias[t] = bias_of(a, t);
    for (int r0 = row_lo, i = 0; r0 < row_hi; r0 += ROWS, ++i) {
      const int nr = min(ROWS, row_hi - r0);
      if (r0 + ROWS < row_hi) {
        copy_async(s_dyn + ((i + 1) & 1) * ROWS * d,
                   a.h + size_t(r0 + ROWS) * d,
                   sizeof(float) * min(ROWS, row_hi - r0 - ROWS) * d);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      score_tile<EPW>(a, nr, s_dyn + (i & 1) * ROWS * d, s_bias, s_score,
                      s_pick);
      choose_tile(a, r0, nr, s_score, s_pick, s_sel, s_run);
    }
  }
  __syncthreads();
  if (t < a.e) a.counts[t * groups + group] = s_run[t];
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(a.arrived, 1u) == groups - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // 2. the last group: the counts scanned flat in (expert, group) order
  //    give each group's first position in each expert's run of pairs
  int* s_base = reinterpret_cast<int*>(s_dyn);
  constexpr int FLIGHT = 8;     // pairs a thread has in flight
  const int pairs = a.n * a.k;
  int e[FLIGHT], rank[FLIGHT];  // the first batch, read with the counts
#pragma unroll
  for (int u = 0; u < FLIGHT; ++u) {
    const int p = t + u * THREADS;
    if (p < pairs) {
      e[u] = __ldcg(a.chosen + p);
      rank[u] = __ldcg(a.pos + p);
    }
  }
  const int m = a.e * groups;
  const int seg = ((m + THREADS - 1) / THREADS + 3) & ~3;
  const int lo = min(m, t * seg), hi = min(m, lo + seg);
  constexpr int KEEP = 24;
  if (seg <= KEEP) {            // one read of the counts, kept in registers
    int got[KEEP], total = 0;
#pragma unroll
    for (int u = 0; u < KEEP; u += 4) {
      int four[4];
      load4_l2(a.counts, lo + u, hi, four);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        got[u + w] = four[w];
        total += four[w];
      }
    }
    int run = block_exclusive_scan(total, s_warp);
#pragma unroll
    for (int u = 0; u < KEEP; ++u) {
      if (lo + u < hi) {
        s_base[lo + u] = run;
        run += got[u];
      }
    }
  } else {                      // two reads
    int got[4], total = 0;
    for (int i = lo; i < hi; i += 4) {
      load4_l2(a.counts, i, hi, got);
      total += got[0] + got[1] + got[2] + got[3];
    }
    int run = block_exclusive_scan(total, s_warp);
    for (int i = lo; i < hi; i += 4) {
      load4_l2(a.counts, i, hi, got);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u < hi) {
          s_base[i + u] = run;
          run += got[u];
        }
      }
    }
  }
  __syncthreads();
  if (t < a.e) {
    const int end = t + 1 < a.e ? s_base[(t + 1) * groups] : a.n * a.k;
    a.ends[t] = end;
    if (a.ends_sum != nullptr) a.ends_sum[t] += end;
  }

  // 3. every pair to its place, FLIGHT a thread at a time
  for (int p0 = t; p0 < pairs; p0 += FLIGHT * THREADS) {
    if (p0 != t) {
#pragma unroll
      for (int u = 0; u < FLIGHT; ++u) {
        const int p = p0 + u * THREADS;
        if (p < pairs) {
          e[u] = __ldcg(a.chosen + p);
          rank[u] = __ldcg(a.pos + p);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < FLIGHT; ++u) {
      const int p = p0 + u * THREADS;
      if (p < pairs) {
        const int n = p / a.k;
        const int dst = s_base[e[u] * groups + n / span] + rank[u];
        a.pos[p] = dst;
        a.rows[dst] = n;
      }
    }
  }
  if (t == 0) *a.arrived = 0u;
}

__global__ void __launch_bounds__(THREADS)
moe_combine(const __nv_bfloat16* __restrict__ y, const float* __restrict__ w,
            const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
            int n, int d, int k) {
  const int chunks = d / 8;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<long long>(n) * chunks) return;
  const int row = static_cast<int>(i / chunks), q = static_cast<int>(i % chunks);
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  for (int j = 0; j < k; ++j) {
    const int p = __ldg(pos + row * k + j);
    const float wj = __bfloat162float(__float2bfloat16(__ldg(w + row * k + j)));
    float v[8];
    load8g(y + size_t(p) * d + q * 8, v);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = fmaf(wj, v[c], acc[c]);
  }
  uint4 raw;
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    pair[c] = __floats2bfloat162_rn(acc[2 * c], acc[2 * c + 1]);
  *reinterpret_cast<uint4*>(out + size_t(row) * d + q * 8) = raw;
}

template <int EPW, int CL>
int launch_route(const RouteArgs& a, const Plan& p, cudaStream_t s) {
  auto kernel = moe_route<EPW, CL>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
    if (err != cudaSuccess) return int(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.groups * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  return int(cudaLaunchKernelEx(&cfg, kernel, a));
}

// the instance: clusters of p.cluster CTAs, or one CTA a group with EPW
// (experts a warp scores) covering e
int launch_route(const RouteArgs& a, const Plan& p, cudaStream_t s) {
  switch (p.cluster) {
    case 2: return launch_route<1, 2>(a, p, s);
    case 4: return launch_route<1, 4>(a, p, s);
    case 8: return launch_route<1, 8>(a, p, s);
  }
  if (a.e <= WARPS) return launch_route<1, 1>(a, p, s);
  if (a.e <= 2 * WARPS) return launch_route<2, 1>(a, p, s);
  if (a.e <= 4 * WARPS) return launch_route<4, 1>(a, p, s);
  return launch_route<8, 1>(a, p, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The groups fk_moe_route sorts over for n rows of d dims and e experts
// on a card of `sms` SMs (its counts scratch holds e times this), or -1.
extern "C" int fk_moe_route_groups(int n, int d, int e, int sms) {
  if (n < 1 || d < 8 || d > MAX_D || e < 1 || e > MAX_E || sms < 1)
    return -1;
  return plan(n, d, e, sms).groups;
}

// h [n, d] f32, gate [e, d] bf16, bias [e] bf16 or null; outputs chosen,
// pos [n, k] int32, weights [n, k] f32, rows [n * k] int32, ends [e]
// int32; ends_sum [e] int64 or null (ends added to it); counts: [e,
// fk_moe_route_groups(..)] int32 scratch; arrived: one uint32 the caller
// owns, 0 before and after a launch (launches that share it must not
// overlap). d % 8 == 0, d <= 8192, 16-byte aligned h and gate, 1 <= e <=
// 64, 1 <= k <= min(e, 8). Runs on `stream`.
extern "C" int fk_moe_route(const void* h, const void* gate, const void* bias,
                            void* chosen, void* weights, void* pos,
                            void* rows, void* ends, void* ends_sum,
                            void* counts, void* arrived, int n, int d, int e,
                            int k, int norm, int sms, float scaling,
                            void* stream) {
  if (sms < 1 || n < 1 || d < 8 || d % 8 != 0 || d > MAX_D || e < 1 ||
      e > MAX_E || k < 1 || k > MAX_K || k > e ||
      static_cast<long long>(n) * k > INT32_MAX || !aligned16(h) ||
      !aligned16(gate))
    return int(cudaErrorInvalidValue);
  const Plan p = plan(n, d, e, sms);
  RouteArgs a;
  a.h = static_cast<const float*>(h);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.n = n; a.d = d; a.e = e; a.k = k; a.norm = norm;
  a.tiles_per_cta = p.tiles_per_cta;
  a.scaling = scaling;
  a.chosen = static_cast<int*>(chosen);
  a.weights = static_cast<float*>(weights);
  a.pos = static_cast<int*>(pos);
  a.rows = static_cast<int*>(rows);
  a.ends = static_cast<int*>(ends);
  a.ends_sum = static_cast<long long*>(ends_sum);
  a.counts = static_cast<int*>(counts);
  a.arrived = static_cast<unsigned*>(arrived);
  return launch_route(a, p, static_cast<cudaStream_t>(stream));
}

// y [n * k, d] bf16 sorted expert outputs, w [n, k] f32, pos [n, k] int32
// -> out [n, d] bf16. d % 8 == 0, 16-byte aligned y and out. Runs on
// `stream`.
extern "C" int fk_moe_combine(const void* y, const void* w, const void* pos,
                              void* out, int n, int d, int k, void* stream) {
  if (n < 1 || k < 1 || d < 8 || d % 8 != 0 || !aligned16(y) ||
      !aligned16(out))
    return int(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n) * (d / 8);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return int(cudaErrorInvalidValue);
  moe_combine<<<unsigned(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(w),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), n, d, k);
  return int(cudaGetLastError());
}
