// The persistent all-layer decode step shared by K2 (fused_decode.cu, GPT-2)
// and K5 (fused_llama_decode.cu, LLaMA): one cooperative launch a token
// runs every layer, its phases separated by a grid barrier.
//
// Phases of a layer (every CTA walks all of them, owning the work items
// i = cta, cta + G, ... of each):
//   1. qkv product                 items (N chunk, 64-lane tile, depth split)
//   2. attention                   items (batch row, KV head)
//   3. proj / o product            as 1
//   4. rows: residual, norm 2      items batch rows
//   5. fc / gate|up product        items (N chunk, tile); one depth split,
//                                  its epilogue applies GELU / SwiGLU
//                                  (where plan folds it: else as 1, and
//   5b. act: GELU / SwiGLU         elementwise over [B, F] of its partials)
//   6. fc2 / down product          as 1
//   7. rows: residual, next norm 1 (the output cast after the last layer)
// and one rows phase before layer 0 (x -> f32 residual, norm 1).
//
// A CTA is one consumer warpgroup and one producer warp, two CTAs an SM by
// default (fused_decode.TUNING). The producer walks the CTA's work list
// ahead of the consumers and keeps TMA copies of every input that no CTA
// writes during the launch (weight tiles, and the cache rows < length of
// each attention item) in flight in a ring of shared-memory slots; it
// never waits at a grid barrier, so the next phase's and the next layer's
// tiles stream from HBM while the grid synchronises. Activations written
// by other CTAs in the launch are read only after the barrier, through L2
// (__ldcg, cp.async.cg), never by TMA.
//
// Products run on wgmma with the operands swapped: out^T = W^T . h^T, 64
// output lanes of the weight as M (read MN-major from the TMA tile through
// the transpose bit), the batch rows as N (chunks of up to N_CHUNK_MAX rows,
// each padded to a wgmma width of chunk_width's; a larger batch runs in
// several chunks), 128-deep stages. int8 weights (w8a16) arrive as int8 in
// the upper half of their ring slot and are widened exactly to the
// swizzled bf16 tile in place (sm_90 has no 8-bit transpose). Each item
// writes an f32 partial of its depth split; the phase that consumes a
// product sums the partials in split order (deterministic: no float
// atomics, two calls bitwise equal) and applies the w8 scale.
//
// Attention: each consumer warp takes one item at a time, the CTA's items
// in groups of WARPS; an item's cache tiles share ring slots with the rest
// of its group's (tiles_per_slot).
//
// The model is a template parameter of the device code (LLAMA: RMSNorm,
// RoPE, rounded q.k products, SwiGLU, gate|up; else GPT-2's LayerNorm,
// biases and GELU), so that each kernel holds only its own paths: a
// consumer thread has at most 168 registers, and the other model's paths
// cost spills in every phase.
//
// The grid barrier is an arrival count that the last CTA to finish resets,
// so it needs no reset between calls; a wait that outlives any real one
// traps. The launch is cooperative, so a grid the card cannot hold is
// refused, never hung.
#pragma once

#include <float.h>

#include "hopper_blocks.cuh"

namespace fk {
namespace decode {

constexpr int KT = 128;          // depth of a weight tile (TMA box rows)
constexpr int TILE_M = 64;       // output lanes of a weight tile (wgmma M)
constexpr int ATT_ROWS = 64;     // cache rows of an attention tile
constexpr int SLOT = 16384;      // bytes of a ring slot
constexpr int MAX_STAGES = 16;   // ring slots at most
constexpr int CONSUMERS = 128;   // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int WARPS = CONSUMERS / 32;     // attention items in flight
constexpr int N_CHUNK_MAX = 32;   // 16 f32 accumulators a thread
constexpr int PRODUCTS = 4;      // qkv, proj, fc, fc2 (K5: qkv, o, gu, down)
constexpr int ACT = 2;           // the product whose epilogue is GELU / SwiGLU
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr unsigned BARRIER_POLLS = 1u << 26;
// A CTA's ns in products, attention, rows, barrier waits, and within the
// attention (its first warp's) q / k / v, scores, softmax and AV, output.
constexpr int STAMPS = 8;

// The wgmma width of a chunk of ``rows`` batch rows (at most N_CHUNK_MAX):
// the smallest of {8, 16, 32} that holds them.
__host__ __device__ inline int chunk_width(int rows) {
  const int pad = (rows + 7) & ~7;
  return pad <= 16 ? pad : 32;
}

// Depth splits of a product: the largest divisor of its K / KT stages that
// keeps tiles * chunks * splits within ``items``.
inline int depth_splits(int K, int tiles, int chunks, int items) {
  const int stages = K / KT;
  const int want = items / (tiles * chunks);
  int best = 1;
  for (int s = 1; s <= stages && s <= want; ++s)
    if (stages % s == 0) best = s;
  return best;
}

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

__device__ __forceinline__ void consumer_sync() { warpgroup_sync(0); }

// Sum over the consumer warpgroup; red is 4 floats of shared scratch.
__device__ inline float group_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  consumer_sync();
  const float out = (red[0] + red[1]) + (red[2] + red[3]);
  consumer_sync();   // red is reused by the next call
  return out;
}

__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return float(v); }

// The new cache entry: bf16, or the int8 code of v at scale s (round half
// to even, clamped to +-127).
__device__ __forceinline__ void put(bf16* dst, float v, float) {
  *dst = __float2bfloat16(v);
}
__device__ __forceinline__ void put(int8_t* dst, float v, float s) {
  *dst = static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
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

// All G CTAs' consumers meet here: bar[0] counts the launch's arrivals, so
// the k-th barrier waits for k * G of them (``target``, kept by the CTA).
// The count starts each launch at 0: grid_done resets it.
__device__ inline void grid_sync(unsigned* bar, unsigned G,
                                 unsigned& target) {
  consumer_sync();
  target += G;
  if (threadIdx.x == 0) {
    add_release(bar, 1u);
    for (unsigned polls = 0; load_acquire(bar) < target; ++polls)
      if (polls == BARRIER_POLLS) __trap();
  }
  consumer_sync();
}

// At the end of a launch: the last CTA to get here (every CTA has passed
// every barrier by then) resets the arrival count for the next launch.
// bar[32] (its own 128-byte line) counts the CTAs done.
__device__ inline void grid_done(unsigned* bar, unsigned G) {
  if (threadIdx.x == 0 && atomicAdd(bar + 32, 1u) == G - 1) {
    atomicExch(bar, 0u);
    atomicExch(bar + 32, 0u);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One [rows, cols] box of a 2D tensor map at (c0 = column, c1 = row).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// d (+)= W^T (64 x 16, shared, MN-major: the TMA tile's rows are depth)
// . h^T (16 x N, shared, K-major: rows are batch rows of 64 depth values).
template <int N>
struct WgmmaT;

#include "decode_wgmma.cuh"

// ---- what both models pass to the kernel ---------------------------------

// Weight maps: product p's segment i is maps.w[map_of[p][i]].
struct Maps {
  CUtensorMap w[7];
  CUtensorMap kc, vc;
};

struct Params {
  const bf16* x_in;
  bf16* x_out;
  float* x_res;        // [B, E] f32 residual
  bf16* h;             // [B, E] normalised rows, then the attention output
  bf16* act;           // [B, F] GELU / SwiGLU output
  float* part;         // [splits, B, N] partials of the current product
  float* scores_g;     // [G, R * S] when the scores do not fit in smem
  const float* norm1_w;   // [L, E]
  const float* norm1_b;   // [L, E], null for RMSNorm
  const float* norm2_w;
  const float* norm2_b;
  const float* bias[PRODUCTS];    // [L, N_p] (GPT-2), null (LLaMA)
  const float* scale[PRODUCTS][3];  // [L, 1, n] per segment, null unless w8
  int seg_n[PRODUCTS][3];
  int nseg[PRODUCTS];
  int map_of[PRODUCTS][3];
  int K[PRODUCTS];      // depth of each product
  int N[PRODUCTS];      // output lanes of each product
  int splits[PRODUCTS];
  void* k_cache;        // [L, B, S, E_kv]
  void* v_cache;
  const float* k_scale;   // [L, 1, E_kv], null for a bf16 cache
  const float* v_scale;
  const float* cos;       // [1, E] folded RoPE rows, null for GPT-2
  const float* sin;
  unsigned* bar;
  unsigned long long* stamps;   // [G, STAMPS] ns, null unless timed
  int L, B, S, E, EKV, KV, D, R, F, length;
  int n_chunk, ring, scores_in_smem;
  int act_bytes;         // the products' activation buffer
  int fold_act;          // ACT's epilogue applies GELU / SwiGLU (plan)
  int cache_bytes;       // 1 (int8 codes) or 2 (bf16)
  float eps, att_scale;
  int llama;            // RMSNorm, RoPE, rounded q.k products, SwiGLU (for
                        // plan: the device code takes it as LLAMA)
};

// Cache tiles of an attention group that share one ring slot (warp w's
// tile is piece w % per of slot w / per).
__host__ __device__ inline int tiles_per_slot(int D, int cache_bytes) {
  const int per = SLOT / (ATT_ROWS * D * cache_bytes);
  return per < WARPS ? per : WARPS;
}

// Floats of one warp's attention scratch: q, qc, o (R*D each), k, v and
// the two cache scales (D each), own score and weight (R each), and the
// R*S scores when they live in shared memory.
__host__ __device__ inline int att_floats(int D, int R, int S, bool scores) {
  return ((3 * R * D + 4 * D + 2 * R + (scores ? R * S : 0)) + 3) & ~3;
}

// Dynamic shared memory of one CTA: the ring, then one region that the
// products (the activation sub-tiles), the
// attention (its scratch and the scores) and the rows phases take in turn.
// The ring gets what the region leaves, at most p.ring slots and at least
// the slots an attention group's tiles of one side take; the scores go to
// global memory only where even that ring would not fit beside them. Sets p.ring,
// p.scores_in_smem and p.act_bytes; returns the bytes to ask for.
inline int layout(Params& p, int ctas_per_sm) {
  const int nc_max = chunk_width(p.B < p.n_chunk ? p.B : p.n_chunk);
  // whole stages of the widest chunk, up to 64 KB (24 KB at 2+ CTAs an SM:
  // 48 KB measured slower, tools/decode_sweep.py)
  const int stage = nc_max * KT * 2;
  const int target = ctas_per_sm == 1 ? 65536 : 24576;
  p.act_bytes = stage * (target / stage > 1 ? target / stage : 1);
  const int act = p.act_bytes;
  const int rows = (3 * p.E + 4) * 4;
  const int budget = int(SMEM_LIMIT) / ctas_per_sm - 2048;
  auto region = [&](bool scores) {
    const int att = WARPS * att_floats(p.D, p.R, p.S, scores) * 4;
    const int most = act > att ? act : att;
    return most > rows ? most : rows;
  };
  const int per = tiles_per_slot(p.D, p.cache_bytes);
  const int least = (WARPS + per - 1) / per;
  const bool scores = region(true) + least * SLOT <= budget;
  const int u = region(scores);
  int ring = p.ring < MAX_STAGES ? p.ring : MAX_STAGES;
  if (ring < least) ring = least;
  while (ring > least && ring * SLOT + u > budget) --ring;
  p.ring = ring;
  p.scores_in_smem = scores;
  return ring * SLOT + u + 1024;
}

// ---- the ring ------------------------------------------------------------

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* base;
  int stages;
  int n = 0;
  __device__ uint8_t* slot() const { return base + (n % stages) * SLOT; }
  // consumers: wait for the next slot to land
  __device__ uint8_t* wait() {
    mbar_wait(&full[n % stages], (n / stages) & 1);
    return slot();
  }
  // consumers: wait for the slot ``ahead`` positions on (< stages)
  __device__ uint8_t* wait_at(int ahead) const {
    const int k = n + ahead;
    mbar_wait(&full[k % stages], (k / stages) & 1);
    return base + (k % stages) * SLOT;
  }
  // consumers, after a consumer_sync: hand ``count`` slots back
  __device__ void release(int count = 1) {
    if (threadIdx.x == 0)
      for (int i = 0; i < count; ++i) mbar_arrive(&empty[(n + i) % stages]);
    n += count;
  }
  // producer: claim the next slot for ``bytes``
  __device__ uint8_t* claim(uint32_t bytes) {
    mbar_wait(&empty[n % stages], ((n / stages) & 1) ^ 1);
    mbar_expect_tx(&full[n % stages], bytes);
    return slot();
  }
  __device__ uint64_t* bar() { return &full[n % stages]; }
};

// ---- work lists (the producer and the consumers walk the same) -----------

__device__ __forceinline__ int chunks_of(const Params& p) {
  return (p.B + p.n_chunk - 1) / p.n_chunk;
}

// Output tiles of product q: 64 lanes each, except LLaMA's gate|up folded
// with its act, whose tile t is gate lanes and up lanes [64 t, 64 t + 64)
// together (two passes of one item, so its epilogue has both for silu(g) *
// u).
template <bool LLAMA>
__device__ __forceinline__ int tiles_of(const Params& p, int q) {
  return p.N[q] / TILE_M / (LLAMA && q == ACT && p.fold_act ? 2 : 1);
}

template <bool LLAMA>
__device__ __forceinline__ int product_items(const Params& p, int q) {
  return chunks_of(p) * tiles_of<LLAMA>(p, q) * p.splits[q];
}

// Item i of product q -> chunk c, tile t, split z (z fastest).
template <bool LLAMA>
__device__ __forceinline__ void product_item(const Params& p, int q, int i,
                                             int& c, int& t, int& z) {
  const int tiles = tiles_of<LLAMA>(p, q);
  z = i % p.splits[q];
  t = (i / p.splits[q]) % tiles;
  c = i / (p.splits[q] * tiles);
}

// The weight segment of tile t of product q and the tile's first lane in it.
__device__ __forceinline__ int segment(const Params& p, int q, int t,
                                       int& lane0) {
  int col = t * TILE_M, s = 0;
  while (s + 1 < p.nseg[q] && col >= p.seg_n[q][s]) col -= p.seg_n[q][s++];
  lane0 = col;
  return s;
}

__device__ __forceinline__ int attention_tiles(const Params& p) {
  return (p.length + ATT_ROWS - 1) / ATT_ROWS;
}

// Attention items (batch row, KV head) of this CTA: i = cta + k * G.
__device__ __forceinline__ int attention_items(const Params& p) {
  const int items = p.B * p.KV, G = gridDim.x, cta = blockIdx.x;
  return cta < items ? (items - cta + G - 1) / G : 0;
}

template <typename WT, typename CT, bool LLAMA>
__device__ void producer(const Params& p, const Maps& m, Ring& ring) {
  const int G = gridDim.x, cta = blockIdx.x;
  const uint32_t wbytes = KT * TILE_M * sizeof(WT);
  const uint32_t cbytes = ATT_ROWS * p.D * sizeof(CT);
  auto weights = [&](int q, int l) {
    const int items = product_items<LLAMA>(p, q);
    const int stages = p.K[q] / p.splits[q] / KT;
    const int passes = LLAMA && q == ACT && p.fold_act ? 2 : 1;
    for (int i = cta; i < items; i += G) {
      int c, t, z, lane0;
      product_item<LLAMA>(p, q, i, c, t, z);
      for (int pass = 0; pass < passes; ++pass) {
        // gate|up: segment ``pass`` at the same lanes
        const int s = passes == 2 ? pass : segment(p, q, t, lane0);
        if (passes == 2) lane0 = t * TILE_M;
        const CUtensorMap* map = &m.w[p.map_of[q][s]];
        for (int k = 0; k < stages; ++k) {
          // int8 tiles land in the slot's upper half (widened in place)
          uint8_t* dst =
              ring.claim(wbytes) + (sizeof(WT) == 1 ? SLOT / 2 : 0);
          tma_load_2d(dst, map, ring.bar(), lane0,
                      l * p.K[q] + (z * stages + k) * KT);
          ++ring.n;
        }
      }
    }
  };
  const int nt = attention_tiles(p);
  for (int l = 0; l < p.L; ++l) {
    weights(0, l);
    const int mine = attention_items(p);
    const int per = tiles_per_slot(p.D, sizeof(CT));
    for (int k0 = 0; k0 < mine; k0 += WARPS) {
      const int nw = min(WARPS, mine - k0);
      for (int side = 0; side < 2; ++side)
        for (int t = 0; t < nt; ++t)
          for (int w0 = 0; w0 < nw; w0 += per) {
            const int cnt = min(per, nw - w0);
            uint8_t* dst = ring.claim(cnt * cbytes);
            for (int w = 0; w < cnt; ++w) {
              const int i = cta + (k0 + w0 + w) * G;
              tma_load(dst + w * cbytes, side ? &m.vc : &m.kc, ring.bar(),
                       (i % p.KV) * p.D, t * ATT_ROWS, l * p.B + i / p.KV);
            }
            ++ring.n;
          }
    }
    weights(1, l);
    weights(2, l);
    weights(3, l);
  }
}

// ---- consumers -------------------------------------------------------------

// y[u] = sum_z part[z, row[u], col[u]] in split order, times the
// segment's w8 scale, plus bias[col[u]] (bias an [N] row or null), for the
// U entries with row[u] >= 0: every load of a batch of up to 4 splits (and
// the scales and biases) is issued before any is used, so a thread waits
// on L2 once a batch, not once a load.
template <int U>
__device__ __forceinline__ void finalize(const Params& p, int q, int l,
                                         const int (&row)[U],
                                         const int (&col)[U],
                                         const float* bias, float (&y)[U]) {
  const size_t plane = size_t(p.B) * p.N[q];
  const int splits = p.splits[q];
  float sc[U], bv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    y[u] = 0.f;
    int s = 0, c = col[u];
    while (s + 1 < p.nseg[q] && c >= p.seg_n[q][s]) c -= p.seg_n[q][s++];
    const float* scale = p.scale[q][s];
    sc[u] = row[u] >= 0 && scale != nullptr
                ? __ldg(scale + size_t(l) * p.seg_n[q][s] + c)
                : 1.f;
    bv[u] = row[u] >= 0 && bias != nullptr ? __ldg(bias + col[u]) : 0.f;
  }
  for (int z0 = 0; z0 < splits; z0 += 4) {
    float v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[u][k] = row[u] >= 0 && z0 + k < splits
                      ? __ldcg(p.part + (z0 + k) * plane +
                               size_t(row[u]) * p.N[q] + col[u])
                      : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (z0 + k < splits) y[u] += v[u][k];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p.scale[q][0] != nullptr) y[u] *= sc[u];
    if (bias != nullptr) y[u] += bv[u];
  }
}


// Rows [n0, n0 + NC) x depth [k0, k0 + ns * KT) of the bf16 activation
// a [B, K] into 2 * ns K-major 128-byte-swizzled sub-tiles of NC rows x 64
// (rows past B are zeros): 16-byte cp.async copies from L2 (.cg, so no
// stale L1 line of a row another CTA wrote), all in flight at once; the
// caller waits for them (cp_async_wait) before a consumer_sync.
template <int NC>
__device__ __forceinline__ void load_act(const bf16* a, int K, int B, int n0,
                                         int k0, int ns, uint8_t* dst) {
  const int per_row = 16 * ns;
  for (int i = threadIdx.x; i < NC * per_row; i += CONSUMERS) {
    const int r = i / per_row, ch = i % per_row;
    const bool in = n0 + r < B;
    const bf16* src = a + size_t(in ? n0 + r : 0) * K + k0 + ch * 8;
    const uint32_t to = smem_u32(dst + (ch >> 3) * NC * 128 + r * 128 +
                                 (((ch & 7) ^ (r & 7)) << 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The int8 [KT, 64] weight tile that TMA put, unswizzled, in the upper half
// of a ring slot, widened in place to the bf16 tile TMA would have stored
// (128-byte swizzle) across the whole slot: every thread reads its pieces
// before any thread writes.
__device__ __forceinline__ void widen_tile(uint8_t* slot) {
  constexpr int PER = KT * 8 / CONSUMERS;   // 8-code pieces a thread
  const uint8_t* src = slot + SLOT / 2;
  uint2 raw[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = threadIdx.x + m * CONSUMERS, k = i >> 3, c = i & 7;
    raw[m] = *reinterpret_cast<const uint2*>(src + k * 64 + c * 8);
  }
  consumer_sync();
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = threadIdx.x + m * CONSUMERS, k = i >> 3, c = i & 7;
    const int8_t* w = reinterpret_cast<const int8_t*>(&raw[m]);
    __align__(16) bf16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(float(w[e]));
    *reinterpret_cast<uint4*>(slot + k * 128 + ((c ^ (k & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// acc (f32, zeroed first) = rows [n0, n0 + NC) of a over depth [k0, k0 +
// stages * KT) times the weight tiles the ring brings, in order: the
// activation sub-tiles load a block of stages at a time, each stage waits
// for its tile (int8 tiles widen first) and runs KT / 16 wgmma k-steps.
template <int NC, typename WT>
__device__ void accumulate(const Params& p, int q, const bf16* a, int n0,
                           int k0, int stages, Ring& ring, uint8_t* smem,
                           float (&acc)[NC / 2]) {
  const int block = min(16, p.act_bytes / (NC * KT * 2));
  uint8_t* abuf = smem;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < stages; s0 += block) {
    const int ns = min(block, stages - s0);
    load_act<NC>(a, p.K[q], p.B, n0, k0 + s0 * KT, ns, abuf);
    cp_async_wait();
    fence_async_smem();
    consumer_sync();
    for (int s = 0; s < ns; ++s) {
      uint8_t* tile = ring.wait();
      if (sizeof(WT) == 1) {
        widen_tile(tile);
        fence_async_smem();
        consumer_sync();
      }
      fence_regs(acc);
      wgmma_fence();
      const uint32_t wa = smem_u32(tile);
      const uint32_t ba = smem_u32(abuf) + s * 2 * NC * 128;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        WgmmaT<NC>::mma(acc, smem_desc<64>(wa + kk * 2048, true),
                        smem_desc<64>(ba + (kk >> 2) * NC * 128 +
                                          (kk & 3) * 32,
                                      false),
                        1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      consumer_sync();   // every wgmma done: the slot is free
      ring.release();
    }
  }
}

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// One product item of layer l: chunk c of the batch rows, output tile t,
// depth split z. A thread holds lanes m0 and m0 + 8 of the tile (m0 = 16 w
// + g) for rows 8 j + 2 u (+ 1) of the chunk. Products other than a folded
// ACT write their f32 partial part[z, row, lane]; a folded ACT writes act =
// bf16(gelu(y * scale + bias)) (GPT-2), or with the up tile's pass after
// the gate's bf16(silu(g) * u), g and u each times its w8 scale (LLaMA).
template <int NC, typename WT, bool LLAMA>
__device__ void product_tile(const Params& p, int q, int l, const bf16* a,
                             int c, int t, int z, Ring& ring, uint8_t* smem) {
  const int stages = p.K[q] / p.splits[q] / KT;
  const int n0 = c * p.n_chunk;
  float acc[NC / 2];
  accumulate<NC, WT>(p, q, a, n0, z * stages * KT, stages, ring, smem, acc);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, u = lane & 3;
  const int m0 = t * TILE_M + 16 * w + g;
  if (q != ACT || !p.fold_act) {
    float* dst = p.part + size_t(z) * p.B * p.N[q] + m0;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = n0 + 8 * j + 2 * u + e;
        if (row < p.B) {
          dst[size_t(row) * p.N[q]] = acc[4 * j + e];
          dst[size_t(row) * p.N[q] + 8] = acc[4 * j + 2 + e];
        }
      }
    return;
  }
  const int F = p.F;
  const size_t lf = size_t(l) * F;
  float gate[NC / 2], sg[2], su[2], bv[2];
  if (LLAMA) {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) gate[i] = acc[i];
    accumulate<NC, WT>(p, q, a, n0, 0, stages, ring, smem, acc);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 8 * h;
    const float* s0 = p.scale[q][0];
    const float* s1 = LLAMA ? p.scale[q][1] : nullptr;
    sg[h] = s0 == nullptr ? 1.f : __ldg(s0 + lf + m);
    su[h] = s1 == nullptr ? 1.f : __ldg(s1 + lf + m);
    bv[h] = LLAMA ? 0.f : __ldg(p.bias[q] + lf + m);
  }
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = n0 + 8 * j + 2 * u + e;
      if (row >= p.B) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        float y;
        if (LLAMA) {
          const float gt = gate[i] * sg[h], up = acc[i] * su[h];
          y = gt * (1.f / (1.f + expf(-gt))) * up;
        } else {
          y = gelu_erf(acc[i] * sg[h] + bv[h]);
        }
        p.act[size_t(row) * F + m0 + 8 * h] = __float2bfloat16(y);
      }
    }
}

template <typename WT, bool LLAMA>
__device__ void product(const Params& p, int q, int l, const bf16* a,
                        Ring& ring, uint8_t* smem) {
  const int items = product_items<LLAMA>(p, q);
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int c, t, z;
    product_item<LLAMA>(p, q, i, c, t, z);
    const int rows = min(p.n_chunk, p.B - c * p.n_chunk);
    switch (chunk_width(rows)) {
      case 8:
        product_tile<8, WT, LLAMA>(p, q, l, a, c, t, z, ring, smem);
        break;
      case 16:
        product_tile<16, WT, LLAMA>(p, q, l, a, c, t, z, ring, smem);
        break;
      default:
        product_tile<32, WT, LLAMA>(p, q, l, a, c, t, z, ring, smem);
        break;
    }
  }
}

// RoPE of adjacent pairs in f32, as the JAX _rot_row: out[2i] = x[2i] c -
// x[2i+1] s, out[2i+1] = x[2i+1] c + x[2i] s, each product and the sum
// rounded once (no FMA contraction).
__device__ __forceinline__ float rotate(const float* x, int i, float c,
                                        float s) {
  const float partner = (i & 1) ? x[i - 1] : -x[i + 1];
  return __fadd_rn(__fmul_rn(x[i], c), __fmul_rn(partner, s));
}

// %globaltimer split of a CTA's time (thread 0's view), on when stamps
// were asked for: mark(k) adds the ns since the last mark to slot k.
struct Timer {
  bool on;
  uint64_t t0;
  uint64_t spent[STAMPS];
  __device__ void mark(int k) {
    if (!on || threadIdx.x != 0) return;
    const uint64_t t = now_ns();
    spent[k] += t - t0;
    t0 = t;
  }
};

// 16 bytes of cache row as floats (8 bf16 or 16 int8 codes).
__device__ __forceinline__ int widen16(const bf16* src, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(v[e]);
  return 8;
}
__device__ __forceinline__ int widen16(const int8_t* src, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = float(v[e]);
  return 16;
}

// The attention phase of layer l. Each warp takes one item (batch row b, KV
// head g with its R query heads) at a time, the CTA's items in groups of
// WARPS; per cache tile the producer streams the group's tiles in warp
// order (all K tiles, then all V tiles) and the group releases them
// together. An item attends over cache rows < length plus the token's own
// k and v, then writes the new rows at row `length`. The scores of cached
// rows take q (times k_scale for an int8 cache) rounded to bf16 (LLaMA:
// each q * k product also rounds to bf16 before the f32 sum); the own
// score and own-value term stay f32; the probabilities round to bf16
// before the f32 AV sum (JAX's rounding points, which forbid an online
// rescale: all S scores are kept).
template <typename CT, bool LLAMA>
__device__ void attention_phase(const Params& p, int l, Ring& ring,
                                float* sm, float* scores_g, Timer& clock) {
  constexpr int VEC = 16 / sizeof(CT);
  const int D = p.D, R = p.R, RD = R * D, E = p.E, EKV = p.EKV, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = gridDim.x, mine = attention_items(p), nt = attention_tiles(p);
  float* sq = sm + warp * att_floats(D, R, S, p.scores_in_smem);
  float* sqc = sq + RD;      // q for the cache: scaled, rounded
  float* so = sqc + RD;      // o partial sums
  float* sk = so + RD;       // own k (rotated)
  float* sv = sk + D;        // own v
  float* s_own = sv + D;
  float* w_own = s_own + R;
  float* sks = w_own + R;    // the cache scales of the item's D lanes
  float* svs = sks + D;
  float* sp = p.scores_in_smem ? svs + D
                               : scores_g + size_t(warp) * R * S;
  const float* bq = p.bias[0];
  const float* ks = p.k_scale ? p.k_scale + size_t(l) * EKV : nullptr;
  const float* vs = p.v_scale ? p.v_scale + size_t(l) * EKV : nullptr;
  const int chunks = D / VEC;   // 16-byte pieces of a cache row
  const int per = tiles_per_slot(D, sizeof(CT));
  const int tile_off = (warp % per) * ATT_ROWS * D;   // this warp's tile
  for (int k0 = 0; k0 < mine; k0 += WARPS) {
    const int nw = min(WARPS, mine - k0);
    const bool active = warp < nw;
    const int i = blockIdx.x + (k0 + warp) * G;
    const int b = i / p.KV, g = i % p.KV;
    const int qcol = g * RD, kcol = g * D;
    if (active) {
      // q, k, v of the item (raw: q into so, k into sqc, then rotated into
      // sq and sk where there is RoPE), 8 entries a lane at once; the
      // tables and scales the item needs load in the same wave
      const bool rope = LLAMA;
      float* qdst = rope ? so : sq;
      float* kdst = rope ? sqc : sk;
      const float* brow = bq == nullptr ? nullptr : bq + size_t(l) * p.N[0];
      float ksv[4], vsv[4];   // D <= 128: four lanes' worth a thread
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = lane + 32 * u;
        ksv[u] = ks != nullptr && j < D ? __ldg(ks + kcol + j) : 1.f;
        vsv[u] = vs != nullptr && j < D ? __ldg(vs + kcol + j) : 1.f;
      }
      for (int x0 = 0; x0 < RD + 2 * D; x0 += 32 * 8) {
        int row[8], col[8];
        float y[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int x = x0 + u * 32 + lane;
          row[u] = x < RD + 2 * D ? b : -1;
          col[u] = x < RD ? qcol + x
                          : x < RD + D ? E + kcol + (x - RD)
                                       : E + EKV + kcol + (x - RD - D);
        }
        finalize<8>(p, 0, l, row, col, brow, y);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int x = x0 + u * 32 + lane;
          if (row[u] < 0) continue;
          if (x < RD) qdst[x] = y[u];
          else if (x < RD + D) kdst[x - RD] = y[u];
          else sv[x - RD - D] = y[u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = lane + 32 * u;
        if (j < D) {
          sks[j] = ksv[u];
          svs[j] = vsv[u];
        }
      }
      __syncwarp();
      if (rope) {
        for (int j = lane; j < RD; j += 32)
          sq[j] = rotate(so, j, __ldg(p.cos + qcol + j),
                         __ldg(p.sin + qcol + j));
        for (int j = lane; j < D; j += 32)
          sk[j] = rotate(sqc, j, __ldg(p.cos + kcol + j),
                         __ldg(p.sin + kcol + j));
        __syncwarp();
      }
      for (int j = lane; j < RD; j += 32) {
        const int d = j % D;
        sqc[j] = round_bf16(ks == nullptr ? sq[j] : sq[j] * sks[d]);
        so[j] = 0.f;
      }
      for (int r = 0; r < R; ++r) {
        float acc = 0.f;
        for (int d = lane; d < D; d += 32) acc += sq[r * D + d] * sk[d];
        acc = warp_sum(acc);
        if (lane == 0) s_own[r] = acc * p.att_scale;
      }
      __syncwarp();
    }
    clock.mark(4);
    // scores: lane j of the warp takes rows j and j + 32 of each K tile
    // for all R query heads, reading the row in 16-byte pieces that start
    // at piece j (no two lanes of a quarter-warp on one bank)
    for (int t = 0; t < nt; ++t) {
      if (active) {
        const CT* rows =
            reinterpret_cast<const CT*>(ring.wait_at(warp / per)) + tile_off;
        const int j0 = t * ATT_ROWS, n = min(ATT_ROWS, p.length - j0);
        for (int j = lane; j < n; j += 32) {
          for (int r = 0; r < R; ++r) {
            const float* qr = sqc + r * D;
            float acc = 0.f;
            for (int c = 0; c < chunks; ++c) {
              const int piece = (c + j) % chunks;
              float v[VEC];
              widen16(rows + j * D + piece * VEC, v);
              if (LLAMA) {
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  acc += round_bf16(qr[piece * VEC + e] * v[e]);
              } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc += qr[piece * VEC + e] * v[e];
              }
            }
            sp[r * S + j0 + j] = acc * p.att_scale;
          }
        }
      }
      consumer_sync();
      ring.release((nw + per - 1) / per);
    }
    clock.mark(5);
    if (active) {
      __syncwarp();
      for (int r = 0; r < R; ++r) {
        float* pr = sp + r * S;
        float mx = s_own[r];
        for (int j = lane; j < p.length; j += 32) mx = fmaxf(mx, pr[j]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < p.length; j += 32) {
          const float e = expf(pr[j] - mx);
          pr[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        const float p_own = expf(s_own[r] - mx);
        const float denom = sum + p_own;
        for (int j = lane; j < p.length; j += 32)
          pr[j] = round_bf16(pr[j] / denom);
        if (lane == 0) w_own[r] = p_own / denom;
      }
      __syncwarp();
    }
    // o[r, d] = sum_j p[r, j] v[j, d] in f32: each output has one owner
    // lane, which sums the tiles in row order; each V row is read once for
    // all R query heads
    for (int t = 0; t < nt; ++t) {
      if (active) {
        const CT* rows =
            reinterpret_cast<const CT*>(ring.wait_at(warp / per)) + tile_off;
        const int j0 = t * ATT_ROWS, n = min(ATT_ROWS, p.length - j0);
        for (int o = lane; o < RD; o += 32) {
          const int r = o / D, d = o % D;
          const float* pr = sp + r * S + j0;
          float acc = so[o];
          for (int j = 0; j < n; ++j) acc += pr[j] * widen(rows[j * D + d]);
          so[o] = acc;
        }
      }
      consumer_sync();
      ring.release((nw + per - 1) / per);
    }
    clock.mark(6);
    if (active) {
      CT* kc = static_cast<CT*>(p.k_cache) +
               ((size_t(l) * p.B + b) * S + p.length) * EKV + kcol;
      CT* vc = static_cast<CT*>(p.v_cache) +
               ((size_t(l) * p.B + b) * S + p.length) * EKV + kcol;
      __syncwarp();
      for (int o = lane; o < RD; o += 32) {
        const int r = o / D, d = o % D;
        float out = so[o];
        if (vs != nullptr) out *= svs[d];
        out += w_own[r] * sv[d];
        p.h[size_t(b) * E + qcol + o] = __float2bfloat16(out);
      }
      for (int d = lane; d < D; d += 32) {
        put(kc + d, sk[d], sks[d]);
        put(vc + d, sv[d], svs[d]);
      }
      __syncwarp();   // the scratch is reused by the next item
    }
    clock.mark(7);
  }
}

// Norm of the f32 row xr (shared; w and bias its weights, staged in shared
// memory beside it) into h[b]: LayerNorm ((x - mu) * rstd * w + b) or,
// with bias null, RMSNorm (x * rsqrt(mean(x^2) + eps) * w), rounded to
// bf16.
__device__ inline void norm_row(const Params& p, const float* xr,
                                const float* w, const float* bias, bf16* out,
                                float* red) {
  const int E = p.E;
  if (bias != nullptr) {
    float s = 0.f;
    for (int i = threadIdx.x; i < E; i += CONSUMERS) s += xr[i];
    const float mu = group_sum(s, red) / E;
    float sq = 0.f;
    for (int i = threadIdx.x; i < E; i += CONSUMERS) {
      const float d = xr[i] - mu;
      sq += d * d;
    }
    const float rstd = rsqrtf(group_sum(sq, red) / E + p.eps);
    for (int i = threadIdx.x; i < E; i += CONSUMERS)
      out[i] = __float2bfloat16((xr[i] - mu) * rstd * w[i] + bias[i]);
  } else {
    float sq = 0.f;
    for (int i = threadIdx.x; i < E; i += CONSUMERS) sq += xr[i] * xr[i];
    const float r = rsqrtf(group_sum(sq, red) / E + p.eps);
    for (int i = threadIdx.x; i < E; i += CONSUMERS)
      out[i] = __float2bfloat16(xr[i] * r * w[i]);
  }
}

// Rows phase. q < 0: x_res = float(x_in) (before layer 0); else x_res +=
// layer l's product q (+ its bias). Then the norm of weights w and bias
// ([E] rows of the layer it belongs to) into h, or with w null the output
// cast.
__device__ inline void rows_phase(const Params& p, int q, int l,
                                  const float* w, const float* bias,
                                  float* sm) {
  float* red = sm;
  float* xr = sm + 4;
  float* xw = xr + p.E;   // the norm's weights and bias, staged with x
  float* xb = xw + p.E;
  constexpr int RF = 8;   // entries a thread takes at once
  const float* pb = q < 0 ? nullptr : p.bias[q];
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float* x = p.x_res + size_t(b) * p.E;
    for (int i0 = 0; i0 < p.E; i0 += RF * CONSUMERS) {
      int row[RF], col[RF];
      float y[RF] = {};
#pragma unroll
      for (int u = 0; u < RF; ++u) {
        col[u] = i0 + u * CONSUMERS + threadIdx.x;
        row[u] = q >= 0 && col[u] < p.E ? b : -1;
      }
      float xo[RF], bb[RF], wv[RF], bv[RF];
#pragma unroll
      for (int u = 0; u < RF; ++u) {
        const bool in = col[u] < p.E;
        xo[u] = !in ? 0.f
                : q < 0 ? __bfloat162float(p.x_in[size_t(b) * p.E + col[u]])
                        : __ldcg(x + col[u]);
        bb[u] = in && pb != nullptr ? __ldg(pb + size_t(l) * p.E + col[u])
                                    : 0.f;
        wv[u] = in && w != nullptr ? __ldg(w + col[u]) : 0.f;
        bv[u] = in && bias != nullptr ? __ldg(bias + col[u]) : 0.f;
      }
      if (q >= 0) finalize<RF>(p, q, l, row, col, nullptr, y);
#pragma unroll
      for (int u = 0; u < RF; ++u) {
        const int i = col[u];
        if (i >= p.E) continue;
        // (x + y) + bias, the JAX chain's order
        const float v = q < 0 ? xo[u]
                        : pb == nullptr ? xo[u] + y[u]
                                        : (xo[u] + y[u]) + bb[u];
        xr[i] = v;
        x[i] = v;
        if (w != nullptr) xw[i] = wv[u];
        if (bias != nullptr) xb[i] = bv[u];
        if (w == nullptr) p.x_out[size_t(b) * p.E + i] = __float2bfloat16(v);
      }
    }
    consumer_sync();
    if (w != nullptr)
      norm_row(p, xr, xw, bias == nullptr ? nullptr : xb,
               p.h + size_t(b) * p.E, red);
    consumer_sync();
  }
}

// act = bf16(gelu(fc + bias)) (GPT-2) or bf16(silu(g) * u) (LLaMA: g and u
// the columns [0, F) and [F, 2F) of the gate|up product), from ACT's split
// partials (an ACT that is not folded into its epilogue).
template <bool LLAMA>
__device__ void act_phase(const Params& p, int l) {
  constexpr int AF = 4;   // outputs a thread takes at once
  const int F = p.F;
  const size_t n = size_t(p.B) * F;
  const size_t step = size_t(gridDim.x) * CONSUMERS;
  for (size_t i0 = size_t(blockIdx.x) * CONSUMERS + threadIdx.x; i0 < n;
       i0 += AF * step) {
    // entries [0, AF): fc or gate columns; [AF, 2 AF): up columns (LLaMA)
    int row[2 * AF], col[2 * AF];
    float y[2 * AF];
#pragma unroll
    for (int u = 0; u < AF; ++u) {
      const size_t i = i0 + u * step;
      row[u] = i < n ? int(i / F) : -1;
      col[u] = i < n ? int(i % F) : 0;
      row[AF + u] = LLAMA ? row[u] : -1;
      col[AF + u] = col[u] + F;
    }
    finalize<2 * AF>(p, ACT, l, row, col,
                     LLAMA ? nullptr : p.bias[ACT] + size_t(l) * F, y);
#pragma unroll
    for (int u = 0; u < AF; ++u) {
      if (row[u] < 0) continue;
      const float g = y[u];
      p.act[i0 + u * step] = __float2bfloat16(
          LLAMA ? g * (1.f / (1.f + expf(-g))) * y[AF + u] : gelu_erf(g));
    }
  }
}

// The whole launch: every layer's phases, the producer warp streaming.
template <typename WT, typename CT, bool LLAMA>
__device__ void decode_body(const Params& p, const Maps& m) {
  extern __shared__ uint8_t raw_smem[];
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  uint8_t* smem = aligned_smem(raw_smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring ring{full, empty, smem, p.ring};
  if (threadIdx.x >= CONSUMERS) {   // the producer warp
    if (threadIdx.x == CONSUMERS) producer<WT, CT, LLAMA>(p, m, ring);
    return;
  }
  uint8_t* work = smem + p.ring * SLOT;
  float* sm = reinterpret_cast<float*>(work);
  float* scores_g = p.scores_g + size_t(blockIdx.x) * WARPS * p.R * p.S;
  const unsigned G = gridDim.x;
  const size_t E = p.E;
  auto layer = [](const float* a, int l, size_t n) {
    return a == nullptr ? nullptr : a + l * n;
  };
  Timer clock{p.stamps != nullptr, p.stamps != nullptr ? now_ns() : 0, {}};
  auto mark = [&](int k) { clock.mark(k); };
  unsigned target = 0;
  auto sync = [&]() {
    grid_sync(p.bar, G, target);
    mark(3);
  };
  rows_phase(p, -1, 0, p.norm1_w, p.norm1_b, sm);
  mark(2);
  for (int l = 0; l < p.L; ++l) {
    sync();
    product<WT, LLAMA>(p, 0, l, p.h, ring, work);
    mark(0);
    sync();
    attention_phase<CT, LLAMA>(p, l, ring, sm, scores_g, clock);
    mark(1);
    sync();
    product<WT, LLAMA>(p, 1, l, p.h, ring, work);
    mark(0);
    sync();
    rows_phase(p, 1, l, layer(p.norm2_w, l, E), layer(p.norm2_b, l, E), sm);
    mark(2);
    sync();
    product<WT, LLAMA>(p, ACT, l, p.h, ring, work);
    mark(0);
    sync();
    if (!p.fold_act) {
      act_phase<LLAMA>(p, l);
      mark(2);
      sync();
    }
    product<WT, LLAMA>(p, 3, l, p.act, ring, work);
    mark(0);
    sync();
    const bool last = l == p.L - 1;
    rows_phase(p, 3, l, last ? nullptr : layer(p.norm1_w, l + 1, E),
               last ? nullptr : layer(p.norm1_b, l + 1, E), sm);
    mark(2);
  }
  grid_done(p.bar, G);
  if (clock.on && threadIdx.x == 0)
    for (int k = 0; k < STAMPS; ++k)
      p.stamps[blockIdx.x * STAMPS + k] = clock.spent[k];
}

// ---- host ------------------------------------------------------------------

// The TMA map of a stacked weight [L, K, n] (L*K rows of n lanes) read in
// tiles of KT rows x 64 lanes: bf16 tiles 128-byte swizzled as wgmma reads
// them, int8 tiles unswizzled (widened in shared memory).
inline bool weight_map(CUtensorMap* map, const void* base, int rows, int n,
                       bool int8) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(n), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(n) * (int8 ? 1 : 2)};
  const cuuint32_t box[2] = {TILE_M, KT};
  const cuuint32_t step[2] = {1, 1};
  return encode(map,
                int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA map of a cache [L, B, S, E_kv] (dims {E_kv, S, L*B}) read in
// tiles of ATT_ROWS rows x D lanes, unswizzled; rows past S arrive as
// zeros.
inline bool cache_map(CUtensorMap* map, const void* base, int LB, int S,
                      int EKV, int D, bool int8) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t cb = int8 ? 1 : 2;
  const cuuint64_t dims[3] = {cuuint64_t(EKV), cuuint64_t(S),
                              cuuint64_t(LB)};
  const cuuint64_t strides[2] = {EKV * cb, cuuint64_t(S) * EKV * cb};
  const cuuint32_t box[3] = {cuuint32_t(D), ATT_ROWS, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the launch knobs are ones the kernel takes.
inline bool knobs_ok(int ctas_per_sm, int ring, int items, int n_chunk) {
  return ctas_per_sm >= 1 && ctas_per_sm <= 4 && ring >= 1 &&
         ring <= MAX_STAGES && items >= 1 &&
         n_chunk >= 8 && n_chunk <= N_CHUNK_MAX &&
         chunk_width(n_chunk) == n_chunk;
}

// Depth splits of each product for a target of ``items`` work items. The
// fc / gate|up product (ACT) takes its whole depth in one item and applies
// GELU / SwiGLU in its epilogue (no partials, no phase of its own) when its
// items (a gate|up item holds both tiles of its lanes) fill at least half
// the target; else (small batches, wide layers) it splits its depth like
// the others and an act phase applies GELU / SwiGLU to the partials.
inline void plan(Params& p, int items) {
  const int chunks = (p.B + p.n_chunk - 1) / p.n_chunk;
  const int folded = p.N[ACT] / TILE_M / (p.llama ? 2 : 1) * chunks;
  p.fold_act = 2 * folded >= items;
  for (int q = 0; q < PRODUCTS; ++q)
    p.splits[q] = q == ACT && p.fold_act
                      ? 1
                      : depth_splits(p.K[q], p.N[q] / TILE_M, chunks, items);
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Bytes of workspace p (planned) needs for grids of up to ``max_ctas``:
// x_res, h, act, the largest product's partials and the score rows of
// every CTA. With ws non-null, p's buffers are carved from it.
inline size_t workspace(Params& p, int max_ctas, void* ws) {
  uint8_t* base = static_cast<uint8_t*>(ws);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* at = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) & ~size_t(255);
    return at;
  };
  size_t most = 0;
  for (int q = 0; q < PRODUCTS; ++q) {
    const size_t n = size_t(p.splits[q]) * p.B * p.N[q];
    if (n > most) most = n;
  }
  p.x_res = static_cast<float*>(take(size_t(p.B) * p.E * 4));
  p.h = static_cast<bf16*>(take(size_t(p.B) * p.E * 2));
  p.act = static_cast<bf16*>(take(size_t(p.B) * p.F * 2));
  p.part = static_cast<float*>(take(most * 4));
  p.scores_g =
      static_cast<float*>(take(size_t(max_ctas) * WARPS * p.R * p.S * 4));
  return off;
}

// The grid (CTAs an SM the card holds, at most ctas_per_sm, times the SMs)
// and the dynamic shared memory of ``kernel`` for p; sets p.ring and
// p.scores_in_smem. 0 or a cudaError_t.
template <typename Kernel>
int configure(Kernel kernel, Params& p, int ctas_per_sm, int* grid,
              int* smem, int* resident) {
  *smem = layout(p, ctas_per_sm);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                      THREADS, *smem);
  if (err != cudaSuccess) return int(err);
  if (*resident < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  *grid = (*resident < ctas_per_sm ? *resident : ctas_per_sm) * sm_count();
  return 0;
}

// One cooperative launch: a grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge), never run to a hang.
template <typename Kernel>
int launch(Kernel kernel, Params& p, Maps& m, int ctas_per_sm,
           cudaStream_t st) {
  int grid = 0, smem = 0, resident = 0;
  const int err = configure(kernel, p, ctas_per_sm, &grid, &smem,
                            &resident);
  if (err != 0) return err;
  void* args[] = {&p, &m};
  return int(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                         dim3(grid), dim3(THREADS), args,
                                         size_t(smem), st));
}

// out: grid, registers a thread, resident CTAs an SM, dynamic shared bytes,
// ring slots, scores in shared memory (1) or global (0), local-memory bytes
// a thread (spills), the depth splits of the four products, and whether
// ACT's epilogue applies GELU / SwiGLU (1) or an act phase does (0).
template <typename Kernel>
int describe(Kernel kernel, Params& p, int ctas_per_sm, int* out) {
  int grid = 0, smem = 0, resident = 0;
  const int err = configure(kernel, p, ctas_per_sm, &grid, &smem,
                            &resident);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return int(e);
  const int vals[12] = {grid,          attr.numRegs,   resident,
                        smem,          p.ring,         p.scores_in_smem,
                        int(attr.localSizeBytes), p.splits[0], p.splits[1],
                        p.splits[2],   p.splits[3],    p.fold_act};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace decode
}  // namespace fk
