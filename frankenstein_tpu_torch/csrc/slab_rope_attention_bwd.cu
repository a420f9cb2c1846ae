// K4: backward of K1, the slab-causal flash attention with RoPE, for
// Hopper (sm_90a): a rotation pre-pass, then a dq pass and a dk/dv pass
// built from the TMA rings, wgmma products and exp2 of K7 dense
// (hopper_blocks.cuh).
//
// Replaces frankenstein_tpu/ops/pallas/block_attention.py:
// _slab_rope_attention_bwd (:1595) with what it runs: the XLA rotations of
// q and k (:1613-1614), _bwd_packed (:658, calls :685 and :721) or the
// per-head _bwd (:396, calls :436 and :484), and the rotations of dq and
// dk back (:1627-1628, :1639-1640). Contract:
//   q, k, v    [B, T, E] bf16, UNROTATED, as K1 took them
//   cos, sin   [T, D] f32 lane tables, as K1 took them
//   out        [B, T, E] bf16, K1's output
//   lse        [B, H, T] f32, K1's per-row logsumexp (natural units)
//   dout       [B, T, E] bf16, the gradient of out
//   qr, kr     [B, T, E] bf16 workspace: q and k rotated by the pre-pass
//   delta      [B, H, T] f32 workspace: rowsum(f32(out) * f32(dout))
//   dq, dk, dv [B, T, E] bf16, gradients of the UNROTATED q, k, v
// D in {32, 64}, T % 128 == 0, any P > 0. Key j is visible to query i iff
// j / P <= i / P.
//
// What it computes, as the JAX package does:
//   s = (q_rot k_rot^T) * scale, p = exp(s - lse) (0 where masked),
//   dp = dout v^T, ds = bf16(p * (dp - delta) * scale),
//   dq_rot = ds k_rot, dk_rot = ds^T q_rot, dv = bf16(p)^T dout,
// all products bf16 x bf16 with f32 accumulation. The pre-pass rotates q
// and k once with K1's own code (mma_bf16.cuh: load_rotate8), so the
// recomputed scores are K1's scores and p's rows sum to 1 against K1's
// lse. The epilogues round dq_rot / dk_rot to bf16 (where the JAX package
// casts its kernel outputs), rotate them back by R(-theta) in f32 and
// round again: rope.apply_rope_folded(x, cos, -sin).
//
// Three launches on one stream, no atomics, a fixed order of every sum:
// two launches of K4 are bitwise equal.
//   * pre-pass: one thread a 16-byte chunk of a (row, head); writes qr, kr
//     and delta (the chunks' sums added across the head's threads by a
//     fixed shuffle tree). 4 reads and 3 writes of [B, T, E]: bytes bound.
//   * dq pass: one CTA per (NWG*64 query rows, head, batch row), heaviest
//     row block first (its keys run to the end of its last row's slab).
//     One producer warp streams (kr, v) tiles of BN keys through a ring of
//     TMA loads up to the CTA's furthest key; each consumer warpgroup of 64
//     rows walks the tiles its rows see, S = Q K^T and dP = dO V^T issued
//     with the previous tile's dQ += dS K, and waits for and releases the
//     tiles past its last slab, so the ring never stalls.
//   * dk/dv pass: one CTA per (NWG*64 keys, head, batch row), the producer
//     loads the K, V rows once and streams (qr, dout, lse, delta) tiles of
//     BN queries from the first row that sees the CTA's first key; each
//     warpgroup releases the tiles before its own first visible row.
// Every product is a wgmma: the score products from shared memory as TMA
// stored them, the accumulating ones with A from registers (the f32 tile
// rounded to bf16 in place) and B through the transpose-B bit. exp is
// ex2.approx of one FFMA with lse in log2 units (converted once a row).
//
// Masks are two compile-time instances. Where P is a multiple of 64 (the
// key tile and the warpgroup's rows; the flagship's P = 256, and P = T)
// every (warpgroup, tile) pair the loops visit is wholly visible: the
// unmasked instance carries no mask code. Every other P takes the masked
// instance, which masks per element only the tiles that cross the
// warpgroup's slab boundary (flash_mask.cuh: slab_of<kSlab>).
//
// What bounds it on an H100: at D = 32 the exps, one ex2 a visible pair a
// pass (at 16 a clock an SM: 0.163 ms at B=2, T=6144, H=8, P=256), above
// the products (14*D ops a visible pair issued, 10*D needed: 0.142 and
// 0.102 ms); the tiles are re-read from L2.

#include "flash_host.cuh"
#include "flash_mask.cuh"
#include "hopper_blocks.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fk;

constexpr int PREP_THREADS = 256;

// Round an f32 pair (lanes 2i, 2i+1) to bf16, rotate it by R(-theta) in f32
// and round again: (x0 c + x1 s, x1 c - x0 s), unfused, as the twin's
// rope.apply_rope_folded(bf16(x), cos, -sin).
__device__ __forceinline__ uint32_t unrotate_pair(float a0, float a1,
                                                  const float* cos_row,
                                                  const float* sin_row) {
  const float x0 = __bfloat162float(__float2bfloat16_rn(a0));
  const float x1 = __bfloat162float(__float2bfloat16_rn(a1));
  return pack_bf16(
      __fadd_rn(__fmul_rn(x0, cos_row[0]), __fmul_rn(x1, sin_row[0])),
      __fadd_rn(__fmul_rn(x1, cos_row[1]), __fmul_rn(x0, -sin_row[1])));
}

// Rows r0 and r0 + 8 of a warpgroup's 64 x D accumulator (this thread's
// columns 8n + 2t + {0, 1}, from column c0 = 2t) rounded to bf16 and
// rotated back at positions pos0 / pos1.
template <int D>
__device__ __forceinline__ void store_unrotated(bf16* dst0, bf16* dst1,
                                                const float (&c)[D / 2],
                                                const float* cos_t,
                                                const float* sin_t, int pos0,
                                                int pos1, int c0) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const size_t o0 = size_t(pos0) * D + 8 * n + c0;
    const size_t o1 = size_t(pos1) * D + 8 * n + c0;
    *reinterpret_cast<uint32_t*>(dst0 + 8 * n) =
        unrotate_pair(c[4 * n], c[4 * n + 1], cos_t + o0, sin_t + o0);
    *reinterpret_cast<uint32_t*>(dst1 + 8 * n) =
        unrotate_pair(c[4 * n + 2], c[4 * n + 3], cos_t + o1, sin_t + o1);
  }
}

// ---- pre-pass ---------------------------------------------------------------

// One thread a 16-byte chunk (8 lanes) of a (row, head): qr, kr rotated by
// load_rotate8, delta's chunk summed in lane order and the D / 8 chunks of
// a head added by a shuffle tree.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
    slab_rope_attn_bwd_prep(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            const bf16* __restrict__ out,
                            const bf16* __restrict__ dout,
                            bf16* __restrict__ qr, bf16* __restrict__ kr,
                            float* __restrict__ delta, int T, int H,
                            size_t chunks) {
  constexpr int CH = D / 8;   // threads of a (row, head), within one warp
  const size_t idx = size_t(blockIdx.x) * PREP_THREADS + threadIdx.x;
  if (idx >= chunks) return;  // chunks % 32 == 0: whole warps return
  const int E = H * D;
  const size_t off = idx * 8;
  const size_t row = off / E;                 // b * T + t
  const int col = int(off % E), c = col % D, h = col / D;
  const int pos = int(row % T);
  const float* cr = cos_t + size_t(pos) * D + c;
  const float* sr = sin_t + size_t(pos) * D + c;
  *reinterpret_cast<uint4*>(qr + off) = load_rotate8(q + off, cr, sr);
  *reinterpret_cast<uint4*>(kr + off) = load_rotate8(k + off, cr, sr);
  const uint4 ro = *reinterpret_cast<const uint4*>(out + off);
  const uint4 rd = *reinterpret_cast<const uint4*>(dout + off);
  const bf16* o8 = reinterpret_cast<const bf16*>(&ro);
  const bf16* d8 = reinterpret_cast<const bf16*>(&rd);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(o8[i]),
                                   __bfloat162float(d8[i])));
#pragma unroll
  for (int o = CH / 2; o; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (c == 0) {
    const size_t b = row / T;
    delta[(b * H + h) * T + pos] = acc;
  }
}

// ---- dq pass ------------------------------------------------------------------

// NWG consumer warpgroups of 64 query rows, key tiles of BN in a ring of
// STAGES; MASKED compiles the per-element slab mask.
template <int D_, int NWG_, int BN_, int CTAS_, bool MASKED_>
struct DqPass : Roles<NWG_> {
  static constexpr int D = D_, NWG = NWG_, BN = BN_, CTAS = CTAS_;
  static constexpr bool MASKED = MASKED_;
  static constexpr int BM = 64 * NWG, STAGES = 4;
  static_assert(128 % BN == 0, "T % 128 == 0 must leave no partial tile");
  static constexpr int ROWS = BM * D * 2, TILE = BN * D * 2;
  static constexpr int OFF_DO = (ROWS + 1023) / 1024 * 1024;
  static constexpr int OFF_K = 2 * OFF_DO;
  static constexpr int OFF_V = OFF_K + STAGES * TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * TILE;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// One CTA per (BM query rows, head, batch row): blockIdx.x = b * H + h,
// blockIdx.y counts row blocks from the last (the heaviest) down.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    slab_rope_attn_bwd_dq(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t,
                          bf16* __restrict__ dq, int T, int H, int P,
                          float scale) {
  constexpr int D = C::D, BN = C::BN, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;
  // the CTA's furthest key: the end of its last row's slab
  const int nk = (key_end(min(q0 + C::BM, T) - 1, T, P) + BN - 1) / BN;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == C::NWG) {  // producer
    if (tid == 128 * C::NWG) {
      mbar_expect_tx(bar_q, 2 * C::ROWS);
      tma_load(smem, &tq, bar_q, h * D, q0, b);
      tma_load(smem + C::OFF_DO, &tdo, bar_q, h * D, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % ST;
        mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::TILE);
        tma_load(smem + C::OFF_K + s * C::TILE, &tk, &full[s], h * D,
                 j * BN, b);
        tma_load(smem + C::OFF_V + s * C::TILE, &tv, &full[s], h * D,
                 j * BN, b);
      }
    }
  } else {  // consumers
    const int cw = wg, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int E = H * D;
    const size_t lbase = (size_t(b) * H + h) * T;
    const int first = q0 + cw * 64;        // the warpgroup's first row
    const bool rows_in = first < T;        // T % 64 == 0: all or none
    const int nkw =
        rows_in ? (key_end(first + 63, T, P) + BN - 1) / BN : 0;
    const int row0 = first + warp * 16 + g, row1 = row0 + 8;
    const float ls0 = rows_in ? lse[lbase + row0] * kLog2e : 0.f;
    const float ls1 = rows_in ? lse[lbase + row1] * kLog2e : 0.f;
    const float dl0 = rows_in ? delta[lbase + row0] : 0.f;
    const float dl1 = rows_in ? delta[lbase + row1] : 0.f;
    // keys from here on lie past the first row's slab (masked instance)
    const int mask_from = (first / P + 1) * P;
    const int slab0 = slab_of<kSlab>(nullptr, row0, P);
    const int slab1 = slab_of<kSlab>(nullptr, row1, P);
    const float c = scale * kLog2e;
    const uint32_t q_addr = smem_u32(smem) + cw * 64 * 2 * D;
    const uint32_t do_addr = smem_u32(smem + C::OFF_DO) + cw * 64 * 2 * D;
    const uint32_t k_base = smem_u32(smem + C::OFF_K);
    const uint32_t v_base = smem_u32(smem + C::OFF_V);
    float s[BN / 2], dp[BN / 2], acc[D / 2];
    uint32_t ds[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // s <- ds = (p * (dp - delta)) * scale, p = 2^(s*c - lse2), in f32,
    // for key tile j
    auto grad = [&](int j) {
      const bool need = C::MASKED && (j + 1) * BN > mask_from;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i & 2) == 0;
        float p = ex2(fmaf(s[i], c, -(lo ? ls0 : ls1)));
        if (need) {
          const int key = j * BN + 8 * (i / 4) + 2 * t + (i & 1);
          if (slab_of<kSlab>(nullptr, key, P) > (lo ? slab0 : slab1)) p = 0.f;
        }
        s[i] = (p * (dp[i] - (lo ? dl0 : dl1))) * scale;
      }
    };

    mbar_wait(bar_q, 0);
    if (nkw > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      mma_rows<D, BN>(s, q_addr, k_base);
      mma_rows<D, BN>(dp, do_addr, v_base);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grad(0);
      to_a<BN>(ds, s);
      for (int j = 1; j < nkw; ++j) {
        const int sj = j % ST, sp = (j - 1) % ST;
        mbar_wait(&full[sj], (j / ST) & 1);
        wgmma_fence();
        mma_rows<D, BN>(s, q_addr, k_base + sj * C::TILE);
        mma_rows<D, BN>(dp, do_addr, v_base + sj * C::TILE);
        wgmma_commit();
        mma_acc<D, BN>(acc, ds, k_base + sp * C::TILE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        grad(j);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
        if (lane == 0) mbar_arrive(&empty[sp]);
        to_a<BN>(ds, s);
      }
      const int sl = (nkw - 1) % ST;
      wgmma_fence();
      mma_acc<D, BN>(acc, ds, k_base + sl * C::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(&empty[sl]);
    }
    // the tiles past this warpgroup's last slab: released, or the ring
    // would stall the producer for the warpgroups that see them
    for (int j = nkw; j < nk; ++j) pass_tile<ST>(full, empty, j, lane);

    if (rows_in) {
      bf16* dq0 = dq + (size_t(b) * T + row0) * E + h * D + 2 * t;
      store_unrotated<D>(dq0, dq0 + 8 * size_t(E), acc, cos_t, sin_t, row0,
                         row1, 2 * t);
    }
  }
}

// ---- dk/dv pass ---------------------------------------------------------------

// NWG consumer warpgroups of 64 keys, query tiles of BN in a ring of
// STAGES; MASKED compiles the per-element slab mask.
template <int D_, int NWG_, int BN_, int CTAS_, bool MASKED_>
struct DkvPass : Roles<NWG_> {
  static constexpr int D = D_, NWG = NWG_, BN = BN_, CTAS = CTAS_;
  static constexpr bool MASKED = MASKED_;
  static constexpr int BM = 64 * NWG, STAGES = 4;
  static_assert(128 % BN == 0, "T % 128 == 0 must leave no partial tile");
  static constexpr int ROWS = BM * D * 2, TILE = BN * D * 2, VEC = BN * 4;
  static constexpr int OFF_V = (ROWS + 1023) / 1024 * 1024;
  static constexpr int OFF_Q = 2 * OFF_V;
  static constexpr int OFF_DO = OFF_Q + STAGES * TILE;
  static constexpr int OFF_L = OFF_DO + STAGES * TILE;
  static constexpr int OFF_DL = OFF_L + STAGES * VEC;
  static constexpr int OFF_BAR = OFF_DL + STAGES * VEC;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// One CTA per (BM keys, head, batch row): blockIdx.x = b * H + h,
// blockIdx.y the key block, the first (the heaviest) first.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    slab_rope_attn_bwd_dkv(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ cos_t,
                           const float* __restrict__ sin_t,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int T, int H, int P, float scale) {
  constexpr int D = C::D, BN = C::BN, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const float* s_lse = reinterpret_cast<const float*>(smem + C::OFF_L);
  const float* s_dl = reinterpret_cast<const float*>(smem + C::OFF_DL);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int j0 = blockIdx.y * C::BM;
  const int nq = T / BN;
  // the first query tile that sees the CTA's first key
  const int i0 = (j0 / P) * P / BN;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == C::NWG) {  // producer
    if (tid == 128 * C::NWG) {
      const size_t lbase = (size_t(b) * H + h) * T;
      mbar_expect_tx(bar_kv, 2 * C::ROWS);
      tma_load(smem, &tk, bar_kv, h * D, j0, b);
      tma_load(smem + C::OFF_V, &tv, bar_kv, h * D, j0, b);
      for (int i = i0; i < nq; ++i) {
        const int n = i - i0, s = n % ST;
        mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::TILE + 2 * C::VEC);
        tma_load(smem + C::OFF_Q + s * C::TILE, &tq, &full[s], h * D,
                 i * BN, b);
        tma_load(smem + C::OFF_DO + s * C::TILE, &tdo, &full[s], h * D,
                 i * BN, b);
        bulk_load(smem + C::OFF_L + s * C::VEC, lse + lbase + i * BN, C::VEC,
                  &full[s]);
        bulk_load(smem + C::OFF_DL + s * C::VEC, delta + lbase + i * BN,
                  C::VEC, &full[s]);
      }
    }
  } else {  // consumers
    const int cw = wg, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int first = j0 + cw * 64;        // the warpgroup's first key
    const bool keys_in = first < T;        // T % 64 == 0: all or none
    // its first query tile (the first row that sees its first key), and
    // the rows below which some of its keys are masked
    const int iw = keys_in ? (first / P) * P / BN : nq;
    const int mask_below = ((first + 63) / P) * P;
    const int key0 = first + warp * 16 + g, key1 = key0 + 8;
    const int kslab0 = slab_of<kSlab>(nullptr, key0, P);
    const int kslab1 = slab_of<kSlab>(nullptr, key1, P);
    const float c = scale * kLog2e;
    const uint32_t k_addr = smem_u32(smem) + cw * 64 * 2 * D;
    const uint32_t v_addr = smem_u32(smem + C::OFF_V) + cw * 64 * 2 * D;
    const uint32_t q_base = smem_u32(smem + C::OFF_Q);
    const uint32_t do_base = smem_u32(smem + C::OFF_DO);
    float st[BN / 2], dpt[BN / 2], dka[D / 2], dva[D / 2];
    uint32_t pa[BN / 16][4], dsa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    // st <- p^T, dpt <- ds^T, in f32, for query tile i in stage s
    auto grad = [&](int i, int s) {
      const bool need = C::MASKED && i * BN < mask_below;
      const float* lq = s_lse + s * BN + 2 * t;
      const float* dlq = s_dl + s * BN + 2 * t;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * jj);
        const float2 d2 = *reinterpret_cast<const float2*>(dlq + 8 * jj);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ls = (e ? l2.y : l2.x) * kLog2e, dl = e ? d2.y : d2.x;
          const int qslab =
              need ? slab_of<kSlab>(nullptr, i * BN + 8 * jj + 2 * t + e, P)
                   : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * jj + 2 * r + e;
            float p = ex2(fmaf(st[x], c, -ls));
            if (need && qslab < (r ? kslab1 : kslab0)) p = 0.f;
            st[x] = p;
            dpt[x] = (p * (dpt[x] - dl)) * scale;
          }
        }
      }
    };

    mbar_wait(bar_kv, 0);
    // the tiles before this warpgroup's first visible row: released
    for (int i = i0; i < min(iw, nq); ++i)
      pass_tile<ST>(full, empty, i - i0, lane);
    for (int i = iw; i < nq; ++i) {
      const int n = i - i0, si = n % ST;
      mbar_wait(&full[si], (n / ST) & 1);
      wgmma_fence();
      mma_rows<D, BN>(st, k_addr, q_base + si * C::TILE);
      mma_rows<D, BN>(dpt, v_addr, do_base + si * C::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grad(i, si);
      to_a<BN>(pa, st);
      to_a<BN>(dsa, dpt);
      wgmma_fence();
      mma_acc<D, BN>(dva, pa, do_base + si * C::TILE);
      mma_acc<D, BN>(dka, dsa, q_base + si * C::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(&empty[si]);
    }

    if (keys_in) {
      const int E = H * D;
      const size_t off = (size_t(b) * T + key0) * E + h * D + 2 * t;
      store_rows<D>(dv + off, dv + off + 8 * size_t(E), dva, 1.f, 1.f);
      store_unrotated<D>(dk + off, dk + off + 8 * size_t(E), dka, cos_t,
                         sin_t, key0, key1, 2 * t);
    }
  }
}

// ---- host ---------------------------------------------------------------------

// The production instances: head_dim D, consumer warpgroups, tile, CTAs
// an SM, and the mask (settled on an H100; PERF.md).
template <int D, bool MASKED>
using DqOf = DqPass<D, D == 32 ? 3 : 2, 64, 1, MASKED>;
template <int D, bool MASKED>
using DkvOf = DkvPass<D, D == 32 ? 3 : 2, 64, 1, MASKED>;

template <int D>
int prep(const void* q, const void* k, const void* cos_t, const void* sin_t,
         const void* out, const void* dout, void* qr, void* kr, void* delta,
         int B, int T, int H, cudaStream_t st) {
  const size_t chunks = size_t(B) * T * H * (D / 8);
  const unsigned blocks = unsigned((chunks + PREP_THREADS - 1) / PREP_THREADS);
  slab_rope_attn_bwd_prep<D><<<blocks, PREP_THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<bf16*>(qr), static_cast<bf16*>(kr),
      static_cast<float*>(delta), T, H, chunks);
  return int(cudaGetLastError());
}

// The dq pass, then the dk/dv pass, on the pre-pass's qr, kr and delta.
template <class Q, class R>
int passes(const void* qr, const void* kr, const void* v, const void* cos_t,
           const void* sin_t, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, int B, int T,
           int H, int P, float scale, cudaStream_t st) {
  constexpr int D = Q::D;
  CUtensorMap tq, tk, tv, tdo;
  const int E = H * D;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* ct = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  if (!tile_map(&tq, qr, B, T, E, D, Q::BM) ||
      !tile_map(&tdo, dout, B, T, E, D, Q::BM) ||
      !tile_map(&tk, kr, B, T, E, D, Q::BN) ||
      !tile_map(&tv, v, B, T, E, D, Q::BN))
    return int(cudaErrorInvalidValue);
  auto dq_kernel = slab_rope_attn_bwd_dq<Q>;
  cudaError_t err = prepare<Q>(dq_kernel);
  if (err != cudaSuccess) return int(err);
  dq_kernel<<<dim3(B * H, grid_x(T, Q::BM)), Q::THREADS, Q::SMEM, st>>>(
      tq, tk, tv, tdo, l, dl, ct, s, static_cast<bf16*>(dq), T, H, P, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  if (!tile_map(&tq, qr, B, T, E, D, R::BN) ||
      !tile_map(&tdo, dout, B, T, E, D, R::BN) ||
      !tile_map(&tk, kr, B, T, E, D, R::BM) ||
      !tile_map(&tv, v, B, T, E, D, R::BM))
    return int(cudaErrorInvalidValue);
  auto dkv_kernel = slab_rope_attn_bwd_dkv<R>;
  err = prepare<R>(dkv_kernel);
  if (err != cudaSuccess) return int(err);
  dkv_kernel<<<dim3(B * H, grid_x(T, R::BM)), R::THREADS, R::SMEM, st>>>(
      tq, tk, tv, tdo, l, dl, ct, s, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, H, P, scale);
  return int(cudaGetLastError());
}

// P a multiple of the key tile and of the warpgroup's 64 rows: no tile the
// loops visit crosses a slab boundary.
bool unmasked(int P) { return P % 64 == 0; }

template <int D>
int backward(const void* q, const void* k, const void* v, const void* cos_t,
             const void* sin_t, const void* out, const void* dout,
             const void* lse, void* qr, void* kr, void* delta, void* dq,
             void* dk, void* dv, int B, int T, int H, int P, float scale,
             cudaStream_t st) {
  int rc = prep<D>(q, k, cos_t, sin_t, out, dout, qr, kr, delta, B, T, H, st);
  if (rc != 0) return rc;
  auto run = [&](auto dq_cfg, auto dkv_cfg) {
    return passes<decltype(dq_cfg), decltype(dkv_cfg)>(
        qr, kr, v, cos_t, sin_t, dout, lse, delta, dq, dk, dv, B, T, H, P,
        scale, st);
  };
  if (unmasked(P)) return run(DqOf<D, false>{}, DkvOf<D, false>{});
  return run(DqOf<D, true>{}, DkvOf<D, true>{});
}

template <int D, bool MASKED>
int pass_occupancy(int pass, int* regs, int* ctas) {
  using Q = DqOf<D, MASKED>;
  using R = DkvOf<D, MASKED>;
  if (pass == 0)
    return kernel_occupancy(slab_rope_attn_bwd_prep<D>, PREP_THREADS, 0, regs,
                            ctas);
  if (pass == 1) return occupancy<Q>(slab_rope_attn_bwd_dq<Q>, regs, ctas);
  if (pass == 2) return occupancy<R>(slab_rope_attn_bwd_dkv<R>, regs, ctas);
  return int(cudaErrorInvalidValue);
}

bool shape_ok(int T, int D) { return T % 128 == 0 && (D == 32 || D == 64); }

}  // namespace

// The pre-pass alone: qr, kr ([B, T, E] bf16) and delta ([B, H, T] f32)
// from q, k, out and dout. Shapes are checked by the Python wrapper
// (ops/cuda/slab_attention.py).
extern "C" int fk_slab_rope_attn_bwd_prep(
    const void* q, const void* k, const void* cos_t, const void* sin_t,
    const void* out, const void* dout, void* qr, void* kr, void* delta, int B,
    int T, int H, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D)) return int(cudaErrorInvalidValue);
  if (D == 32)
    return prep<32>(q, k, cos_t, sin_t, out, dout, qr, kr, delta, B, T, H, st);
  return prep<64>(q, k, cos_t, sin_t, out, dout, qr, kr, delta, B, T, H, st);
}

// K4: the pre-pass, the dq pass and the dk/dv pass on ``stream``, into the
// caller's qr, kr and delta workspaces and dq, dk, dv. Shapes are checked
// by the Python wrapper: T % 128 == 0, D in {32, 64}, contiguous bf16
// [B, T, E] tensors, f32 [T, D] tables, f32 [B, H, T] lse and delta.
extern "C" int fk_slab_rope_attention_bwd(
    const void* q, const void* k, const void* v, const void* cos_t,
    const void* sin_t, const void* out, const void* dout, const void* lse,
    void* qr, void* kr, void* delta, void* dq, void* dk, void* dv, int B,
    int T, int H, int D, int P, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D) || P <= 0) return int(cudaErrorInvalidValue);
  if (D == 32)
    return backward<32>(q, k, v, cos_t, sin_t, out, dout, lse, qr, kr, delta,
                        dq, dk, dv, B, T, H, P, scale, st);
  return backward<64>(q, k, v, cos_t, sin_t, out, dout, lse, qr, kr, delta,
                      dq, dk, dv, B, T, H, P, scale, st);
}

// Registers a thread and resident CTAs an SM of one K4 pass (0 pre-pass,
// 1 dq, 2 dk/dv) at head_dim D, in the instance tokens-per-slab P takes.
extern "C" int fk_slab_rope_attention_bwd_occupancy(int pass, int D, int P,
                                                    int* regs, int* ctas) {
  if ((D != 32 && D != 64) || P <= 0) return int(cudaErrorInvalidValue);
  if (D == 32)
    return unmasked(P) ? pass_occupancy<32, false>(pass, regs, ctas)
                       : pass_occupancy<32, true>(pass, regs, ctas);
  return unmasked(P) ? pass_occupancy<64, false>(pass, regs, ctas)
                     : pass_occupancy<64, true>(pass, regs, ctas);
}
