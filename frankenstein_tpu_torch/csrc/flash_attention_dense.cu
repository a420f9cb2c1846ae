// K7 dense, K6 and K7 slab: the MAE decoder's unmasked flash attention,
// the MAE encoder's attention over the tokens it keeps, and slab-causal
// attention without RoPE, forward and both backward passes, for Hopper
// (sm_90a): TMA rings, wgmma, warp specialisation and exp2. One kernel
// family: the mask mode (flash_mask.cuh) is a compile-time property of
// each pass's shape, kDense for K7 dense, kPositions for K6 and kSlab for
// K7 slab, and every positions or slab branch sits behind if constexpr, so
// the dense instances compile as they did. The C entry points at the end
// dispatch all three modes.
//
// Replaces, in frankenstein_tpu/ops/pallas/block_attention.py:
//   K7 forward  dense_flash_attention :1278 -> _slab_attention :746 -> _fwd
//               :202 (call :260) or _fwd_packed :1017 -> :994 -> :945 (call
//               :976), with the mask off;
//   K7 backward :762 -> _bwd_packed :658 (calls :685, :721) or _bwd :396
//               (calls :436, :484): the _bwd_dq / _bwd_dkv split, kept;
//   K6 forward  _fwd :202 with ``pos`` (kernel _fwd_tri_kernel :156, mask
//               _pos_mask :147, call :260), and K6 backward _bwd :396 with
//               ``pos`` (kernels _bwd_dq_tri_kernel :284, _bwd_dkv_tri_kernel
//               :346, calls :436, :484), both reached from
//               gathered_slab_attention :1242 -> _gathered_attention
//               :1191-1215;
//   K7 slab     the same kernels with causal=True (slab-causal, no RoPE),
//               via slab_causal_attention :1268 and
//               slab_causal_attention_folded :1169.
// Contract (unchanged from the mma.sync kernels):
//   q, k, v, dout  [B, T, E] bf16, head h = columns [h*D, (h+1)*D), D in
//                  {32, 64}, T % 128 == 0
//   sid            [B, T] int32 slab ids, K6 only, in any order: key j is
//                  visible to query i iff sid[j] <= sid[i]
//   P              K7 slab's tokens a slab, any P > 0: key j is visible to
//                  query i iff j / P <= i / P
//   out            [B, T, E] bf16; lse [B, H, T] f32, natural-log units
//   delta          [B, H, T] f32 workspace: rowsum(f32(out) * f32(dout)),
//                  written by the dq pass, read by the dk/dv pass
//   dq, dk, dv     [B, T, E] bf16
// Forward: scale 1/sqrt(D); scores and online softmax in f32, masked scores
// at finfo(f32).min, p rounded to bf16 before PV, l sums the unrounded
// exps. Backward: p = exp(s - lse) (0 where masked), ds = bf16(p * (dp -
// delta) * scale), dv = bf16(p)^T dout, dq = ds k, dk = ds^T q, each
// rounded once to bf16. No atomics and a fixed order of every sum, so two
// backward launches are bitwise equal.
//
// The three floors at K7's shape (B=2, T=6144, H=8, D=32; B=32 x 16),
// on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, ex2 at 16 a clock an SM):
//   products  forward 4*D ops a visible pair: 0.078 ms; backward 10*D
//             (the two-pass design issues 14*D): 0.195 ms (0.27 issued);
//   exps      one ex2 a pair a pass: 6.04e8 exps at 132 * 16 * 1.83 GHz =
//             3.87e12/s is 0.156 ms forward, 0.31 ms backward; the floor
//             that binds at D = 32;
//   bytes     q, k, v, out once: under 0.02 ms; K/V tiles are re-read by
//             every 128-row CTA of a head, from L2.
// K6 at the MAE encoder's shape (1536 of 6144 tokens kept, P = 256: about
// 2.5e6 visible pairs at B=2, 3.9e7 at B=32) has the same floors scaled by
// its pairs, 0.005 / 0.081 ms of exps forward; at B=2 its grid is under one
// wave and the CTA with the most visible tiles sets the time.
// What the design does about them:
//   * warp specialisation: in every CTA one producer warp keeps a ring of
//     TMA tile loads in flight on mbarriers (no register or instruction
//     cost for the copies, no transposed 2-byte shared stores), after the
//     consumer warpgroups of 64 rows that run wgmma and the softmax;
//   * every product is a wgmma m64nNk16: Q K^T and the like from shared
//     memory as TMA stored them (K-major, 64-byte swizzle at D = 32,
//     128-byte at D = 64); P V, dS K, P^T dO and dS^T Q take A from
//     registers (the f32 accumulator rounded to bf16 in place) and B as
//     stored ([rows, D], MN-major) through wgmma's transpose-B bit;
//   * exps are ex2.approx of one FFMA, s * (scale * log2 e) - m, with the
//     running max m (forward) or lse (backward) kept in log2 units; the
//     forward writes lse = (m + log2 l) * ln 2 in natural units; the
//     rescale exp is skipped where a row's max did not move;
//   * the forward and the dq pass issue tile j's score products together
//     with tile j-1's accumulating product and run tile j's exps while the
//     latter is in flight;
//   * the exp floor needs warps to issue exps while others wait on wgmma,
//     and registers bound the warps: the shapes (FwdOf, DqOf, DkvOf) were
//     settled on an H100 against their neighbours (PERF.md, section 6). At
//     D = 32 the forward runs two CTAs an SM of two consumer warpgroups and
//     64-key tiles (90 registers), the dq pass three consumer warpgroups
//     (192 rows) of 64-key tiles, the dk/dv pass three of 64 keys each
//     without the overlap, whose second set of live tiles would not fit
//     in 128 registers; at D = 64 one CTA of two.
// K6's staircase, data-dependent and exact for any order of the ids:
//   * each CTA first takes the least and greatest slab id of every column
//     tile (keys in the forward and the dq pass, queries in the dk/dv
//     pass), of its own rows and of each warpgroup's from the sid row
//     (flash_mask.cuh: slab_ranges; no extra launch), while the TMA loads
//     of its own rows are in flight; the producer streams only the tiles
//     some row of the CTA sees, and the tile's ids ride the ring beside it;
//   * each consumer warpgroup walks that same list: a tile none of its
//     rows sees is released unseen (pass_tile: the ring would stall the
//     producer otherwise); a tile every pair of which is visible runs the
//     dense code; only the rest compare ids per element;
//   * under an unsorted order a row may meet a wholly invisible tile
//     before any visible key: online_softmax<N, true> keeps its l and o at
//     0 there (hopper_blocks.cuh), so masking stays at finfo(f32).min;
//   * a warpgroup that skips a tile first finishes its pending P V (or dS
//     K), so it never holds a stage while it waits for a later one; the
//     accumulating product of a walk's first tile runs on zeros;
//   * the heaviest row block goes first: the grid is (batch row x head,
//     row block), the forward and dq pass from the last row block (under
//     sorted ids it sees every key), the dk/dv pass from the first key
//     block (seen by every query);
//   * a K6 CTA walks a few tiles (about 13 of 24 at the MAE's shape), so
//     its prologue and tail weigh: the forward keeps FwdOf's shape, the
//     dq and dk/dv passes run one consumer warpgroup a CTA, three CTAs an
//     SM at D = 32, so that other CTAs' tiles hide one CTA's start and
//     end (held against K7 dense's shapes on an H100, PERF.md). An
//     overlapped dk/dv walk (tile i's scores issued with tile i-1's dV /
//     dK products) needed 206 registers, two CTAs an SM, and read slower.
// K7 slab's staircase is arithmetic (hopper_blocks.cuh: key_end), so it
// needs no prologue and no ids on the ring; it walks K1's and K4's slab
// schedule on K7 dense's shapes (Slab*Of):
//   * the grid is K6's, heaviest block first: the forward and the dq pass
//     from the last row block (its keys run to the end of its last row's
//     slab), the dk/dv pass from the first key block (seen by every query);
//   * the producer streams the keys up to the end of the CTA's last row's
//     slab (the queries from its first key's slab start); each warpgroup
//     walks those up to its own last row's slab end (from its own first
//     key's slab start), as the dense code does, and waits for and
//     releases the rest unseen (pass_tile), so the ring never stalls;
//   * where P % 64 == 0 and P % BN == 0 (the flagship's P = 256) every
//     tile a warpgroup walks is wholly visible: the unmasked instance has
//     no mask code. Any other P takes the MASKED instance, which compares
//     slab_of<kSlab> per element on the tiles that cross the warpgroup's
//     slab boundary only: invisible scores at finfo(f32).min in the
//     forward, p and ds at 0 in the backward. Every row sees key 0, so no
//     row meets a wholly masked first tile and the plain online softmax
//     holds.
// The blocks (barriers, TMA, wgmma descriptors and products, the re-pack,
// the online softmax, tile maps) live in hopper_blocks.cuh, shared with K4,
// K1, K10 and K9.

#include "flash_host.cuh"
#include "flash_mask.cuh"
#include "hopper_blocks.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fk;

// ---- forward ----------------------------------------------------------------

// NWG consumer warpgroups of 64 query rows, key tiles of BN in a ring of
// STAGES.
template <int D_, int NWG_, int BN_, int CTAS_>
struct Fwd : Roles<NWG_> {
  static constexpr int D = D_, NWG = NWG_, BN = BN_, CTAS = CTAS_;
  static constexpr int MODE = kDense;
  static constexpr int BM = 64 * NWG, STAGES = 4;
  static_assert(128 % BM == 0 && 128 % BN == 0,
                "T % 128 == 0 must leave no partial row or key tile");
  static constexpr int Q_BYTES = BM * D * 2, TILE = BN * D * 2;
  static constexpr int OFF_K = (Q_BYTES + 1023) / 1024 * 1024;
  static constexpr int OFF_V = OFF_K + STAGES * TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * TILE;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// K6's forward: Fwd's shape with each stage's key slab ids (SIDS bytes)
// after the V tiles, and after the barriers the slab ranges of every key
// tile, of the CTA's rows and of each warpgroup's (8 bytes each, added at
// launch).
template <int D_, int NWG_, int BN_, int CTAS_>
struct FwdPos : Fwd<D_, NWG_, BN_, CTAS_> {
  using Base = Fwd<D_, NWG_, BN_, CTAS_>;
  static constexpr int MODE = kPositions, SIDS = BN_ * 4;
  static constexpr int OFF_SID = Base::OFF_V + Base::STAGES * Base::TILE;
  static constexpr int OFF_BAR = OFF_SID + Base::STAGES * SIDS;
  static constexpr int OFF_RANGE = OFF_BAR + 8 * (1 + 3 * Base::STAGES);
  static constexpr int SMEM = OFF_RANGE + 1024;
};

// K7 slab's passes: the dense shapes of a pass, mode slab, and MASKED for
// a P whose slab boundaries fall inside the 64-row groups or the tiles the
// passes visit (the element compare; none where P % 64 == 0 and P % BN ==
// 0, the flagship's P = 256).
template <class Base, bool MASKED_>
struct Slab : Base {
  static constexpr int MODE = kSlab;
  static constexpr bool MASKED = MASKED_;
};

// One CTA per (BM query rows, head, batch row). Ring of STAGES (K, V)
// tiles of BN keys: full_k / full_v complete when a tile has landed, empty
// when every consumer warp is done with the stage. kPositions: the grid is
// (B * H, row blocks from the last), full_k alone completes a stage (K, V
// and the key ids), and only the key tiles some row of the CTA sees are
// streamed. kSlab: the same grid; the producer streams the keys up to the
// end of the CTA's last row's slab, each warpgroup walks those up to its
// own last row's and releases the rest unseen.
template <class C>
__device__ __forceinline__ void fwd_pass(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const int* __restrict__ sid,
                                         bf16* __restrict__ out,
                                         float* __restrict__ lse, int T,
                                         int H, int P, float scale) {
  constexpr int D = C::D, BN = C::BN, ST = C::STAGES;
  constexpr bool POS = C::MODE == kPositions;
  constexpr bool SLAB = C::MODE == kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;
  const int tid = threadIdx.x;
  int q0, h, b;
  if constexpr (POS || SLAB) {
    h = blockIdx.x % H;
    b = blockIdx.x / H;
    q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;
  } else {
    q0 = blockIdx.x * C::BM;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  int nk = T / BN;
  if constexpr (SLAB)   // the CTA's furthest key: its last row's slab end
    nk = (key_end(min(q0 + C::BM, T) - 1, T, P) + BN - 1) / BN;
  auto init_barriers = [&]() {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  };
  // kPositions: the producer's thread starts the Q load, then the CTA
  // takes the slab ranges of the key tiles, its rows (rng[nk]) and each
  // warpgroup's rows (rng[nk + 1 + cw])
  int2* rng = nullptr;
  const int* sid_b = nullptr;
  if constexpr (POS) {
    if (tid == 128 * C::NWG) {
      init_barriers();
      mbar_expect_tx(bar_q, C::Q_BYTES);
      tma_load(smem, &tq, bar_q, h * D, q0, b);
    }
    rng = reinterpret_cast<int2*>(smem + C::OFF_RANGE);
    sid_b = sid + size_t(b) * T;
    slab_ranges<BN, C::NWG>(rng, sid_b, nk, q0, min(C::BM, T - q0));
  } else {
    if (tid == 0) init_barriers();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == C::NWG) {  // producer
    if (tid == 128 * C::NWG) {
      if constexpr (POS) {
        const int cta_hi = rng[nk].y;
        for (int j = 0, n = 0; j < nk; ++j) {
          if (rng[j].x > cta_hi) continue;   // no row of the CTA sees it
          const int s = n % ST;
          mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
          mbar_expect_tx(&full_k[s], 2 * C::TILE + C::SIDS);
          tma_load(smem + C::OFF_K + s * C::TILE, &tk, &full_k[s], h * D,
                   j * BN, b);
          tma_load(smem + C::OFF_V + s * C::TILE, &tv, &full_k[s], h * D,
                   j * BN, b);
          bulk_load(smem + C::OFF_SID + s * C::SIDS, sid_b + j * BN, C::SIDS,
                    &full_k[s]);
          ++n;
        }
      } else {
        mbar_expect_tx(bar_q, C::Q_BYTES);
        tma_load(smem, &tq, bar_q, h * D, q0, b);
        for (int j = 0; j < nk; ++j) {
          const int s = j % ST;
          mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
          mbar_expect_tx(&full_k[s], C::TILE);
          tma_load(smem + C::OFF_K + s * C::TILE, &tk, &full_k[s], h * D,
                   j * BN, b);
          mbar_expect_tx(&full_v[s], C::TILE);
          tma_load(smem + C::OFF_V + s * C::TILE, &tv, &full_v[s], h * D,
                   j * BN, b);
        }
      }
    }
  } else {  // consumers
    const int cw = wg, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float c = scale * kLog2e;
    const uint32_t q_addr = smem_u32(smem) + cw * 64 * 2 * D;
    const uint32_t k_base = smem_u32(smem + C::OFF_K);
    const uint32_t v_base = smem_u32(smem + C::OFF_V);
    float s[BN / 2], o[D / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;

    mbar_wait(bar_q, 0);
    if constexpr (POS) {
      const int first = q0 + cw * 64;
      const bool rows_in = first < T;        // T % 64 == 0: all or none
      // the warpgroup's least / greatest row id (none: every tile skipped)
      const int2 wr = rng[nk + 1 + cw];
      const int r0 = first + warp * 16 + g;   // this thread's rows r0, r0 + 8
      const int sl0 = rows_in ? sid_b[r0] : 0;
      const int sl1 = rows_in ? sid_b[r0 + 8] : 0;
      const int cta_hi = rng[nk].y;
      // the scores of the keys in stage st that rows r0 / r0 + 8 do not see
      auto mask = [&](int st) {
        const int* ks =
            reinterpret_cast<const int*>(smem + C::OFF_SID + st * C::SIDS);
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const int2 k2 = *reinterpret_cast<const int2*>(ks + 8 * jj + 2 * t);
          if (k2.x > sl0) s[4 * jj] = kMaskedScore;
          if (k2.y > sl0) s[4 * jj + 1] = kMaskedScore;
          if (k2.x > sl1) s[4 * jj + 2] = kMaskedScore;
          if (k2.y > sl1) s[4 * jj + 3] = kMaskedScore;
        }
      };
      auto zero_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) p[kk][r] = 0u;
      };
      // the pending P V of stage sp, then its release
      auto finish = [&](int sp) {
        wgmma_fence();
        mma_acc<D, BN>(o, p, v_base + sp * C::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&empty[sp]);
      };
      zero_p();
      int sp = -1;   // the stage whose P V is pending, -1 none (p is 0)
      for (int j = 0, n = 0; j < nk; ++j) {
        const int2 kr = rng[j];
        if (kr.x > cta_hi) continue;       // not streamed
        const int sj = n % ST;
        const uint32_t parity = (n / ST) & 1;
        ++n;
        if (kr.x > wr.y) {                 // none of the rows sees it
          if (sp >= 0) {
            finish(sp);
            sp = -1;
            zero_p();
          }
          mbar_wait(&full_k[sj], parity);
          if (lane == 0) mbar_arrive(&empty[sj]);
          continue;
        }
        // the tile's scores issued with the pending P V (of zeros if none)
        mbar_wait(&full_k[sj], parity);
        wgmma_fence();
        mma_rows<D, BN>(s, q_addr, k_base + sj * C::TILE);
        wgmma_commit();
        mma_acc<D, BN>(o, p, v_base + (sp >= 0 ? sp : sj) * C::TILE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        if (kr.y > wr.x) mask(sj);         // some pair is not visible
        online_softmax<BN, true>(s, c, m0, m1, l0, l1, a0, a1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (sp >= 0 && lane == 0) mbar_arrive(&empty[sp]);
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          o[4 * n8] *= a0;
          o[4 * n8 + 1] *= a0;
          o[4 * n8 + 2] *= a1;
          o[4 * n8 + 3] *= a1;
        }
        to_a<BN>(p, s);
        sp = sj;
      }
      if (sp >= 0) finish(sp);
      if (!rows_in) return;
    } else if constexpr (SLAB) {
      const int first = q0 + cw * 64;        // the warpgroup's first row
      const bool rows_in = first < T;        // T % 64 == 0: all or none
      const int nkw =
          rows_in ? (key_end(first + 63, T, P) + BN - 1) / BN : 0;
      const int r0 = first + warp * 16 + g;  // this thread's rows r0, r0 + 8
      // keys from mask_from on lie past the first row's slab, and from
      // end0 / end1 on past this thread's rows' slabs
      const int mask_from = (first / P + 1) * P;
      const int end0 = key_end(r0, T, P), end1 = key_end(r0 + 8, T, P);
      // the scores of key tile j that rows r0 / r0 + 8 do not see (MASKED;
      // every row sees key 0, so no row meets a wholly masked first tile)
      auto mask = [&](int j) {
        if constexpr (C::MASKED) {
          if ((j + 1) * BN <= mask_from) return;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int key = j * BN + 8 * (i / 4) + 2 * t + (i & 1);
            if (key >= ((i & 2) ? end1 : end0)) s[i] = kMaskedScore;
          }
        }
      };
      if (nkw > 0) {
        mbar_wait(&full_k[0], 0);
        wgmma_fence();
        mma_rows<D, BN>(s, q_addr, k_base);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mask(0);
        online_softmax<BN>(s, c, m0, m1, l0, l1, a0, a1);
        to_a<BN>(p, s);
        for (int j = 1; j < nkw; ++j) {
          const int sj = j % ST, sp = (j - 1) % ST;
          mbar_wait(&full_k[sj], (j / ST) & 1);
          mbar_wait(&full_v[sp], ((j - 1) / ST) & 1);
          wgmma_fence();
          mma_rows<D, BN>(s, q_addr, k_base + sj * C::TILE);
          wgmma_commit();
          mma_acc<D, BN>(o, p, v_base + sp * C::TILE);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
          mask(j);
          online_softmax<BN>(s, c, m0, m1, l0, l1, a0, a1);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(p);
          if (lane == 0) mbar_arrive(&empty[sp]);
#pragma unroll
          for (int n8 = 0; n8 < D / 8; ++n8) {
            o[4 * n8] *= a0;
            o[4 * n8 + 1] *= a0;
            o[4 * n8 + 2] *= a1;
            o[4 * n8 + 3] *= a1;
          }
          to_a<BN>(p, s);
        }
        const int sl = (nkw - 1) % ST;
        mbar_wait(&full_v[sl], ((nkw - 1) / ST) & 1);
        wgmma_fence();
        mma_acc<D, BN>(o, p, v_base + sl * C::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&empty[sl]);
      }
      // the tiles past the warpgroup's last slab: released unseen, or the
      // ring would stall the producer for the warpgroups that see them
      for (int j = nkw; j < nk; ++j) {
        mbar_wait(&full_k[j % ST], (j / ST) & 1);
        mbar_wait(&full_v[j % ST], (j / ST) & 1);
        if (lane == 0) mbar_arrive(&empty[j % ST]);
      }
      if (!rows_in) return;
    } else {
      mbar_wait(&full_k[0], 0);
      wgmma_fence();
      mma_rows<D, BN>(s, q_addr, k_base);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      online_softmax<BN>(s, c, m0, m1, l0, l1, a0, a1);
      to_a<BN>(p, s);
      // Tile j's scores are issued with tile j-1's PV; tile j's softmax runs
      // while that PV is in flight, and rescales o once it has landed.
      for (int j = 1; j < nk; ++j) {
        const int sj = j % ST, sp = (j - 1) % ST;
        mbar_wait(&full_k[sj], (j / ST) & 1);
        mbar_wait(&full_v[sp], ((j - 1) / ST) & 1);
        wgmma_fence();
        mma_rows<D, BN>(s, q_addr, k_base + sj * C::TILE);
        wgmma_commit();
        mma_acc<D, BN>(o, p, v_base + sp * C::TILE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        online_softmax<BN>(s, c, m0, m1, l0, l1, a0, a1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&empty[sp]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n] *= a0;
          o[4 * n + 1] *= a0;
          o[4 * n + 2] *= a1;
          o[4 * n + 3] *= a1;
        }
        to_a<BN>(p, s);
      }
      const int sl = (nk - 1) % ST;
      mbar_wait(&full_v[sl], ((nk - 1) / ST) & 1);
      wgmma_fence();
      mma_acc<D, BN>(o, p, v_base + sl * C::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const int E = H * D;
    const int row0 = q0 + cw * 64 + warp * 16 + g, row1 = row0 + 8;
    bf16* out0 = out + (size_t(b) * T + row0) * E + h * D + 2 * t;
    store_rows<D>(out0, out0 + 8 * size_t(E), o, 1.f / l0, 1.f / l1);
    if (t == 0) {
      float* lrow = lse + (size_t(b) * H + h) * T;
      lrow[row0] = (m0 + log2f(l0)) * kLn2;
      lrow[row1] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_fwd_dense_wgmma(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               bf16* __restrict__ out,
                               float* __restrict__ lse, int T, int H,
                               float scale) {
  fwd_pass<C>(tq, tk, tv, nullptr, out, lse, T, H, 0, scale);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_fwd_positions_wgmma(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const int* __restrict__ sid,
                                   bf16* __restrict__ out,
                                   float* __restrict__ lse, int T, int H,
                                   float scale) {
  fwd_pass<C>(tq, tk, tv, sid, out, lse, T, H, 0, scale);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_fwd_slab_wgmma(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              bf16* __restrict__ out, float* __restrict__ lse,
                              int T, int H, int P, float scale) {
  fwd_pass<C>(tq, tk, tv, nullptr, out, lse, T, H, P, scale);
}

// ---- backward: dq pass ------------------------------------------------------

// NWG consumer warpgroups of 64 query rows, key tiles of BN in a ring of
// STAGES.
template <int D_, int NWG_, int BN_, int CTAS_>
struct Dq : Roles<NWG_> {
  static constexpr int D = D_, NWG = NWG_, BN = BN_, CTAS = CTAS_;
  static constexpr int MODE = kDense;
  static constexpr int BM = 64 * NWG, STAGES = 4;
  static_assert(128 % BN == 0, "T % 128 == 0 must leave no partial tile");
  static constexpr int ROWS = BM * D * 2, TILE = BN * D * 2;
  static constexpr int OFF_DO = (ROWS + 1023) / 1024 * 1024;
  static constexpr int OFF_K = 2 * OFF_DO;
  static constexpr int OFF_V = OFF_K + STAGES * TILE;
  static constexpr int OFF_DELTA = OFF_V + STAGES * TILE;
  static constexpr int OFF_BAR = OFF_DELTA + BM * 4;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// K6's dq pass: Dq's shape with each stage's key slab ids after the V
// tiles, and the slab ranges after the barriers (added at launch).
template <int D_, int NWG_, int BN_, int CTAS_>
struct DqPos : Dq<D_, NWG_, BN_, CTAS_> {
  using Base = Dq<D_, NWG_, BN_, CTAS_>;
  static constexpr int MODE = kPositions, SIDS = BN_ * 4;
  static constexpr int OFF_SID = Base::OFF_V + Base::STAGES * Base::TILE;
  static constexpr int OFF_DELTA = OFF_SID + Base::STAGES * SIDS;
  static constexpr int OFF_BAR = OFF_DELTA + Base::BM * 4;
  static constexpr int OFF_RANGE = OFF_BAR + 8 * (1 + 2 * Base::STAGES);
  static constexpr int SMEM = OFF_RANGE + 1024;
};

// One CTA per (BM query rows, head, batch row), warpgroups as the
// forward's; ring of (K, V) tiles of BN keys. Each consumer first writes
// delta for its 64 rows (two threads a row, f32 products summed in a
// fixed order), then walks the keys: S = Q K^T and dP = dO V^T, then
// ds = bf16(2^(s*c - lse*log2 e) * (dp - delta) * scale) in registers,
// dQ += dS K. Tile j's S and dP are issued with tile j-1's dQ product.
// kPositions: the forward's grid and walk (the key ids ride the ring).
// kSlab: the forward's grid and walk.
template <class C>
__device__ __forceinline__ void dq_pass(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const CUtensorMap& tdo,
                                        const int* __restrict__ sid,
                                        const bf16* __restrict__ out,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        float* __restrict__ delta,
                                        bf16* __restrict__ dq, int T, int H,
                                        int P, float scale) {
  constexpr int D = C::D, BN = C::BN, ST = C::STAGES;
  constexpr bool POS = C::MODE == kPositions;
  constexpr bool SLAB = C::MODE == kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  float* s_delta = reinterpret_cast<float*>(smem + C::OFF_DELTA);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  int q0, h, b;
  if constexpr (POS || SLAB) {
    h = blockIdx.x % H;
    b = blockIdx.x / H;
    q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;
  } else {
    q0 = blockIdx.x * C::BM;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  int nk = T / BN;
  if constexpr (SLAB)   // the CTA's furthest key: its last row's slab end
    nk = (key_end(min(q0 + C::BM, T) - 1, T, P) + BN - 1) / BN;
  auto init_barriers = [&]() {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  };
  auto load_rows = [&]() {   // the CTA's Q and dO rows
    mbar_expect_tx(bar_q, 2 * C::ROWS);
    tma_load(smem, &tq, bar_q, h * D, q0, b);
    tma_load(smem + C::OFF_DO, &tdo, bar_q, h * D, q0, b);
  };
  // kPositions: as the forward's
  int2* rng = nullptr;
  const int* sid_b = nullptr;
  if constexpr (POS) {
    if (tid == 128 * C::NWG) {
      init_barriers();
      load_rows();
    }
    rng = reinterpret_cast<int2*>(smem + C::OFF_RANGE);
    sid_b = sid + size_t(b) * T;
    slab_ranges<BN, C::NWG>(rng, sid_b, nk, q0, min(C::BM, T - q0));
  } else {
    if (tid == 0) init_barriers();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == C::NWG) {  // producer
    if (tid == 128 * C::NWG) {
      if constexpr (POS) {
        const int cta_hi = rng[nk].y;
        for (int j = 0, n = 0; j < nk; ++j) {
          if (rng[j].x > cta_hi) continue;   // no row of the CTA sees it
          const int s = n % ST;
          mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * C::TILE + C::SIDS);
          tma_load(smem + C::OFF_K + s * C::TILE, &tk, &full[s], h * D,
                   j * BN, b);
          tma_load(smem + C::OFF_V + s * C::TILE, &tv, &full[s], h * D,
                   j * BN, b);
          bulk_load(smem + C::OFF_SID + s * C::SIDS, sid_b + j * BN, C::SIDS,
                    &full[s]);
          ++n;
        }
      } else {
        load_rows();
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
    }
  } else {  // consumers
    const int cw = wg, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int E = H * D;
    const size_t lbase = (size_t(b) * H + h) * T + q0;
    {  // delta = rowsum(out * dout) of rows [64 cw, 64 cw + 64)
      const int r = cw * 64 + (tid % 128) / 2, half = tid % 2;
      const size_t off = (size_t(b) * T + q0 + r) * E + h * D + half * (D / 2);
      float acc = 0.f;
#pragma unroll
      for (int cc = 0; cc < D / 2 && q0 + r < T; cc += 8) {
        const uint4 ro = *reinterpret_cast<const uint4*>(out + off + cc);
        const uint4 rd = *reinterpret_cast<const uint4*>(dout + off + cc);
        const bf16* o8 = reinterpret_cast<const bf16*>(&ro);
        const bf16* d8 = reinterpret_cast<const bf16*>(&rd);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(o8[i]),
                                         __bfloat162float(d8[i])));
      }
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
      if (half == 0) {
        s_delta[r] = acc;
        if (q0 + r < T) delta[lbase + r] = acc;
      }
      warpgroup_sync(cw);
    }
    const int rl0 = cw * 64 + warp * 16 + g, rl1 = rl0 + 8;
    const float dl0 = s_delta[rl0], dl1 = s_delta[rl1];
    const bool rows_in = q0 + rl1 < T;   // rows past T (T % BM != 0)
    const float ls0 = rows_in ? lse[lbase + rl0] * kLog2e : 0.f;
    const float ls1 = rows_in ? lse[lbase + rl1] * kLog2e : 0.f;
    const float c = scale * kLog2e;
    const uint32_t q_addr = smem_u32(smem) + cw * 64 * 2 * D;
    const uint32_t do_addr = smem_u32(smem + C::OFF_DO) + cw * 64 * 2 * D;
    const uint32_t k_base = smem_u32(smem + C::OFF_K);
    const uint32_t v_base = smem_u32(smem + C::OFF_V);
    float s[BN / 2], dp[BN / 2], acc[D / 2];
    uint32_t ds[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // s <- ds = (p * (dp - delta)) * scale, p = 2^(s*c - lse2), in f32
    auto grad = [&]() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i & 2) == 0;
        const float p = ex2(fmaf(s[i], c, -(lo ? ls0 : ls1)));
        s[i] = (p * (dp[i] - (lo ? dl0 : dl1))) * scale;
      }
    };

    mbar_wait(bar_q, 0);
    if constexpr (POS) {
      // rows_in is the warpgroup's (T % 64 == 0): none of its rows or all
      const int2 wr = rng[nk + 1 + cw];
      const int sl0 = rows_in ? sid_b[q0 + rl0] : 0;
      const int sl1 = rows_in ? sid_b[q0 + rl1] : 0;
      const int cta_hi = rng[nk].y;
      // ds of the keys in stage st that rows rl0 / rl1 do not see: 0
      auto mask = [&](int st) {
        const int* ks =
            reinterpret_cast<const int*>(smem + C::OFF_SID + st * C::SIDS);
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const int2 k2 = *reinterpret_cast<const int2*>(ks + 8 * jj + 2 * t);
          if (k2.x > sl0) s[4 * jj] = 0.f;
          if (k2.y > sl0) s[4 * jj + 1] = 0.f;
          if (k2.x > sl1) s[4 * jj + 2] = 0.f;
          if (k2.y > sl1) s[4 * jj + 3] = 0.f;
        }
      };
      auto zero_ds = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) ds[kk][r] = 0u;
      };
      // the pending dS K of stage sp, then its release
      auto finish = [&](int sp) {
        wgmma_fence();
        mma_acc<D, BN>(acc, ds, k_base + sp * C::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
        if (lane == 0) mbar_arrive(&empty[sp]);
      };
      zero_ds();
      int sp = -1;   // the stage whose dS K is pending, -1 none (ds is 0)
      for (int j = 0, n = 0; j < nk; ++j) {
        const int2 kr = rng[j];
        if (kr.x > cta_hi) continue;       // not streamed
        const int sj = n % ST;
        const uint32_t parity = (n / ST) & 1;
        ++n;
        if (kr.x > wr.y) {                 // none of the rows sees it
          if (sp >= 0) {
            finish(sp);
            sp = -1;
            zero_ds();
          }
          mbar_wait(&full[sj], parity);
          if (lane == 0) mbar_arrive(&empty[sj]);
          continue;
        }
        mbar_wait(&full[sj], parity);
        wgmma_fence();
        mma_rows<D, BN>(s, q_addr, k_base + sj * C::TILE);
        mma_rows<D, BN>(dp, do_addr, v_base + sj * C::TILE);
        wgmma_commit();
        mma_acc<D, BN>(acc, ds, k_base + (sp >= 0 ? sp : sj) * C::TILE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        grad();
        if (kr.y > wr.x) mask(sj);         // some pair is not visible
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
        if (sp >= 0 && lane == 0) mbar_arrive(&empty[sp]);
        to_a<BN>(ds, s);
        sp = sj;
      }
      if (sp >= 0) finish(sp);
    } else if constexpr (SLAB) {
      const int first = q0 + cw * 64;        // the warpgroup's first row
      const int nkw =
          first < T ? (key_end(first + 63, T, P) + BN - 1) / BN : 0;
      // keys from mask_from on lie past the first row's slab
      const int mask_from = (first / P + 1) * P;
      const int sl0 = slab_of<kSlab>(nullptr, q0 + rl0, P);
      const int sl1 = slab_of<kSlab>(nullptr, q0 + rl1, P);
      // ds of the keys of tile j that rows rl0 / rl1 do not see: 0 (MASKED)
      auto mask = [&](int j) {
        if constexpr (C::MASKED) {
          if ((j + 1) * BN <= mask_from) return;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int key = j * BN + 8 * (i / 4) + 2 * t + (i & 1);
            if (slab_of<kSlab>(nullptr, key, P) > ((i & 2) ? sl1 : sl0))
              s[i] = 0.f;
          }
        }
      };
      if (nkw > 0) {
        mbar_wait(&full[0], 0);
        wgmma_fence();
        mma_rows<D, BN>(s, q_addr, k_base);
        mma_rows<D, BN>(dp, do_addr, v_base);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        grad();
        mask(0);
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
          grad();
          mask(j);
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
      // the tiles past the warpgroup's last slab: released unseen
      for (int j = nkw; j < nk; ++j) pass_tile<ST>(full, empty, j, lane);
    } else {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      mma_rows<D, BN>(s, q_addr, k_base);
      mma_rows<D, BN>(dp, do_addr, v_base);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grad();
      to_a<BN>(ds, s);
      for (int j = 1; j < nk; ++j) {
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
        grad();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
        if (lane == 0) mbar_arrive(&empty[sp]);
        to_a<BN>(ds, s);
      }
      wgmma_fence();
      mma_acc<D, BN>(acc, ds, k_base + ((nk - 1) % ST) * C::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

    bf16* dq0 = dq + (size_t(b) * T + q0 + rl0) * E + h * D + 2 * t;
    if (rows_in) store_rows<D>(dq0, dq0 + 8 * size_t(E), acc, 1.f, 1.f);
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_bwd_dq_dense_wgmma(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const bf16* __restrict__ out,
                                  const bf16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ delta,
                                  bf16* __restrict__ dq, int T, int H,
                                  float scale) {
  dq_pass<C>(tq, tk, tv, tdo, nullptr, out, dout, lse, delta, dq, T, H, 0,
             scale);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_bwd_dq_positions_wgmma(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo, const int* __restrict__ sid,
        const bf16* __restrict__ out, const bf16* __restrict__ dout,
        const float* __restrict__ lse, float* __restrict__ delta,
        bf16* __restrict__ dq, int T, int H, float scale) {
  dq_pass<C>(tq, tk, tv, tdo, sid, out, dout, lse, delta, dq, T, H, 0,
             scale);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_bwd_dq_slab_wgmma(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const bf16* __restrict__ out,
                                 const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 float* __restrict__ delta,
                                 bf16* __restrict__ dq, int T, int H, int P,
                                 float scale) {
  dq_pass<C>(tq, tk, tv, tdo, nullptr, out, dout, lse, delta, dq, T, H, P,
             scale);
}

// ---- backward: dk/dv pass ---------------------------------------------------

// NWG consumer warpgroups of 64 keys, query tiles of BN in a ring of
// STAGES.
template <int D_, int NWG_, int BN_, int CTAS_>
struct Dkv : Roles<NWG_> {
  static constexpr int D = D_, NWG = NWG_, BN = BN_, CTAS = CTAS_;
  static constexpr int MODE = kDense;
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

// K6's dk/dv pass: Dkv's shape with each stage's query slab ids after
// delta, and the slab ranges of the query tiles, of the CTA's keys and of
// each warpgroup's after the barriers (added at launch).
template <int D_, int NWG_, int BN_, int CTAS_>
struct DkvPos : Dkv<D_, NWG_, BN_, CTAS_> {
  using Base = Dkv<D_, NWG_, BN_, CTAS_>;
  static constexpr int MODE = kPositions, SIDS = BN_ * 4;
  static constexpr int OFF_SID = Base::OFF_DL + Base::STAGES * Base::VEC;
  static constexpr int OFF_BAR = OFF_SID + Base::STAGES * SIDS;
  static constexpr int OFF_RANGE = OFF_BAR + 8 * (1 + 2 * Base::STAGES);
  static constexpr int SMEM = OFF_RANGE + 1024;
};

// One CTA per (BM keys, head, batch row): the producer loads the K and V
// rows once, then a ring of (Q, dO, lse, delta) tiles of BN queries.
// Each consumer owns 64 keys: S^T = K Q^T and dP^T = V dO^T, then
// p^T = 2^(s*c - lse*log2 e) and ds^T = bf16(p^T * (dp^T - delta) *
// scale) in registers, dV += bf16(P^T) dO and dK += dS^T Q. Runs after
// the dq pass on the same stream, which orders the delta it reads.
// kPositions: the grid is (B * H, key blocks from the first), the query
// tiles' ids ride the ring, and only the query tiles that see some key of
// the CTA are streamed; a warpgroup releases those none of its keys is
// seen by. kSlab: the same grid; the producer streams the query tiles from
// the first row that sees the CTA's first key (its slab's start), each
// warpgroup releases those before its own first key's slab unseen.
template <class C>
__device__ __forceinline__ void dkv_pass(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const CUtensorMap& tdo,
                                         const int* __restrict__ sid,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, int T, int H,
                                         int P, float scale) {
  constexpr int D = C::D, BN = C::BN, ST = C::STAGES;
  constexpr bool POS = C::MODE == kPositions;
  constexpr bool SLAB = C::MODE == kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const float* s_lse = reinterpret_cast<const float*>(smem + C::OFF_L);
  const float* s_dl = reinterpret_cast<const float*>(smem + C::OFF_DL);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  int j0, h, b;
  if constexpr (POS || SLAB) {
    h = blockIdx.x % H;
    b = blockIdx.x / H;
    j0 = blockIdx.y * C::BM;
  } else {
    j0 = blockIdx.x * C::BM;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  const int nq = T / BN;
  // kSlab: the first query tile that sees the CTA's first key
  int i0 = 0;
  if constexpr (SLAB) i0 = (j0 / P) * P / BN;
  auto init_barriers = [&]() {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  };
  auto load_rows = [&]() {   // the CTA's K and V rows
    mbar_expect_tx(bar_kv, 2 * C::ROWS);
    tma_load(smem, &tk, bar_kv, h * D, j0, b);
    tma_load(smem + C::OFF_V, &tv, bar_kv, h * D, j0, b);
  };
  // kPositions: as the forward's, over query tiles and the CTA's keys
  int2* rng = nullptr;
  const int* sid_b = nullptr;
  if constexpr (POS) {
    if (tid == 128 * C::NWG) {
      init_barriers();
      load_rows();
    }
    rng = reinterpret_cast<int2*>(smem + C::OFF_RANGE);
    sid_b = sid + size_t(b) * T;
    slab_ranges<BN, C::NWG>(rng, sid_b, nq, j0, min(C::BM, T - j0));
  } else {
    if (tid == 0) init_barriers();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == C::NWG) {  // producer
    if (tid == 128 * C::NWG) {
      const size_t lbase = (size_t(b) * H + h) * T;
      if constexpr (POS) {
        const int cta_lo = rng[nq].x;
        for (int i = 0, n = 0; i < nq; ++i) {
          if (rng[i].y < cta_lo) continue;   // it sees no key of the CTA
          const int s = n % ST;
          mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * C::TILE + 2 * C::VEC + C::SIDS);
          tma_load(smem + C::OFF_Q + s * C::TILE, &tq, &full[s], h * D,
                   i * BN, b);
          tma_load(smem + C::OFF_DO + s * C::TILE, &tdo, &full[s], h * D,
                   i * BN, b);
          bulk_load(smem + C::OFF_L + s * C::VEC, lse + lbase + i * BN,
                    C::VEC, &full[s]);
          bulk_load(smem + C::OFF_DL + s * C::VEC, delta + lbase + i * BN,
                    C::VEC, &full[s]);
          bulk_load(smem + C::OFF_SID + s * C::SIDS, sid_b + i * BN, C::SIDS,
                    &full[s]);
          ++n;
        }
      } else {
        load_rows();
        for (int i = i0; i < nq; ++i) {
          const int s = (i - i0) % ST;
          mbar_wait(&empty[s], (((i - i0) / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * C::TILE + 2 * C::VEC);
          tma_load(smem + C::OFF_Q + s * C::TILE, &tq, &full[s], h * D,
                   i * BN, b);
          tma_load(smem + C::OFF_DO + s * C::TILE, &tdo, &full[s], h * D,
                   i * BN, b);
          bulk_load(smem + C::OFF_L + s * C::VEC, lse + lbase + i * BN,
                    C::VEC, &full[s]);
          bulk_load(smem + C::OFF_DL + s * C::VEC, delta + lbase + i * BN,
                    C::VEC, &full[s]);
        }
      }
    }
  } else {  // consumers
    const int cw = wg, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float c = scale * kLog2e;
    const uint32_t k_addr = smem_u32(smem) + cw * 64 * 2 * D;
    const uint32_t v_addr = smem_u32(smem + C::OFF_V) + cw * 64 * 2 * D;
    const uint32_t q_base = smem_u32(smem + C::OFF_Q);
    const uint32_t do_base = smem_u32(smem + C::OFF_DO);
    float st[BN / 2], dpt[BN / 2], dka[D / 2], dva[D / 2];
    uint32_t pa[BN / 16][4], dsa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    // st <- p^T, dpt <- ds^T, in f32, for the query tile in stage s
    auto grad = [&](int s) {
      const float* lq = s_lse + s * BN + 2 * t;
      const float* dlq = s_dl + s * BN + 2 * t;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * jj);
        const float2 d2 = *reinterpret_cast<const float2*>(dlq + 8 * jj);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ls = (e ? l2.y : l2.x) * kLog2e, dl = e ? d2.y : d2.x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * jj + 2 * r + e;
            const float p = ex2(fmaf(st[i], c, -ls));
            st[i] = p;
            dpt[i] = (p * (dpt[i] - dl)) * scale;
          }
        }
      }
    };
    // one query tile (stage si) for the warpgroup's keys
    auto attend = [&](int si) {
      wgmma_fence();
      mma_rows<D, BN>(st, k_addr, q_base + si * C::TILE);
      mma_rows<D, BN>(dpt, v_addr, do_base + si * C::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grad(si);
    };
    auto accumulate = [&](int si) {
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
    };

    mbar_wait(bar_kv, 0);
    if constexpr (POS) {
      const int first = j0 + cw * 64;
      const bool keys_in = first < T;        // T % 64 == 0: all or none
      // the warpgroup's least / greatest key id (none: every tile skipped)
      const int2 wk = rng[nq + 1 + cw];
      const int kr0 = first + warp * 16 + g;  // this thread's keys kr0, +8
      const int ks0 = keys_in ? sid_b[kr0] : 0;
      const int ks1 = keys_in ? sid_b[kr0 + 8] : 0;
      const int cta_lo = rng[nq].x;
      // p^T and ds^T of the queries in stage si that do not see keys
      // kr0 / kr0 + 8: 0
      auto mask = [&](int si) {
        const int* qs =
            reinterpret_cast<const int*>(smem + C::OFF_SID + si * C::SIDS);
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const int2 q2 = *reinterpret_cast<const int2*>(qs + 8 * jj + 2 * t);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ks = r ? ks1 : ks0;
            if (q2.x < ks) st[4 * jj + 2 * r] = dpt[4 * jj + 2 * r] = 0.f;
            if (q2.y < ks)
              st[4 * jj + 2 * r + 1] = dpt[4 * jj + 2 * r + 1] = 0.f;
          }
        }
      };
      for (int i = 0, n = 0; i < nq; ++i) {
        const int2 qr = rng[i];
        if (qr.y < cta_lo) continue;       // not streamed
        const int si = n % ST;
        const uint32_t parity = (n / ST) & 1;
        ++n;
        mbar_wait(&full[si], parity);
        if (qr.y < wk.x) {                 // it sees none of the keys
          if (lane == 0) mbar_arrive(&empty[si]);
          continue;
        }
        attend(si);
        if (qr.x < wk.y) mask(si);         // some pair is not visible
        accumulate(si);
      }
      if (!keys_in) return;
    } else if constexpr (SLAB) {
      const int first = j0 + cw * 64;        // the warpgroup's first key
      const bool keys_in = first < T;        // T % 64 == 0: all or none
      // its first query tile (the first row that sees its first key), and
      // the rows below which some of its keys are not seen (MASKED)
      const int iw = keys_in ? (first / P) * P / BN : nq;
      const int mask_below = ((first + 63) / P) * P;
      const int key0 = first + warp * 16 + g;   // this thread's keys, +8
      const int ks0 = slab_of<kSlab>(nullptr, key0, P);
      const int ks1 = slab_of<kSlab>(nullptr, key0 + 8, P);
      // p^T and ds^T of the queries of tile i that do not see keys key0 /
      // key0 + 8: 0
      auto mask = [&](int i) {
        if constexpr (C::MASKED) {
          if (i * BN >= mask_below) return;
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qs =
                  slab_of<kSlab>(nullptr, i * BN + 8 * jj + 2 * t + e, P);
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (qs < (r ? ks1 : ks0))
                  st[4 * jj + 2 * r + e] = dpt[4 * jj + 2 * r + e] = 0.f;
            }
        }
      };
      for (int i = i0; i < min(iw, nq); ++i)
        pass_tile<ST>(full, empty, i - i0, lane);
      for (int i = iw; i < nq; ++i) {
        const int si = (i - i0) % ST;
        mbar_wait(&full[si], ((i - i0) / ST) & 1);
        attend(si);
        mask(i);
        accumulate(si);
      }
      if (!keys_in) return;
    } else {
      for (int i = 0; i < nq; ++i) {
        const int si = i % ST;
        mbar_wait(&full[si], (i / ST) & 1);
        attend(si);
        accumulate(si);
      }
    }

    const int E = H * D, key0 = j0 + cw * 64 + warp * 16 + g;
    const size_t off = (size_t(b) * T + key0) * E + h * D + 2 * t;
    if (key0 + 8 < T) {   // keys past T (T % BM != 0) are not written
      store_rows<D>(dk + off, dk + off + 8 * size_t(E), dka, 1.f, 1.f);
      store_rows<D>(dv + off, dv + off + 8 * size_t(E), dva, 1.f, 1.f);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_bwd_dkv_dense_wgmma(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int T, int H,
                                   float scale) {
  dkv_pass<C>(tq, tk, tv, tdo, nullptr, lse, delta, dk, dv, T, H, 0,
              scale);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_bwd_dkv_positions_wgmma(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo, const int* __restrict__ sid,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
        float scale) {
  dkv_pass<C>(tq, tk, tv, tdo, sid, lse, delta, dk, dv, T, H, 0, scale);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    flash_attn_bwd_dkv_slab_wgmma(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int T, int H, int P,
                                  float scale) {
  dkv_pass<C>(tq, tk, tv, tdo, nullptr, lse, delta, dk, dv, T, H, P, scale);
}

// ---- host -----------------------------------------------------------------

// The production instances: head_dim D, consumer warpgroups, tile, CTAs
// an SM (settled on an H100; PERF.md). K6's (Pos*Of) were held against
// K7 dense's shapes on the card (PERF.md, section 6); K7 slab's (Slab*Of)
// are K7 dense's, unmasked or MASKED.
template <int D>
using FwdOf = Fwd<D, 2, D == 32 ? 64 : 128, D == 32 ? 2 : 1>;
template <int D>
using DqOf = Dq<D, D == 32 ? 3 : 2, 64, 1>;
template <int D>
using DkvOf = Dkv<D, D == 32 ? 3 : 2, 64, 1>;
template <int D>
using PosFwdOf = FwdPos<D, 2, D == 32 ? 64 : 128, D == 32 ? 2 : 1>;
template <int D>
using PosDqOf = DqPos<D, 1, 64, D == 32 ? 3 : 2>;
template <int D>
using PosDkvOf = DkvPos<D, 1, 64, D == 32 ? 3 : 2>;
template <int D, bool MASKED>
using SlabFwdOf = Slab<FwdOf<D>, MASKED>;
template <int D, bool MASKED>
using SlabDqOf = Slab<DqOf<D>, MASKED>;
template <int D, bool MASKED>
using SlabDkvOf = Slab<DkvOf<D>, MASKED>;

// A P at which every tile a pass of shape C visits is wholly visible to
// each warpgroup that walks it: slab boundaries fall on the 64-row groups
// and on the tiles.
template <class C>
bool unmasked(int P) {
  return P % 64 == 0 && P % C::BN == 0;
}

// Dynamic shared memory of a launch over T rows: K6's adds the slab
// ranges of its T / BN column tiles, of its rows and of each warpgroup's.
template <class C>
int smem_bytes(int T) {
  if constexpr (C::MODE == kPositions)
    return C::SMEM + 8 * (T / C::BN + 1 + C::NWG);
  return C::SMEM;
}

// Before a launch of ``kernel`` over T rows: its dynamic shared memory.
template <class C, typename Kernel>
cudaError_t prepare_rows(Kernel kernel, int T) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<C>(T));
}

// The grid of a pass over T rows: dense (row blocks, H, B); K6 and K7 slab
// (B * H, row blocks), which the kernels walk from the heaviest block.
template <class C>
dim3 grid_of(int B, int T, int H) {
  if constexpr (C::MODE != kDense) return dim3(B * H, grid_x(T, C::BM));
  return dim3(grid_x(T, C::BM), H, B);
}

template <class C>
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* sid, void* out, void* lse, int B, int T, int H,
                  int P, float scale, cudaStream_t st) {
  constexpr int D = C::D;
  CUtensorMap tq, tk, tv;
  const int E = H * D;
  if (!tile_map(&tq, q, B, T, E, D, C::BM) ||
      !tile_map(&tk, k, B, T, E, D, C::BN) ||
      !tile_map(&tv, v, B, T, E, D, C::BN))
    return int(cudaErrorInvalidValue);
  const dim3 grid = grid_of<C>(B, T, H);
  const int smem = smem_bytes<C>(T);
  if constexpr (C::MODE == kPositions) {
    auto kernel = flash_attn_fwd_positions_wgmma<C>;
    cudaError_t err = prepare_rows<C>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, C::THREADS, smem, st>>>(
        tq, tk, tv, static_cast<const int*>(sid), static_cast<bf16*>(out),
        static_cast<float*>(lse), T, H, scale);
  } else if constexpr (C::MODE == kSlab) {
    auto kernel = flash_attn_fwd_slab_wgmma<C>;
    cudaError_t err = prepare_rows<C>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, C::THREADS, smem, st>>>(tq, tk, tv,
                                           static_cast<bf16*>(out),
                                           static_cast<float*>(lse), T, H, P,
                                           scale);
  } else {
    auto kernel = flash_attn_fwd_dense_wgmma<C>;
    cudaError_t err = prepare_rows<C>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, C::THREADS, smem, st>>>(tq, tk, tv,
                                           static_cast<bf16*>(out),
                                           static_cast<float*>(lse), T, H,
                                           scale);
  }
  return int(cudaGetLastError());
}

template <class Q, class R>
int attention_bwd(const void* q, const void* k, const void* v,
                  const void* sid, const void* out, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv,
                  int B, int T, int H, int P, float scale, cudaStream_t st) {
  constexpr int D = Q::D;
  CUtensorMap tq, tk, tv, tdo;
  const int E = H * D;
  const int* ids = static_cast<const int*>(sid);
  const bf16* o = static_cast<const bf16*>(out);
  const bf16* d = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (!tile_map(&tq, q, B, T, E, D, Q::BM) ||
      !tile_map(&tdo, dout, B, T, E, D, Q::BM) ||
      !tile_map(&tk, k, B, T, E, D, Q::BN) ||
      !tile_map(&tv, v, B, T, E, D, Q::BN))
    return int(cudaErrorInvalidValue);
  const dim3 gq = grid_of<Q>(B, T, H);
  cudaError_t err;
  if constexpr (Q::MODE == kPositions) {
    auto kernel = flash_attn_bwd_dq_positions_wgmma<Q>;
    err = prepare_rows<Q>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<gq, Q::THREADS, smem_bytes<Q>(T), st>>>(
        tq, tk, tv, tdo, ids, o, d, l, dl, static_cast<bf16*>(dq), T, H,
        scale);
  } else if constexpr (Q::MODE == kSlab) {
    auto kernel = flash_attn_bwd_dq_slab_wgmma<Q>;
    err = prepare_rows<Q>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<gq, Q::THREADS, smem_bytes<Q>(T), st>>>(
        tq, tk, tv, tdo, o, d, l, dl, static_cast<bf16*>(dq), T, H, P,
        scale);
  } else {
    auto kernel = flash_attn_bwd_dq_dense_wgmma<Q>;
    err = prepare_rows<Q>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<gq, Q::THREADS, smem_bytes<Q>(T), st>>>(
        tq, tk, tv, tdo, o, d, l, dl, static_cast<bf16*>(dq), T, H, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  if (!tile_map(&tq, q, B, T, E, D, R::BN) ||
      !tile_map(&tdo, dout, B, T, E, D, R::BN) ||
      !tile_map(&tk, k, B, T, E, D, R::BM) ||
      !tile_map(&tv, v, B, T, E, D, R::BM))
    return int(cudaErrorInvalidValue);
  const dim3 gr = grid_of<R>(B, T, H);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  if constexpr (R::MODE == kPositions) {
    auto kernel = flash_attn_bwd_dkv_positions_wgmma<R>;
    err = prepare_rows<R>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<gr, R::THREADS, smem_bytes<R>(T), st>>>(
        tq, tk, tv, tdo, ids, l, dl, gk, gv, T, H, scale);
  } else if constexpr (R::MODE == kSlab) {
    auto kernel = flash_attn_bwd_dkv_slab_wgmma<R>;
    err = prepare_rows<R>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<gr, R::THREADS, smem_bytes<R>(T), st>>>(tq, tk, tv, tdo, l, dl,
                                                     gk, gv, T, H, P, scale);
  } else {
    auto kernel = flash_attn_bwd_dkv_dense_wgmma<R>;
    err = prepare_rows<R>(kernel, T);
    if (err != cudaSuccess) return int(err);
    kernel<<<gr, R::THREADS, smem_bytes<R>(T), st>>>(tq, tk, tv, tdo, l, dl,
                                                     gk, gv, T, H, scale);
  }
  return int(cudaGetLastError());
}

// The forward of mode ``mode`` at head_dim D.
template <int D>
int forward(int mode, const void* q, const void* k, const void* v,
            const void* sid, void* out, void* lse, int B, int T, int H,
            int P, float scale, cudaStream_t st) {
  if (mode == kDense)
    return attention_fwd<FwdOf<D>>(q, k, v, nullptr, out, lse, B, T, H, 0,
                                   scale, st);
  if (mode == kPositions)
    return attention_fwd<PosFwdOf<D>>(q, k, v, sid, out, lse, B, T, H, 0,
                                      scale, st);
  if (unmasked<SlabFwdOf<D, false>>(P))
    return attention_fwd<SlabFwdOf<D, false>>(q, k, v, nullptr, out, lse, B,
                                              T, H, P, scale, st);
  return attention_fwd<SlabFwdOf<D, true>>(q, k, v, nullptr, out, lse, B, T,
                                           H, P, scale, st);
}

// The dq pass, then the dk/dv pass, of mode ``mode`` at head_dim D.
template <int D>
int backward(int mode, const void* q, const void* k, const void* v,
             const void* sid, const void* out, const void* dout,
             const void* lse, void* delta, void* dq, void* dk, void* dv,
             int B, int T, int H, int P, float scale, cudaStream_t st) {
  if (mode == kDense)
    return attention_bwd<DqOf<D>, DkvOf<D>>(q, k, v, nullptr, out, dout, lse,
                                            delta, dq, dk, dv, B, T, H, 0,
                                            scale, st);
  if (mode == kPositions)
    return attention_bwd<PosDqOf<D>, PosDkvOf<D>>(q, k, v, sid, out, dout,
                                                  lse, delta, dq, dk, dv, B,
                                                  T, H, 0, scale, st);
  // the dq and the dk/dv pass walk 64-row tiles: one test for both
  static_assert(SlabDqOf<D, false>::BN == SlabDkvOf<D, false>::BN,
                "one mask instance for both passes");
  if (unmasked<SlabDqOf<D, false>>(P))
    return attention_bwd<SlabDqOf<D, false>, SlabDkvOf<D, false>>(
        q, k, v, nullptr, out, dout, lse, delta, dq, dk, dv, B, T, H, P,
        scale, st);
  return attention_bwd<SlabDqOf<D, true>, SlabDkvOf<D, true>>(
      q, k, v, nullptr, out, dout, lse, delta, dq, dk, dv, B, T, H, P, scale,
      st);
}

// Registers and CTAs an SM of one pass (0 forward, 1 dq, 2 dk/dv) of a
// mode's instances at head_dim D (kSlab: MASKED's or the unmasked one);
// K6's at the MAE encoder's N = 1536.
template <int D, int MODE, bool MASKED>
int pass_occupancy(int pass, int* regs, int* ctas) {
  constexpr int T = 1536;
  auto read = [&](auto kernel, auto shape) {
    using C = decltype(shape);
    const cudaError_t err = prepare_rows<C>(kernel, T);
    if (err != cudaSuccess) return int(err);
    return kernel_occupancy(kernel, C::THREADS, smem_bytes<C>(T), regs,
                            ctas);
  };
  if constexpr (MODE == kPositions) {
    if (pass == 0)
      return read(flash_attn_fwd_positions_wgmma<PosFwdOf<D>>,
                  PosFwdOf<D>());
    if (pass == 1)
      return read(flash_attn_bwd_dq_positions_wgmma<PosDqOf<D>>,
                  PosDqOf<D>());
    if (pass == 2)
      return read(flash_attn_bwd_dkv_positions_wgmma<PosDkvOf<D>>,
                  PosDkvOf<D>());
  } else if constexpr (MODE == kSlab) {
    using F = SlabFwdOf<D, MASKED>;
    using Q = SlabDqOf<D, MASKED>;
    using R = SlabDkvOf<D, MASKED>;
    if (pass == 0) return read(flash_attn_fwd_slab_wgmma<F>, F());
    if (pass == 1) return read(flash_attn_bwd_dq_slab_wgmma<Q>, Q());
    if (pass == 2) return read(flash_attn_bwd_dkv_slab_wgmma<R>, R());
  } else {
    if (pass == 0)
      return read(flash_attn_fwd_dense_wgmma<FwdOf<D>>, FwdOf<D>());
    if (pass == 1)
      return read(flash_attn_bwd_dq_dense_wgmma<DqOf<D>>, DqOf<D>());
    if (pass == 2)
      return read(flash_attn_bwd_dkv_dense_wgmma<DkvOf<D>>, DkvOf<D>());
  }
  return int(cudaErrorInvalidValue);
}

template <int D>
int occupancy_of(int mode, int pass, int* regs, int* ctas) {
  const bool masked = pass >= 3;
  pass %= 3;
  if (mode == kDense && !masked)
    return pass_occupancy<D, kDense, false>(pass, regs, ctas);
  if (mode == kPositions && !masked)
    return pass_occupancy<D, kPositions, false>(pass, regs, ctas);
  if (mode == kSlab)
    return masked ? pass_occupancy<D, kSlab, true>(pass, regs, ctas)
                  : pass_occupancy<D, kSlab, false>(pass, regs, ctas);
  return int(cudaErrorInvalidValue);
}

bool shape_ok(int T, int mode, int P, const void* sid) {
  return T % 128 == 0 && (mode == kDense || mode == kPositions ||
                          mode == kSlab) &&
         (mode != kSlab || P > 0) && (mode != kPositions || sid != nullptr);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda/flash_attention.py):
// T % 128 == 0, D in {32, 64}, contiguous bf16 [B, T, E] q/k/v, P > 0 for
// kSlab, a contiguous int32 [B, T] sid for kPositions.
extern "C" int fk_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* sid,
                                      void* out, void* lse, int B, int T,
                                      int H, int D, int mode, int P,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, mode, P, sid)) return int(cudaErrorInvalidValue);
  if (D == 32)
    return forward<32>(mode, q, k, v, sid, out, lse, B, T, H, P, scale, st);
  if (D == 64)
    return forward<64>(mode, q, k, v, sid, out, lse, B, T, H, P, scale, st);
  return int(cudaErrorInvalidValue);
}

// As the forward's, plus f32 [B, H, T] lse and delta. Launches the dq
// pass, then the dk/dv pass, on ``stream``.
extern "C" int fk_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* sid,
    const void* out, const void* dout, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int B, int T, int H, int D, int mode,
    int P, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, mode, P, sid)) return int(cudaErrorInvalidValue);
  if (D == 32)
    return backward<32>(mode, q, k, v, sid, out, dout, lse, delta, dq, dk,
                        dv, B, T, H, P, scale, st);
  if (D == 64)
    return backward<64>(mode, q, k, v, sid, out, dout, lse, delta, dq, dk,
                        dv, B, T, H, P, scale, st);
  return int(cudaErrorInvalidValue);
}

// Registers a thread and resident CTAs an SM of one pass (0 forward, 1 dq,
// 2 dk/dv; 3-5 the same passes of mode slab's MASKED instance) of a mode's
// kernel at head_dim D, from the CUDA runtime.
extern "C" int fk_flash_attention_occupancy(int mode, int pass, int D,
                                            int* regs, int* ctas) {
  if (pass < 0 || pass > 5) return int(cudaErrorInvalidValue);
  if (D == 32) return occupancy_of<32>(mode, pass, regs, ctas);
  if (D == 64) return occupancy_of<64>(mode, pass, regs, ctas);
  return int(cudaErrorInvalidValue);
}
