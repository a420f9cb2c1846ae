// K1: slab-causal flash attention with RoPE, forward, for Hopper (sm_90a):
// a rotation pre-pass, then a forward on the TMA rings, wgmma products and
// exp2 of K7 dense (hopper_blocks.cuh), walked on K4's slab schedule.
//
// Replaces frankenstein_tpu/ops/pallas/block_attention.py:
// _fwd_packed_rope_bte (:1454; kernel _fwd_packed_rope_kernel :1334, call
// :1519), reached from slab_causal_attention_rope. Contract:
//   q, k, v   [B, T, E] bf16, UNROTATED, head h = columns [h*D, (h+1)*D)
//   cos, sin  [T, D] f32, rope_cache[-T:] with each column repeated for the
//             adjacent lanes 2i, 2i+1 (suffix-aligned)
//   qr, kr    [B, T, E] bf16 workspace: q and k rotated by the pre-pass
//   out       [B, T, E] bf16
//   lse       [B, H, T] f32, per-row logsumexp in natural units (K4 reads
//             it to recompute the probabilities)
// D in {32, 64}, T % 128 == 0, any P > 0. Key j is visible to query i iff
// j / P <= i / P (P = tokens per time slab).
//
// What it computes, as the JAX package does: s = (q_rot k_rot^T) * scale
// on q and k rotated in f32 and rounded to bf16, the online softmax in
// f32, the probabilities rounded to bf16 before the PV product (l sums the
// unrounded exps), out rounded once to bf16.
//
// Two launches on one stream, no atomics, a fixed order of every sum: two
// launches of K1 are bitwise equal.
//   * pre-pass: one thread a 16-byte chunk of a (row, head); writes qr and
//     kr with fk::load_rotate8, the unfused rotation K4's pre-pass runs, so
//     that K4 recomputes K1's scores from K1's lse. 2 reads and 2 writes of
//     [B, T, E]: bytes bound. Each key is rotated once, not once for every
//     query CTA that reads it.
//   * forward: one CTA per (NWG*64 query rows, head, batch row), heaviest
//     row block first (its keys run to the end of its last row's slab).
//     One producer warp loads the CTA's Q rows, then streams (kr, v) tiles
//     of BN keys through a ring of TMA loads up to the CTA's furthest key;
//     each consumer warpgroup of 64 rows walks the tiles its rows see,
//     S = Q K^T issued with the previous tile's O += P V and this tile's
//     softmax run while that product is in flight, then waits for and
//     releases the tiles past its last slab, so the ring never stalls.
// Every product is a wgmma: Q K^T from shared memory as TMA stored it, P V
// with A from registers (the f32 tile rounded to bf16 in place) and V
// through the transpose-B bit. exp is ex2.approx of one FFMA, s * (scale *
// log2 e) - m, with the running max m in log2 units and the rescale
// skipped where a row's max did not move; lse leaves as (m + log2 l) * ln 2.
//
// Masks are two compile-time instances. Where P is a multiple of the key
// tile and of the warpgroup's 64 rows (the flagship's P = 256, and P = T)
// every (warpgroup, tile) pair the loop visits is wholly visible: the
// unmasked instance carries no mask code. Every other P takes the masked
// instance, which sets the scores of invisible keys to -inf before the row
// max, and only on the tiles that cross the warpgroup's first slab
// boundary (flash_mask.cuh: slab_of<kSlab>). Every row sees key 0, so each
// row's max is finite after its first tile.
//
// What bounds it on an H100: at D = 32 the exps, one ex2 a visible pair
// (at 16 a clock an SM: 0.081 ms at B=2, T=6144, H=8, P=256), above the
// products (4*D ops a visible pair: 0.041 ms); the K / V tiles are re-read
// from L2 by every row block of a head. The shapes (FwdOf) start from K7
// dense's forward and were held against their neighbours on the card by
// tools/k1_shape_sweep.py (PERF.md): at D = 32 two CTAs an SM of two
// consumer warpgroups and 64-key tiles, at D = 64 one CTA of three.
//
// The probes (fk_slab_attention_probe; ops/cuda/slab_probe.py) replace
// tools/attn_probe.py: _variant_call, which prices the components of the
// packed TPU forward by timing variants with one removed. Here each bf16
// variant is an instance of this forward on UNROTATED q and k (no
// pre-pass) at D = 32, every mode branch behind if constexpr (FwdPass's
// MODE; PROD compiles to the production kernel):
//   kernel, bf16,  the production instance FwdOf<32, MASKED> itself (the
//   mask_last      masked one masks only the tiles that cross the
//                  warpgroup's first slab, which mask_last prices)
//   exp2           kernel's instance: the exps already are ex2 of one FFMA
//   no_mask        the unmasked production instance at any P, over every
//                  tile a warpgroup visits
//   MASK_ALL       the masked body with the mask on every visited tile
//   DOTS_ONLY      the scores times scale, rounded to bf16, straight into
//                  P V: no mask, max, exp, sum or rescale; out is the
//                  unnormalised accumulator, lse 0
//   NO_KBD         V read K-major from the same tile and swizzle instead of
//                  through the transpose-B bit (the step that plays the
//                  TPU's block-diagonal staging; values wrong, timing only)
//
// Kernel names: slab_rope_attn_fwd_*, never with flash_attn_fwd in a name
// or a template type (chip_smoke.py's profile families take the first
// pattern that matches, and K6 / K7's comes first).

#include "flash_host.cuh"
#include "flash_mask.cuh"
#include "hopper_blocks.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fk;

constexpr int PREP_THREADS = 256;

// Probe modes; the numbers are fk_slab_attention_probe's `variant`
// (ops/cuda/slab_probe.py:PROBE_VARIANTS). FwdPass's MODE is PROD,
// DOTS_ONLY, NO_KBD or MASK_ALL; NO_MASK runs the unmasked PROD instance.
enum Mode : int {
  PROD = 0,
  DOTS_ONLY = 1,
  NO_KBD = 2,
  NO_MASK = 3,
  MASK_ALL = 4,
};

// ---- pre-pass ---------------------------------------------------------------

// One thread a 16-byte chunk (8 lanes) of a (row, head): qr, kr rotated by
// load_rotate8.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
    slab_rope_attn_fwd_prep(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            bf16* __restrict__ qr, bf16* __restrict__ kr,
                            int T, int H, size_t chunks) {
  const size_t idx = size_t(blockIdx.x) * PREP_THREADS + threadIdx.x;
  if (idx >= chunks) return;
  const int E = H * D;
  const size_t off = idx * 8;
  const int c = int(off % E) % D;
  const int pos = int((off / E) % T);
  const float* cr = cos_t + size_t(pos) * D + c;
  const float* sr = sin_t + size_t(pos) * D + c;
  *reinterpret_cast<uint4*>(qr + off) = load_rotate8(q + off, cr, sr);
  *reinterpret_cast<uint4*>(kr + off) = load_rotate8(k + off, cr, sr);
}

// ---- forward ------------------------------------------------------------------

// NWG consumer warpgroups of 64 query rows, key tiles of BN in a ring of
// STAGES; MASKED compiles the per-element slab mask, MODE a probe mode.
template <int D_, int NWG_, int BN_, int CTAS_, bool MASKED_,
          int MODE_ = PROD>
struct FwdPass : Roles<NWG_> {
  static constexpr int D = D_, NWG = NWG_, BN = BN_, CTAS = CTAS_;
  static constexpr bool MASKED = MASKED_;
  static constexpr int MODE = MODE_;
  static constexpr int BM = 64 * NWG, STAGES = 4;
  static_assert(128 % BN == 0, "T % 128 == 0 must leave no partial tile");
  static constexpr int Q_BYTES = BM * D * 2, TILE = BN * D * 2;
  static constexpr int OFF_K = (Q_BYTES + 1023) / 1024 * 1024;
  static constexpr int OFF_V = OFF_K + STAGES * TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * TILE;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// NO_KBD's P V: c (64 x D) += A (64 x K) * B with B's K x D read K-major
// from V's tile of K rows of D (rows of 2*D bytes as TMA stored them): the
// D-row blocks of the tile in turn, each D / 16 k-steps of 32 bytes, so
// every byte of the tile is read once, at the wrong place (timing only).
template <int D, int K>
__device__ __forceinline__ void mma_acc_kmajor(float (&c)[D / 2],
                                               const uint32_t (&a)[K / 16][4],
                                               uint32_t b) {
  static_assert(D == 32 && K % D == 0, "the probes' D = 32");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t desc = smem_desc<D>(
        b + (kk / (D / 16)) * D * 2 * D + (kk % (D / 16)) * 32, false);
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15])
        : "r"(a[kk][0]), "r"(a[kk][1]), "r"(a[kk][2]), "r"(a[kk][3]),
          "l"(desc), "r"(1));
  }
}

// One CTA per (BM query rows, head, batch row): blockIdx.x = b * H + h,
// blockIdx.y counts row blocks from the last (the heaviest) down. Ring of
// (kr, v) tiles: full completes when a tile has landed, empty when every
// consumer warp is done with the stage.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    slab_rope_attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             bf16* __restrict__ out, float* __restrict__ lse,
                             int T, int H, int P, float scale) {
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
      mbar_expect_tx(bar_q, C::Q_BYTES);
      tma_load(smem, &tq, bar_q, h * D, q0, b);
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
    const int first = q0 + cw * 64;        // the warpgroup's first row
    const bool rows_in = first < T;        // T % 64 == 0: all or none
    const int nkw =
        rows_in ? (key_end(first + 63, T, P) + BN - 1) / BN : 0;
    const int row0 = first + warp * 16 + g, row1 = row0 + 8;
    // keys from here on lie past the first row's slab (masked instance),
    // and from end0 / end1 on past this thread's rows' slabs
    const int mask_from = (first / P + 1) * P;
    const int end0 = (slab_of<kSlab>(nullptr, row0, P) + 1) * P;
    const int end1 = (slab_of<kSlab>(nullptr, row1, P) + 1) * P;
    const float c = scale * kLog2e;
    const uint32_t q_addr = smem_u32(smem) + cw * 64 * 2 * D;
    const uint32_t k_base = smem_u32(smem + C::OFF_K);
    const uint32_t v_base = smem_u32(smem + C::OFF_V);
    float s[BN / 2], o[D / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
    // the scores of key tile j that this thread's rows do not see at -inf
    // (MASK_ALL: on every tile)
    auto mask = [&](int j) {
      if constexpr (C::MASKED) {
        if constexpr (C::MODE != MASK_ALL) {
          if ((j + 1) * BN <= mask_from) return;
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = j * BN + 8 * (i / 4) + 2 * t + (i & 1);
          if (key >= ((i & 2) ? end1 : end0)) s[i] = -INFINITY;
        }
      }
    };

    mbar_wait(bar_q, 0);
    if (nkw > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      mma_rows<D, BN>(s, q_addr, k_base);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (C::MODE == DOTS_ONLY) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] *= scale;
      } else {
        mask(0);
        online_softmax<BN>(s, c, m0, m1, l0, l1, a0, a1);
      }
      to_a<BN>(p, s);
      // Tile j's scores are issued with tile j-1's PV; tile j's softmax
      // runs while that PV is in flight, and rescales o once it has landed.
      for (int j = 1; j < nkw; ++j) {
        const int sj = j % ST, sp = (j - 1) % ST;
        mbar_wait(&full[sj], (j / ST) & 1);
        wgmma_fence();
        mma_rows<D, BN>(s, q_addr, k_base + sj * C::TILE);
        wgmma_commit();
        if constexpr (C::MODE == NO_KBD)
          mma_acc_kmajor<D, BN>(o, p, v_base + sp * C::TILE);
        else
          mma_acc<D, BN>(o, p, v_base + sp * C::TILE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        if constexpr (C::MODE == DOTS_ONLY) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) s[i] *= scale;
        } else {
          mask(j);
          online_softmax<BN>(s, c, m0, m1, l0, l1, a0, a1);
        }
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&empty[sp]);
        if constexpr (C::MODE != DOTS_ONLY) {
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            o[4 * n] *= a0;
            o[4 * n + 1] *= a0;
            o[4 * n + 2] *= a1;
            o[4 * n + 3] *= a1;
          }
        }
        to_a<BN>(p, s);
      }
      const int sl = (nkw - 1) % ST;
      wgmma_fence();
      if constexpr (C::MODE == NO_KBD)
        mma_acc_kmajor<D, BN>(o, p, v_base + sl * C::TILE);
      else
        mma_acc<D, BN>(o, p, v_base + sl * C::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(&empty[sl]);
    }
    // the tiles past this warpgroup's last slab: released, or the ring
    // would stall the producer for the warpgroups that see them
    for (int j = nkw; j < nk; ++j) pass_tile<ST>(full, empty, j, lane);

    if (rows_in) {
      if constexpr (C::MODE == DOTS_ONLY) {   // the raw accumulator; lse 0
        const int E = H * D;
        bf16* out0 = out + (size_t(b) * T + row0) * E + h * D + 2 * t;
        store_rows<D>(out0, out0 + 8 * size_t(E), o, 1.f, 1.f);
        if (t == 0) {
          float* lrow = lse + (size_t(b) * H + h) * T;
          lrow[row0] = lrow[row1] = 0.f;
        }
      } else {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        const int E = H * D;
        bf16* out0 = out + (size_t(b) * T + row0) * E + h * D + 2 * t;
        store_rows<D>(out0, out0 + 8 * size_t(E), o, 1.f / l0, 1.f / l1);
        if (t == 0) {
          float* lrow = lse + (size_t(b) * H + h) * T;
          lrow[row0] = (m0 + log2f(l0)) * kLn2;
          lrow[row1] = (m1 + log2f(l1)) * kLn2;
        }
      }
    }
  }
}

// ---- host ---------------------------------------------------------------------

// The production instances: head_dim D, consumer warpgroups, key tile, CTAs
// an SM, and the mask (held against their neighbours on an H100 by
// tools/k1_shape_sweep.py, which rewrites this line; PERF.md).
template <int D, bool MASKED>
using FwdOf = FwdPass<D, D == 32 ? 2 : 3, 64, D == 32 ? 2 : 1, MASKED>;

// P a multiple of the key tile and of the warpgroup's 64 rows: no tile the
// loop visits crosses a slab boundary.
template <int D>
bool unmasked(int P) {
  return P % FwdOf<D, false>::BN == 0 && P % 64 == 0;
}

template <int D>
int prep(const void* q, const void* k, const void* cos_t, const void* sin_t,
         void* qr, void* kr, int B, int T, int H, cudaStream_t st) {
  const size_t chunks = size_t(B) * T * H * (D / 8);
  const unsigned blocks = unsigned((chunks + PREP_THREADS - 1) / PREP_THREADS);
  slab_rope_attn_fwd_prep<D><<<blocks, PREP_THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(qr), static_cast<bf16*>(kr), T, H, chunks);
  return int(cudaGetLastError());
}

// The forward on the pre-pass's qr and kr.
template <class C>
int attend(const void* qr, const void* kr, const void* v, void* out,
           void* lse, int B, int T, int H, int P, float scale,
           cudaStream_t st) {
  constexpr int D = C::D;
  CUtensorMap tq, tk, tv;
  const int E = H * D;
  if (!tile_map(&tq, qr, B, T, E, D, C::BM) ||
      !tile_map(&tk, kr, B, T, E, D, C::BN) ||
      !tile_map(&tv, v, B, T, E, D, C::BN))
    return int(cudaErrorInvalidValue);
  auto kernel = slab_rope_attn_fwd_wgmma<C>;
  cudaError_t err = prepare<C>(kernel);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(B * H, grid_x(T, C::BM)), C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), T, H, P,
      scale);
  return int(cudaGetLastError());
}

template <int D>
int forward(const void* q, const void* k, const void* v, const void* cos_t,
            const void* sin_t, void* qr, void* kr, void* out, void* lse,
            int B, int T, int H, int P, float scale, cudaStream_t st) {
  const int rc = prep<D>(q, k, cos_t, sin_t, qr, kr, B, T, H, st);
  if (rc != 0) return rc;
  if (unmasked<D>(P))
    return attend<FwdOf<D, false>>(qr, kr, v, out, lse, B, T, H, P, scale,
                                   st);
  return attend<FwdOf<D, true>>(qr, kr, v, out, lse, B, T, H, P, scale, st);
}

template <int D, bool MASKED>
int pass_occupancy(int pass, int* regs, int* ctas) {
  using C = FwdOf<D, MASKED>;
  if (pass == 0)
    return kernel_occupancy(slab_rope_attn_fwd_prep<D>, PREP_THREADS, 0, regs,
                            ctas);
  if (pass == 1) return occupancy<C>(slab_rope_attn_fwd_wgmma<C>, regs, ctas);
  return int(cudaErrorInvalidValue);
}

bool shape_ok(int T, int D) { return T % 128 == 0 && (D == 32 || D == 64); }

// A probe mode's instance: the production shape at D = 32 in that mode.
template <bool MASKED, int MODE>
using ProbeOf = FwdPass<32, FwdOf<32, MASKED>::NWG, FwdOf<32, MASKED>::BN,
                        FwdOf<32, MASKED>::CTAS, MASKED, MODE>;

// f(an object of the instance probe mode `variant` runs at P), or an
// error for a mode this file does not have.
template <typename F>
int with_probe(int variant, int P, F f) {
  const bool masked = !unmasked<32>(P);
  switch (variant) {
    case PROD:
      return masked ? f(FwdOf<32, true>()) : f(FwdOf<32, false>());
    case DOTS_ONLY: return f(ProbeOf<false, DOTS_ONLY>());
    case NO_KBD:
      return masked ? f(ProbeOf<true, NO_KBD>()) : f(ProbeOf<false, NO_KBD>());
    case NO_MASK: return f(FwdOf<32, false>());
    case MASK_ALL: return f(ProbeOf<true, MASK_ALL>());
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// The pre-pass alone: qr, kr ([B, T, E] bf16) from q, k. Shapes are
// checked by the Python wrapper (ops/cuda/slab_attention.py).
extern "C" int fk_slab_rope_attn_fwd_prep(const void* q, const void* k,
                                          const void* cos_t,
                                          const void* sin_t, void* qr,
                                          void* kr, int B, int T, int H,
                                          int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D)) return int(cudaErrorInvalidValue);
  if (D == 32) return prep<32>(q, k, cos_t, sin_t, qr, kr, B, T, H, st);
  return prep<64>(q, k, cos_t, sin_t, qr, kr, B, T, H, st);
}

// K1: the pre-pass, then the forward on ``stream``, into the caller's qr
// and kr workspaces and out, lse. Shapes are checked by the Python
// wrapper: T % 128 == 0, D in {32, 64}, contiguous bf16 [B, T, E] tensors,
// f32 [T, D] tables, f32 [B, H, T] lse.
extern "C" int fk_slab_rope_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* cos_t,
                                          const void* sin_t, void* qr,
                                          void* kr, void* out, void* lse,
                                          int B, int T, int H, int D, int P,
                                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D) || P <= 0) return int(cudaErrorInvalidValue);
  if (D == 32)
    return forward<32>(q, k, v, cos_t, sin_t, qr, kr, out, lse, B, T, H, P,
                       scale, st);
  return forward<64>(q, k, v, cos_t, sin_t, qr, kr, out, lse, B, T, H, P,
                     scale, st);
}

// Registers a thread and resident CTAs an SM of one K1 pass (0 pre-pass,
// 1 forward) at head_dim D, in the instance tokens-per-slab P takes.
extern "C" int fk_slab_rope_attention_fwd_occupancy(int pass, int D, int P,
                                                    int* regs, int* ctas) {
  if ((D != 32 && D != 64) || P <= 0) return int(cudaErrorInvalidValue);
  if (D == 32)
    return unmasked<32>(P) ? pass_occupancy<32, false>(pass, regs, ctas)
                           : pass_occupancy<32, true>(pass, regs, ctas);
  return unmasked<64>(P) ? pass_occupancy<64, false>(pass, regs, ctas)
                         : pass_occupancy<64, true>(pass, regs, ctas);
}

// The bf16 probes: probe mode `variant` (enum Mode) of the forward on
// UNROTATED q and k at D = 32, no pre-pass, into out and lse on
// ``stream``. Shapes are checked by the Python wrapper
// (ops/cuda/slab_probe.py): T % 128 == 0, contiguous bf16 [B, T, E].
extern "C" int fk_slab_attention_probe(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int T, int H, int D, int P,
                                       float scale, int variant,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D) || D != 32 || P <= 0)
    return int(cudaErrorInvalidValue);
  return with_probe(variant, P, [&](auto c) {
    return attend<decltype(c)>(q, k, v, out, lse, B, T, H, P, scale, st);
  });
}

// Registers a thread and resident CTAs an SM of the instance bf16 probe
// mode `variant` runs at tokens-per-slab P.
extern "C" int fk_slab_attention_probe_occupancy(int variant, int P,
                                                 int* regs, int* ctas) {
  if (P <= 0) return int(cudaErrorInvalidValue);
  return with_probe(variant, P, [&](auto c) {
    using C = decltype(c);
    return fk::occupancy<C>(slab_rope_attn_fwd_wgmma<C>, regs, ctas);
  });
}

// The text of a CUDA error code any entry point of the library returned
// (ops/cuda/build.py:check).
extern "C" const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
