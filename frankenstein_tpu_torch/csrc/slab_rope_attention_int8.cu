// K10: slab-causal flash attention with RoPE and int8 QK scores, forward,
// for Hopper (sm_90a): K1's forward (slab_rope_attention_fwd.cu) with its
// score product in int8 wgmma.
//
// Replaces frankenstein_tpu/ops/pallas/block_attention.py:
// _fwd_packed_rope_bte (:1454; kernel _fwd_packed_rope_kernel :1334, call
// :1519) with qk_int8=True (:1371-1403, :1411-1425). Contract, K1's with
// the JAX kernel's int8 arithmetic:
//   q, v      [B, T, E] bf16, q UNROTATED, head h = columns [h*D, (h+1)*D)
//   k8, ks    rotated K's codes [B, T, E] int8 and scales [B, H, T / 1024]
//             f32, from K10's K pre-pass (fk_slab_rope_k_quant, below):
//             one scale per (1024-row key chunk, head), s = max|k| / 127 +
//             1e-12 in f32
//   cos, sin  [T, D] f32, rope_cache[-T:], each column repeated for the
//             adjacent lanes 2i, 2i+1 (suffix-aligned)
//   q8, qs    workspace: rotated Q's codes [B, T, E] int8 and scales
//             [B, H, T] f32, one scale per (row, head)
//   out       [B, T, E] bf16; lse [B, H, T] f32 (natural units; K4 runs on
//             K10's out and lse)
// D in {32, 64}, T % 1024 == 0, any P > 0. Key j is visible to query i iff
// j / P <= i / P. Scores are (float(dot(q8, k8)) * (scale * ks)) * qs, in
// that order; then K1's softmax and its bf16 P V (V, the probabilities and
// out stay bf16, l sums the unrounded exps).
//
// The K pre-pass rotates K, takes each chunk's max |k| (an atomic max on
// the float's bits, exact in any order) and writes the codes and scales.
// Two launches after it, on one stream, no atomics, a fixed order of every
// sum: two launches of K10 are bitwise equal.
//   * Q pre-pass: one thread a 16-byte chunk (8 lanes) of a (row, head):
//     rotated by fk::load_rotate8 (K1's and K4's rotation, rounded to
//     bf16), the (row, head)'s max |q| by shuffles over its D / 8 adjacent
//     lanes, the scale and codes by fk::absmax_scale / fk::quantize_s8 (the
//     rule K's pre-pass applies: round half to even of the IEEE quotient).
//     Bytes bound: q and the tables read once, D + 4 bytes a (row, head)
//     written.
//   * forward: K1's CTA (NWG consumer warpgroups of 64 query rows and a
//     producer warp, heaviest row block first), producer and slab schedule:
//     the producer loads the CTA's q8 rows, then streams (k8, v) tiles of
//     BN keys through a ring of TMA loads up to the CTA's furthest key;
//     each warpgroup walks the tiles its rows see and releases the rest.
//     S = q8 k8^T is wgmma.m64nBNk32.s32.s8.s8 with both operands from
//     shared memory as TMA stored them, K-major (8-bit wgmma has no
//     transpose): rows of D bytes, 32-byte swizzle at D = 32 (one k-step)
//     and 64-byte swizzle at D = 64 (two). |dot| <= 64 * 127^2 < 2^22, so
//     the s32 sum converts to f32 exactly, here by the bit trick of
//     s32_to_f32 (an integer add and an f32 subtract, no conversion unit).
//     A key tile lies in one 1024-row chunk (1024 % BN == 0): its scale is
//     one load a tile, the row scales two loads a thread. Then K1's
//     log2-unit online softmax of the dequantized scores (ex2 of one FFMA,
//     rescale skipped where a row's max did not move), P V with A from
//     registers and V through the transpose-B bit, issued with the next
//     tile's S and overlapped with its softmax.
//
// Masks: K1's two compile-time instances (unmasked where P is a multiple
// of the key tile and of 64, masked otherwise, -inf only on the tiles that
// cross the warpgroup's first slab boundary).
//
// What bounds it on an H100: as K1, the exps, one ex2 a visible pair (at
// 16 a clock an SM: 0.081 ms at B=2, T=6144, H=8, P=256), far above the
// products (2*D int8 and 2*D bf16 ops a visible pair: 0.031 ms); the
// dequantization adds four FP32/ALU operations a score to K1's softmax.
// The shapes (Int8Of) start from K1's and were held against their
// neighbours on the card by tools/k1_shape_sweep.py --int8 (PERF.md).
//
// The int8 probes (fk_slab_attention_probe_int8; ops/cuda/slab_probe.py)
// replace tools/int8_attr_probe.py: _call, which prices the parts of int8
// QK scores by timing variants with one removed. Here each variant runs
// both pre-passes with ROPE = false (q and k as stored, as the JAX probes
// omit RoPE), then an instance of this forward at D = 32, every mode branch
// behind if constexpr (Int8Pass's MODE; PROD compiles to the production
// kernel):
//   int8_full           K10's codes, the production instance Int8Of
//   int8_cheap_dequant  K10's codes; the scores s32_to_f32 * scale only,
//                       no s_k or s_q load or multiply (SCALE_ONLY)
//   int8_noquant        cast-only codes round(8 x) from both pre-passes
//                       (CAST: no max reduction, no scale), SCALE_ONLY
//   int8_dots_only      cast-only codes; the int32 scores rounded to bf16
//                       straight into P V, no softmax; lse 0 (DOTS)
//
// Kernel names: slab_rope_attn_fwd_int8_* and rope_*_k, never with
// flash_attn_fwd in a name or a template type (chip_smoke.py's profile
// families take the first pattern that matches, and K6 / K7's comes first).

#include "flash_host.cuh"
#include "flash_mask.cuh"
#include "hopper_blocks.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fk;

constexpr int PREP_THREADS = 256;
constexpr int KCHUNK = 1024;   // key rows per K scale

// Forward modes (Int8Pass's MODE): K10's scores, convert times scale only,
// or the raw int32 scores into P V.
enum Mode : int { PROD = 0, SCALE_ONLY = 1, DOTS = 2 };

// The int8 probes; the numbers are fk_slab_attention_probe_int8's
// `variant` (ops/cuda/slab_probe.py:PROBE_VARIANTS).
enum Variant : int {
  INT8_FULL = 5,
  INT8_DOTS_ONLY = 6,
  INT8_CHEAP_DEQUANT = 7,
  INT8_NOQUANT = 8,
};

// The probes' cast-only int8 code: round half to even of 8 v (the JAX
// probes' round(8 x); |v| < 15.9 keeps it in range).
__device__ __forceinline__ int8_t cast_code(float v) {
  return static_cast<int8_t>(__float2int_rn(8.f * v));
}

// 8 bf16 lanes of x at src, rotated with the position's table rows (ROPE)
// or as stored.
template <bool ROPE>
__device__ __forceinline__ uint4 stage8(const bf16* __restrict__ src,
                                        const float* __restrict__ cos_row,
                                        const float* __restrict__ sin_row) {
  if constexpr (ROPE) return load_rotate8(src, cos_row, sin_row);
  return *reinterpret_cast<const uint4*>(src);
}

// ---- Q pre-pass ---------------------------------------------------------------

// One thread a 16-byte chunk (8 lanes) of a (row, head): the rotated lanes
// (ROPE; as stored else), the (row, head)'s scale over its D / 8 threads,
// the 8 codes; CAST: the cast-only codes, no scale.
template <int D, bool ROPE = true, bool CAST = false>
__global__ void __launch_bounds__(PREP_THREADS)
    slab_rope_attn_fwd_int8_prep(const bf16* __restrict__ q,
                                 const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_t,
                                 int8_t* __restrict__ q8,
                                 float* __restrict__ qs, int T, int H,
                                 size_t chunks) {
  constexpr int CH = D / 8;   // threads a (row, head): adjacent lanes
  static_assert(PREP_THREADS % CH == 0, "a (row, head) in one block");
  const size_t idx = size_t(blockIdx.x) * PREP_THREADS + threadIdx.x;
  // chunks % CH == 0: a (row, head)'s lanes are all in range or all out,
  // and every lane of the warp takes part in the shuffles
  const bool in = idx < chunks;
  const int E = H * D;
  const size_t off = (in ? idx : 0) * 8;
  const int c = int(off % E) % D;
  const int pos = int((off / E) % T);
  float f[8];
  float mx = 0.f;
  if (in) {
    const uint4 rot = stage8<ROPE>(q + off, cos_t + size_t(pos) * D + c,
                                   sin_t + size_t(pos) * D + c);
    const bf16* rv = reinterpret_cast<const bf16*>(&rot);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = __bfloat162float(rv[i]);
      if constexpr (!CAST) mx = fmaxf(mx, fabsf(f[i]));
    }
  }
  if constexpr (!CAST) {
#pragma unroll
    for (int o = 1; o < CH; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (!in) return;
  const float s = CAST ? 0.f : absmax_scale(mx);
  uint2 codes;
  int8_t* c8 = reinterpret_cast<int8_t*>(&codes);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    c8[i] = CAST ? cast_code(f[i]) : quantize_s8(f[i], s);
  *reinterpret_cast<uint2*>(q8 + off) = codes;
  if (!CAST && c == 0) {
    const int h = int(off % E) / D;
    const size_t b = off / (size_t(T) * E);
    qs[(b * H + h) * T + pos] = s;
  }
}

// ---- K pre-pass ---------------------------------------------------------------

// K10's pre-pass, two kernels over tiles of ROWS K rows (one 8-lane piece
// a thread): rope_absmax_k rotates K (the rotation K1 applies, rounded to
// bf16) and folds each tile's max |k| into its chunk's max with an atomic
// max on the float's bits (non-negative floats order as their bits do);
// rope_quantize_k rotates again, takes the chunk's scale and writes the
// codes, and the chunk's first tile writes the scale. K is read twice, the
// second time mostly from L2. The probes run them with ROPE = false (K as
// stored) and, for the cast-only modes, rope_quantize_k alone with CAST:
// codes round(8 k), no chunk max and no scale.
constexpr int QK_THREADS = 256;

template <int D>
struct QkTile {
  static constexpr int CH = D / 8;              // pieces a row
  static constexpr int ROWS = QK_THREADS / CH;  // 64 at D=32, 32 at D=64
  static_assert(KCHUNK % ROWS == 0, "a tile must sit in one chunk");

  // the chunk of this CTA's tile in the [B, H, T / KCHUNK] scale arrays
  static __device__ __forceinline__ size_t slot(int T, int H) {
    return (size_t(blockIdx.z) * H + blockIdx.y) * (T / KCHUNK) +
           blockIdx.x * ROWS / KCHUNK;
  }

  // this thread's 8 rotated (ROPE) or stored lanes; returns their offset
  // in k
  template <bool ROPE>
  static __device__ __forceinline__ size_t rotated(const bf16* k,
                                                   const float* cos_t,
                                                   const float* sin_t, int T,
                                                   int H, float (&f)[8]) {
    const int r = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
    const int pos = blockIdx.x * ROWS + r;
    const size_t off = (size_t(blockIdx.z) * T + pos) * (H * D) +
                       size_t(blockIdx.y) * D + c;
    uint4 rot = stage8<ROPE>(k + off, cos_t + size_t(pos) * D + c,
                             sin_t + size_t(pos) * D + c);
    const bf16* rv = reinterpret_cast<const bf16*>(&rot);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(rv[i]);
    return off;
  }
};

template <int D, bool ROPE>
__global__ void __launch_bounds__(QK_THREADS)
rope_absmax_k(const bf16* __restrict__ k, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, unsigned* __restrict__ amax,
              int T, int H) {
  __shared__ float red[QK_THREADS / 32];
  float f[8];
  QkTile<D>::template rotated<ROPE>(k, cos_t, sin_t, T, H, f);
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(f[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < QK_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
    atomicMax(amax + QkTile<D>::slot(T, H), __float_as_uint(mx));
  }
}

template <int D, bool ROPE, bool CAST>
__global__ void __launch_bounds__(QK_THREADS)
rope_quantize_k(const bf16* __restrict__ k, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t,
                const unsigned* __restrict__ amax, int8_t* __restrict__ k8,
                float* __restrict__ ks, int T, int H) {
  float s = 0.f;
  if constexpr (!CAST) {
    const size_t slot = QkTile<D>::slot(T, H);
    s = absmax_scale(__uint_as_float(amax[slot]));
    if (threadIdx.x == 0 && (blockIdx.x * QkTile<D>::ROWS) % KCHUNK == 0)
      ks[slot] = s;
  }
  float f[8];
  const size_t off =
      QkTile<D>::template rotated<ROPE>(k, cos_t, sin_t, T, H, f);
  uint2 codes;
  int8_t* c8 = reinterpret_cast<int8_t*>(&codes);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    c8[i] = CAST ? cast_code(f[i]) : quantize_s8(f[i], s);
  *reinterpret_cast<uint2*>(k8 + off) = codes;
}

// ---- forward --------------------------------------------------------------------

// d[N/2] (+)= A (64 x 32 s8, smem) * B (32 x N s8, smem), both K-major.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// s (64 x N, s32) = A (64 x D) * B (N x D)^T on int8 rows of D bytes as
// TMA stored them at shared addresses a and b: D / 32 k-steps of 32 bytes.
template <int D, int N>
__device__ __forceinline__ void mma_rows_s8(uint32_t (&s)[N / 2], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    WgmmaS8<N>::mma(s, kmajor_desc<D>(a + kk * 32),
                    kmajor_desc<D>(b + kk * 32), kk > 0);
}

// The exact f32 value of an s32 sum |x| < 2^22: added to the bits of
// 1.5 * 2^23 it is the mantissa of 1.5 * 2^23 + x, which the subtract
// leaves exact (no I2F through the conversion unit).
__device__ __forceinline__ float s32_to_f32(uint32_t x) {
  return __fsub_rn(__uint_as_float(x + 0x4B400000u), 12582912.f);
}

// NWG consumer warpgroups of 64 query rows, key tiles of BN in a ring of
// STAGES; MASKED compiles the per-element slab mask, MODE a probe mode.
template <int D_, int NWG_, int BN_, int CTAS_, bool MASKED_,
          int MODE_ = PROD>
struct Int8Pass : Roles<NWG_> {
  static constexpr int D = D_, NWG = NWG_, BN = BN_, CTAS = CTAS_;
  static constexpr bool MASKED = MASKED_;
  static constexpr int MODE = MODE_;
  static constexpr int BM = 64 * NWG, STAGES = 4;
  static_assert(128 % BN == 0 && KCHUNK % BN == 0,
                "a key tile in one 128-row block and one scale chunk");
  static constexpr int Q_BYTES = BM * D, K_TILE = BN * D, V_TILE = BN * D * 2;
  static constexpr int OFF_K = (Q_BYTES + 1023) / 1024 * 1024;
  static constexpr int K_STEP = (K_TILE + 1023) / 1024 * 1024;
  static constexpr int OFF_V = OFF_K + STAGES * K_STEP;
  static constexpr int OFF_BAR = OFF_V + STAGES * V_TILE;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// One CTA per (BM query rows, head, batch row): blockIdx.x = b * H + h,
// blockIdx.y counts row blocks from the last (the heaviest) down. Ring of
// (k8, v) tiles: full completes when a tile has landed, empty when every
// consumer warp is done with the stage.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    slab_rope_attn_fwd_int8_wgmma(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const float* __restrict__ qs,
                                  const float* __restrict__ ks,
                                  bf16* __restrict__ out,
                                  float* __restrict__ lse, int T, int H,
                                  int P, float scale) {
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
        mbar_expect_tx(&full[s], C::K_TILE + C::V_TILE);
        tma_load(smem + C::OFF_K + s * C::K_STEP, &tk, &full[s], h * D,
                 j * BN, b);
        tma_load(smem + C::OFF_V + s * C::V_TILE, &tv, &full[s], h * D,
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
    const int mask_from = (first / P + 1) * P;
    const int end0 = (slab_of<kSlab>(nullptr, row0, P) + 1) * P;
    const int end1 = (slab_of<kSlab>(nullptr, row1, P) + 1) * P;
    const float* qs_row = qs + (size_t(b) * H + h) * T;
    const float* ks_bh = ks + (size_t(b) * H + h) * (T / KCHUNK);
    const float sq0 = rows_in ? qs_row[row0] : 0.f;
    const float sq1 = rows_in ? qs_row[row1] : 0.f;
    const uint32_t q_addr = smem_u32(smem) + cw * 64 * D;
    const uint32_t k_base = smem_u32(smem + C::OFF_K);
    const uint32_t v_base = smem_u32(smem + C::OFF_V);
    uint32_t si[BN / 2];
    float s[BN / 2], o[D / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
    // the scores of key tile j, dequantized in the JAX kernel's order
    // (dot * (scale * s_k)) * s_q (SCALE_ONLY: dot * scale; DOTS: the
    // dot), those this thread's rows do not see at -inf (masked instance)
    auto scores = [&](int j, float sk) {
      if constexpr (C::MODE == PROD) {
        const float ssk = __fmul_rn(scale, sk);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          s[i] = __fmul_rn(__fmul_rn(s32_to_f32(si[i]), ssk),
                           (i & 2) ? sq1 : sq0);
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          s[i] = C::MODE == SCALE_ONLY ? __fmul_rn(s32_to_f32(si[i]), scale)
                                       : s32_to_f32(si[i]);
      }
      if constexpr (C::MASKED) {
        if ((j + 1) * BN <= mask_from) return;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = j * BN + 8 * (i / 4) + 2 * t + (i & 1);
          if (key >= ((i & 2) ? end1 : end0)) s[i] = -INFINITY;
        }
      }
    };
    // the scale chunk of key tile j
    auto chunk_scale = [&](int j) { return __ldg(ks_bh + j * BN / KCHUNK); };

    mbar_wait(bar_q, 0);
    if (nkw > 0) {
      const float sk = chunk_scale(0);
      mbar_wait(&full[0], 0);
      wgmma_fence();
      mma_rows_s8<D, BN>(si, q_addr, k_base);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(si);
      scores(0, sk);
      if constexpr (C::MODE != DOTS)
        online_softmax<BN>(s, kLog2e, m0, m1, l0, l1, a0, a1);
      to_a<BN>(p, s);
      // Tile j's scores are issued with tile j-1's PV; tile j's softmax
      // runs while that PV is in flight, and rescales o once it has landed.
      for (int j = 1; j < nkw; ++j) {
        const int sj = j % ST, sp = (j - 1) % ST;
        const float skj = chunk_scale(j);
        mbar_wait(&full[sj], (j / ST) & 1);
        wgmma_fence();
        mma_rows_s8<D, BN>(si, q_addr, k_base + sj * C::K_STEP);
        wgmma_commit();
        mma_acc<D, BN>(o, p, v_base + sp * C::V_TILE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(si);
        scores(j, skj);
        if constexpr (C::MODE != DOTS)
          online_softmax<BN>(s, kLog2e, m0, m1, l0, l1, a0, a1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&empty[sp]);
        if constexpr (C::MODE != DOTS) {
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
      mma_acc<D, BN>(o, p, v_base + sl * C::V_TILE);
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
      if constexpr (C::MODE == DOTS) {   // the raw accumulator; lse 0
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
// tools/k1_shape_sweep.py --int8, which rewrites this line; PERF.md).
template <int D, bool MASKED>
using Int8Of = Int8Pass<D, D == 32 ? 2 : 3, 64, D == 32 ? 2 : 1, MASKED>;

// P a multiple of the key tile and of the warpgroup's 64 rows: no tile the
// loop visits crosses a slab boundary.
template <int D>
bool unmasked(int P) {
  return P % Int8Of<D, false>::BN == 0 && P % 64 == 0;
}

// The Q pre-pass (ROPE: rotated; CAST: the cast-only codes, no scales).
template <int D, bool ROPE = true, bool CAST = false>
int prep(const void* q, const void* cos_t, const void* sin_t, void* q8,
         void* qs, int B, int T, int H, cudaStream_t st) {
  const size_t chunks = size_t(B) * T * H * (D / 8);
  const unsigned blocks = unsigned((chunks + PREP_THREADS - 1) / PREP_THREADS);
  slab_rope_attn_fwd_int8_prep<D, ROPE, CAST>
      <<<blocks, PREP_THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<int8_t*>(q8),
      static_cast<float*>(qs), T, H, chunks);
  return int(cudaGetLastError());
}

// The forward on the pre-passes' codes and scales.
template <class C>
int attend(const void* q8, const void* qs, const void* k8, const void* ks,
           const void* v, void* out, void* lse, int B, int T, int H, int P,
           float scale, cudaStream_t st) {
  constexpr int D = C::D;
  CUtensorMap tq, tk, tv;
  const int E = H * D;
  if (!tile_map_rows(&tq, q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, T, E, D,
                     C::BM) ||
      !tile_map_rows(&tk, k8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, T, E, D,
                     C::BN) ||
      !tile_map(&tv, v, B, T, E, D, C::BN))
    return int(cudaErrorInvalidValue);
  auto kernel = slab_rope_attn_fwd_int8_wgmma<C>;
  cudaError_t err = prepare<C>(kernel);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(B * H, grid_x(T, C::BM)), C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, H, P, scale);
  return int(cudaGetLastError());
}

template <int D>
int forward(const void* q, const void* k8, const void* ks, const void* v,
            const void* cos_t, const void* sin_t, void* q8, void* qs,
            void* out, void* lse, int B, int T, int H, int P, float scale,
            cudaStream_t st) {
  const int rc = prep<D>(q, cos_t, sin_t, q8, qs, B, T, H, st);
  if (rc != 0) return rc;
  if (unmasked<D>(P))
    return attend<Int8Of<D, false>>(q8, qs, k8, ks, v, out, lse, B, T, H, P,
                                    scale, st);
  return attend<Int8Of<D, true>>(q8, qs, k8, ks, v, out, lse, B, T, H, P,
                                 scale, st);
}

template <int D, bool MASKED>
int pass_occupancy(int pass, int* regs, int* ctas) {
  using C = Int8Of<D, MASKED>;
  if (pass == 0)
    return kernel_occupancy(slab_rope_attn_fwd_int8_prep<D>, PREP_THREADS, 0,
                            regs, ctas);
  if (pass == 1)
    return occupancy<C>(slab_rope_attn_fwd_int8_wgmma<C>, regs, ctas);
  return int(cudaErrorInvalidValue);
}

bool shape_ok(int T, int D) {
  return T > 0 && T % KCHUNK == 0 && (D == 32 || D == 64);
}

// The K pre-pass: rope_absmax_k into amax (zero on entry), then
// rope_quantize_k into k8 and ks; CAST: rope_quantize_k alone (amax and ks
// unused).
template <int D, bool ROPE, bool CAST>
int k_prep(const void* k, const void* cos_t, const void* sin_t, void* amax,
           void* k8, void* ks, int B, int T, int H, cudaStream_t st) {
  const dim3 grid(T / QkTile<D>::ROWS, H, B);
  if constexpr (!CAST) {
    rope_absmax_k<D, ROPE><<<grid, QK_THREADS, 0, st>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<unsigned*>(amax), T, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  rope_quantize_k<D, ROPE, CAST><<<grid, QK_THREADS, 0, st>>>(
      static_cast<const bf16*>(k), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const unsigned*>(amax),
      static_cast<int8_t*>(k8), static_cast<float*>(ks), T, H);
  return int(cudaGetLastError());
}

// A probe's forward instance: the production shape at D = 32 in a mode.
template <bool MASKED, int MODE>
using ProbeOf = Int8Pass<32, Int8Of<32, MASKED>::NWG, Int8Of<32, MASKED>::BN,
                         Int8Of<32, MASKED>::CTAS, MASKED, MODE>;

bool cast_only(int variant) {
  return variant == INT8_DOTS_ONLY || variant == INT8_NOQUANT;
}

// f(an object of the forward instance int8 probe `variant` runs at P), or
// an error for a variant this file does not have.
template <typename F>
int with_probe(int variant, int P, F f) {
  const bool masked = !unmasked<32>(P);
  switch (variant) {
    case INT8_FULL:
      return masked ? f(Int8Of<32, true>()) : f(Int8Of<32, false>());
    case INT8_CHEAP_DEQUANT:
    case INT8_NOQUANT:
      return masked ? f(ProbeOf<true, SCALE_ONLY>())
                    : f(ProbeOf<false, SCALE_ONLY>());
    case INT8_DOTS_ONLY: return f(ProbeOf<false, DOTS>());
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// K10's K pre-pass (production K10 runs it before the Q pre-pass and the
// forward): codes k8 [B, T, E] int8, scales ks [B, H, T/1024]; amax
// [B, H, T/1024] u32 scratch, zero on entry. Shapes are checked by the
// Python wrapper (ops/cuda/slab_attention.py).
extern "C" int fk_slab_rope_k_quant(const void* k, const void* cos_t,
                                    const void* sin_t, void* amax, void* k8,
                                    void* ks, int B, int T, int H, int D,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D)) return int(cudaErrorInvalidValue);
  if (D == 32)
    return k_prep<32, true, false>(k, cos_t, sin_t, amax, k8, ks, B, T, H,
                                   st);
  return k_prep<64, true, false>(k, cos_t, sin_t, amax, k8, ks, B, T, H, st);
}

// K10's Q pre-pass alone: codes q8 [B, T, E] int8 and scales qs [B, H, T]
// f32 of q rotated. Shapes are checked by the Python wrapper
// (ops/cuda/slab_attention.py).
extern "C" int fk_slab_rope_q_quant(const void* q, const void* cos_t,
                                    const void* sin_t, void* q8, void* qs,
                                    int B, int T, int H, int D,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D)) return int(cudaErrorInvalidValue);
  if (D == 32) return prep<32>(q, cos_t, sin_t, q8, qs, B, T, H, st);
  return prep<64>(q, cos_t, sin_t, q8, qs, B, T, H, st);
}

// K10 after its K pre-pass (fk_slab_rope_k_quant's k8, ks): the Q pre-pass
// into the caller's q8 and qs workspaces, then the forward into out and
// lse, on ``stream``. Shapes are checked by the Python wrapper: T % 1024
// == 0, D in {32, 64}, contiguous bf16 [B, T, E] q and v, int8 k8, f32
// [B, H, T / 1024] ks, f32 [T, D] tables, f32 [B, H, T] qs and lse.
extern "C" int fk_slab_rope_attention_fwd_int8(
    const void* q, const void* k8, const void* ks, const void* v,
    const void* cos_t, const void* sin_t, void* q8, void* qs, void* out,
    void* lse, int B, int T, int H, int D, int P, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D) || P <= 0) return int(cudaErrorInvalidValue);
  if (D == 32)
    return forward<32>(q, k8, ks, v, cos_t, sin_t, q8, qs, out, lse, B, T, H,
                       P, scale, st);
  return forward<64>(q, k8, ks, v, cos_t, sin_t, q8, qs, out, lse, B, T, H,
                     P, scale, st);
}

// Registers a thread and resident CTAs an SM of one K10 pass (0 Q
// pre-pass, 1 forward) at head_dim D, in the instance tokens-per-slab P
// takes.
extern "C" int fk_slab_rope_attention_fwd_int8_occupancy(int pass, int D,
                                                         int P, int* regs,
                                                         int* ctas) {
  if ((D != 32 && D != 64) || P <= 0) return int(cudaErrorInvalidValue);
  if (D == 32)
    return unmasked<32>(P) ? pass_occupancy<32, false>(pass, regs, ctas)
                           : pass_occupancy<32, true>(pass, regs, ctas);
  return unmasked<64>(P) ? pass_occupancy<64, false>(pass, regs, ctas)
                         : pass_occupancy<64, true>(pass, regs, ctas);
}

// The int8 probes on UNROTATED q and k at D = 32: `stages` & 1 runs the K
// pre-pass into k8 and ks (amax [B, H, T/1024] u32 scratch, zero on
// entry), & 2 the Q pre-pass into q8 and qs, both with ROPE = false and,
// for the cast-only variants, CAST (amax, ks and qs then unused); & 4 the
// forward instance of `variant` (enum Variant) on k8, ks, q8, qs as they
// stand. Shapes are checked by the Python wrapper (ops/cuda/slab_probe.py):
// T % 1024 == 0, contiguous [B, T, E] tensors.
extern "C" int fk_slab_attention_probe_int8(
    const void* q, const void* k, const void* v, void* amax, void* q8,
    void* qs, void* k8, void* ks, void* out, void* lse, int B, int T, int H,
    int D, int P, float scale, int variant, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(T, D) || D != 32 || P <= 0 || variant < INT8_FULL ||
      variant > INT8_NOQUANT)
    return int(cudaErrorInvalidValue);
  const bool cast = cast_only(variant);
  if (stages & 1) {
    const int rc =
        cast ? k_prep<32, false, true>(k, nullptr, nullptr, amax, k8, ks, B,
                                       T, H, st)
             : k_prep<32, false, false>(k, nullptr, nullptr, amax, k8, ks, B,
                                        T, H, st);
    if (rc != 0) return rc;
  }
  if (stages & 2) {
    const int rc = cast ? prep<32, false, true>(q, nullptr, nullptr, q8, qs,
                                                B, T, H, st)
                        : prep<32, false, false>(q, nullptr, nullptr, q8, qs,
                                                 B, T, H, st);
    if (rc != 0) return rc;
  }
  if (!(stages & 4)) return 0;
  return with_probe(variant, P, [&](auto c) {
    return attend<decltype(c)>(q8, qs, k8, ks, v, out, lse, B, T, H, P,
                               scale, st);
  });
}

// Registers a thread and resident CTAs an SM of the forward instance int8
// probe `variant` runs at tokens-per-slab P.
extern "C" int fk_slab_attention_probe_int8_occupancy(int variant, int P,
                                                      int* regs,
                                                      int* ctas) {
  if (P <= 0) return int(cudaErrorInvalidValue);
  return with_probe(variant, P, [&](auto c) {
    using C = decltype(c);
    return fk::occupancy<C>(slab_rope_attn_fwd_int8_wgmma<C>, regs, ctas);
  });
}
