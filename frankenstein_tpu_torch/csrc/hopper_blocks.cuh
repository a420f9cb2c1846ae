// Hopper building blocks shared by the wgmma kernels: K7 dense
// (flash_attention_dense.cu), K4 (slab_rope_attention_bwd.cu), K1
// (slab_rope_attention_fwd.cu), K10 (slab_rope_attention_int8.cu) and K9
// (fused_mlp.cu). Device side: the warp roles of a CTA, mbarriers, TMA and
// bulk copies, ex2, the wgmma fences, shared-memory descriptors (bf16 rows
// of a head, and K-major rows of 32, 64 or 128 bytes of any type) and
// products (SS and RS), the f32-accumulator to bf16 A-fragment re-pack,
// the log2-unit online softmax of a score tile, and the slab-causal
// schedule's key end and tile release. Host side: the TMA tile maps of a
// [B, T, E] bf16 tensor and of any row-major tensor, the grid of row
// blocks, and a kernel's launch preparation and occupancy. One copy,
// included by all five sources.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_host.cuh"
#include "mma_bf16.cuh"

namespace fk {

inline constexpr float kLog2e = 1.4426950408889634f;
inline constexpr float kLn2 = 0.6931471805599453f;

// Warp specialisation of a CTA: warpgroups 0..NWG-1 are the consumers of
// 64 rows each, the one warp after them the producer (its first lane
// issues every TMA load). No setmaxnreg: ptxas compiles
// the consumer path within the launch bound (at most 168 registers once a
// sub-partition of the SM holds three warps) whatever setmaxnreg would
// move at run time, so the register budget is set by the warps a CTA has
// and the CTAs an SM runs.
template <int NWG>
struct Roles {
  static constexpr int THREADS = 128 * NWG + 32;
};

// ---- shared memory, barriers, TMA ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the phase of ``parity`` to complete. A wait that outlives any
// real one (2^28 polls, seconds) traps, so a lost arrival fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// One [rows, D] box of a [B, T, E] bf16 tensor (map dims {E, T, B}) at
// column c0 = h * D, row c1, batch c2; rows past T arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ``bytes`` (a multiple of 16) contiguous bytes from global memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The calling thread's warpgroup, as a value the compiler knows to be
// uniform across the warp (the role branches split on it).
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// Sync the 128 threads of one consumer warpgroup (ids 1, 2; 0 is
// __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler that an in-flight wgmma owns these registers: no read
// or write of them moves across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a tile of rows of D bf16 (2*D bytes,
// one swizzle row: 64-byte swizzle at D = 32, 128-byte at D = 64) stored as
// TMA wrote it, from a 1024-byte aligned base. K-major operands (rows are
// M or N, the row's D values are K) step 8-row groups by SBO = 16*D bytes;
// the leading offset is unused. MN-major operands (rows are K, the row's
// D values are N = one swizzle atom) step 8-row K groups by the same
// stride; both offsets carry it, so either reading of the two fields
// addresses the same bytes.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, bool mn_major) {
  constexpr uint64_t kGroup = (8 * 2 * D) >> 4;   // 8 rows, 16-byte units
  constexpr uint64_t kSwizzle = D == 32 ? 2 : 1;  // 64B : 128B
  const uint64_t lead = mn_major ? kGroup : 1;
  return uint64_t((addr & 0x3FFFF) >> 4) | (lead << 16) | (kGroup << 32) |
         (kSwizzle << 62);
}

// Shared-memory descriptor of a K-major tile whose rows are ROW bytes (32,
// 64 or 128: one swizzle row of that width, 32-, 64- or 128-byte swizzle)
// stored as TMA wrote it, from a base aligned to the swizzle's repeat
// (8 * ROW bytes): 8-row groups step by SBO = 8 * ROW bytes, the leading
// offset is unused, and a k-step of 32 bytes adds 32 to the address.
// smem_desc<D>'s K-major reading is kmajor_desc<2 * D>; this form also
// reads int8 rows (K10's D-byte q and k rows) and the 128-byte column
// blocks of K9's h and weight tiles.
template <int ROW>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "a swizzle row width");
  constexpr uint64_t kGroup = (8 * ROW) >> 4;   // 8 rows, 16-byte units
  constexpr uint64_t kSwizzle = ROW == 32 ? 3 : ROW == 64 ? 2 : 1;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (kGroup << 32) | (kSwizzle << 62);
}

template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  // d[32] (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  // d[64] (+)= A (64 x 16, smem) * B (16 x 128, smem), both K-major
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  // d[16] += A (64 x 16, registers) * B (16 x 32, smem, MN-major)
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  // d[32] += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---- tile math -------------------------------------------------------------

// s (64 x N, f32) = A (64 x D) * B (N x D)^T, both as TMA stored them at
// shared addresses a and b: D / 16 k-steps of 32 bytes.
template <int D, int N>
__device__ __forceinline__ void mma_rows(float (&s)[N / 2], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    WgmmaSS<N>::mma(s, smem_desc<D>(a + kk * 32, false),
                    smem_desc<D>(b + kk * 32, false), kk > 0);
}

// c (64 x D) += A (64 x K, bf16 A-fragments) * B (K x D), B's K rows of D
// as TMA stored them at shared address b: K / 16 k-steps of 16 rows.
template <int D, int K>
__device__ __forceinline__ void mma_acc(float (&c)[D / 2],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    WgmmaRS<D>::mma(c, a[kk], smem_desc<D>(b + kk * 16 * 2 * D, true));
}

// The f32 accumulator of a 64 x N product (thread: rows g and g + 8 of its
// warp's 16, columns 8j + 2t + {0, 1}) rounded to bf16 as the A-fragments
// of a product over those N columns: k-step kk takes column blocks 2kk and
// 2kk + 1 (the mma.sync m16n8k16 re-pack, per warp).
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Rows r0 and r0 + 8 of a warpgroup's 64 x D accumulator, times f0 / f1,
// as bf16 at dst0 / dst1 (this thread's columns 8n + 2t + {0, 1}).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst0, bf16* dst1,
                                           const float (&c)[D / 2], float f0,
                                           float f1) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(dst0 + 8 * n) =
        pack_bf16(c[4 * n] * f0, c[4 * n + 1] * f0);
    *reinterpret_cast<uint32_t*>(dst1 + 8 * n) =
        pack_bf16(c[4 * n + 2] * f1, c[4 * n + 3] * f1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A running max (log2 units) below this has seen only masked scores
// (finfo(f32).min times c): no visible score comes near it.
inline constexpr float kNoKeyYet = -1e30f;

// One tile's online softmax in log2 units, in place: s holds the raw
// scores q.k of rows g and g + 8; on return their exps 2^(s*c - m) with
// the new running max m, l holds the row sums so far (per thread;
// quad-summed at the end) and a the factor the output rows must be
// rescaled by (1 where the max did not move). MASKED: s may hold
// finfo(f32).min for invisible keys, and a row may have seen nothing
// else yet. Its max is then that score times c, and one FFMA's s*c - m
// is not 0 but s*c's rounding error (up to 2^102, whose ex2 is inf), so
// such a row takes its exps from a base of +inf: all 0, l and o stay 0,
// and the first visible score rescales them by 2^(m - n) = 0.
template <int N, bool MASKED = false>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float c,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& a0, float& a1) {
  // four independent max chains a row, then a tree: short dependencies
  float r0[4], r1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) r0[e] = r1[e] = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    r0[2 * (j & 1)] = fmaxf(r0[2 * (j & 1)], s[4 * j]);
    r0[2 * (j & 1) + 1] = fmaxf(r0[2 * (j & 1) + 1], s[4 * j + 1]);
    r1[2 * (j & 1)] = fmaxf(r1[2 * (j & 1)], s[4 * j + 2]);
    r1[2 * (j & 1) + 1] = fmaxf(r1[2 * (j & 1) + 1], s[4 * j + 3]);
  }
  const float x0 = fmaxf(fmaxf(r0[0], r0[1]), fmaxf(r0[2], r0[3]));
  const float x1 = fmaxf(fmaxf(r1[0], r1[1]), fmaxf(r1[2], r1[3]));
  const float n0 = fmaxf(m0, quad_max(x0) * c);
  const float n1 = fmaxf(m1, quad_max(x1) * c);
  a0 = n0 == m0 ? 1.f : ex2(m0 - n0);
  a1 = n1 == m1 ? 1.f : ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float b0 = n0, b1 = n1;
  if constexpr (MASKED) {
    b0 = n0 < kNoKeyYet ? INFINITY : n0;
    b1 = n1 < kNoKeyYet ? INFINITY : n1;
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -b0));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], c, -b1));
      sum0 += s[4 * j + e];
      sum1 += s[4 * j + 2 + e];
    }
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// Shared memory rounded up to the 1024-byte alignment of the 128-byte
// swizzle (the launch asks for 1024 bytes more than it uses).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---- slab-causal schedule -------------------------------------------------

// One past the last key row ``row`` sees.
__device__ __forceinline__ int key_end(int row, int T, int P) {
  return min(T, (row / P + 1) * P);
}

// Wait for tile n of a ring of ST stages to land, then release it.
template <int ST>
__device__ __forceinline__ void pass_tile(uint64_t* full, uint64_t* empty,
                                          int n, int lane) {
  mbar_wait(&full[n % ST], (n / ST) & 1);
  if (lane == 0) mbar_arrive(&empty[n % ST]);
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a row-major tensor of ``elem``-byte elements, [outer,
// rows, cols] (dims {cols, rows, outer}; outer 1 for a matrix), read in
// boxes of box_rows rows of box_cols columns, swizzled by the box's row
// width (32, 64 or 128 bytes) as kmajor_desc reads it.
inline bool tile_map_rows(CUtensorMap* map, const void* base,
                          CUtensorMapDataType type, int elem, int outer,
                          int rows, int cols, int box_cols, int box_rows) {
  const EncodeTiled encode = encoder();
  const int row_bytes = box_cols * elem;
  if (encode == nullptr ||
      (row_bytes != 32 && row_bytes != 64 && row_bytes != 128))
    return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(outer)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * elem,
                                 cuuint64_t(rows) * cols * elem};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      row_bytes == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA map of a [B, T, E] bf16 tensor (dims {E, T, B}) read in boxes of
// ``rows`` rows of D columns, swizzled as smem_desc reads them.
inline bool tile_map(CUtensorMap* map, const void* base, int B, int T, int E,
                     int D, int rows) {
  return tile_map_rows(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, T,
                       E, D, rows);
}

// CTAs of BM rows that cover T rows.
inline int grid_x(int T, int BM) { return (T + BM - 1) / BM; }

// Before a launch of a kernel: its dynamic shared memory.
template <class C, typename Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
}

// Registers a thread and resident CTAs an SM of a kernel, from the CUDA
// runtime.
template <class C, typename Kernel>
int occupancy(Kernel kernel, int* regs, int* ctas) {
  cudaError_t err = prepare<C>(kernel);
  if (err != cudaSuccess) return int(err);
  return fk::kernel_occupancy(kernel, C::THREADS, C::SMEM, regs, ctas);
}

}  // namespace fk
