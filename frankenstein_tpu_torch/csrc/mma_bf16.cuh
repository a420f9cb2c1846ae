// Device helpers the kernel sources include (directly or through
// hopper_blocks.cuh): bf16 packing, the RoPE rotation the pre-passes of K1
// (slab_rope_attention_fwd.cu), K4 (slab_rope_attention_bwd.cu) and K10
// (slab_rope_attention_int8.cu) apply to q/k, and K10's int8 code rule.
// The rotation must be the same code in all of them: K4 recomputes K1's
// (or K10's) scores from its lse, so its rotated q/k must round exactly as
// the forward's did.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fk {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Load 8 bf16 lanes, rotate the 4 adjacent pairs in f32 with the position's
// table row, round to bf16. Same expression as the plain twin
// (rope.apply_rope_folded): x*cos + (-x_odd | x_even)*sin, unfused.
__device__ __forceinline__ uint4 load_rotate8(const bf16* __restrict__ src,
                                              const float* __restrict__ cos_row,
                                              const float* __restrict__ sin_row) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const bf16* x = reinterpret_cast<const bf16*>(&raw);
  float4 c0 = *reinterpret_cast<const float4*>(cos_row);
  float4 c1 = *reinterpret_cast<const float4*>(cos_row + 4);
  float4 s0 = *reinterpret_cast<const float4*>(sin_row);
  float4 s1 = *reinterpret_cast<const float4*>(sin_row + 4);
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float x0 = __bfloat162float(x[2 * p]);
    const float x1 = __bfloat162float(x[2 * p + 1]);
    o[p] = pack_bf16(
        __fadd_rn(__fmul_rn(x0, c[2 * p]), __fmul_rn(-x1, s[2 * p])),
        __fadd_rn(__fmul_rn(x1, c[2 * p + 1]), __fmul_rn(x0, s[2 * p + 1])));
  }
  return out;
}

// K10's int8 code of v at scale s: round half to even of the IEEE
// quotient (the JAX kernel's jnp.round(x / s)).
__device__ __forceinline__ int8_t quantize_s8(float v, float s) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(v, s)));
}

// K10's symmetric scale of a group whose max |x| is mx: mx / 127 + 1e-12,
// each step rounded in f32 (an IEEE quotient, not a product with 1/127).
__device__ __forceinline__ float absmax_scale(float mx) {
  return __fadd_rn(__fdiv_rn(mx, 127.f), 1e-12f);
}

}  // namespace fk
