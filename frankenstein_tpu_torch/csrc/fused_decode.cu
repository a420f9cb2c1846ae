// K2: one GPT-2 token through all L transformer blocks.
//
// Replaces frankenstein_tpu/ops/pallas/fused_decode.py:fused_decode_blocks
// (the math of _chunk_math, shared by the grid kernel _kernel and the
// manually pipelined _fused_decode_pipelined). Per layer:
//   LN(eps 1e-5) -> qkv (+bias) -> attention over cache rows < length plus
//   the token's own K/V -> proj (+bias) -> residual -> LN -> fc (+bias) ->
//   exact-erf GELU -> fc2 (+bias) -> residual.
// The residual stays f32 across all layers and is cast to x's dtype at the
// end. The new K/V rows are written IN PLACE at row `length` of the caches.
// Weights are [L, in, out], bf16 or int8 (w8a16: the [L, 1, out] f32 scale
// multiplies the f32 dot output before the bias). The caches are bf16, or
// int8 codes with fixed [L, 1, E] f32 scales (the int8-KV mode of
// _chunk_math: q * k_scale rounds to bf16 before it meets the codes, the AV
// sum is multiplied by v_scale, the token's own K/V terms stay float, and
// the new row is written as rintf(k / k_scale) clamped to +-127, rounding
// half to even as jnp.round does).
//
// What bounds it on an H100: decode at small batch moves every weight byte
// (85 MB of int8 at GPT-2 124M) and every live cache row once a token for a
// few operations a byte: bytes, and at these sizes how many bytes are in
// flight and how often the whole card waits. The design is the persistent
// step of decode_common.cuh (shared with K5): one cooperative launch a
// token, 7 or 8 phases a layer behind grid barriers, a producer warp a CTA
// that streams the weight tiles and cache rows by TMA through the barriers,
// and wgmma products with the weight as M and the batch rows as N.

#include "decode_common.cuh"

template <typename WT, typename CT>
__global__ void __launch_bounds__(fk::decode::THREADS, 2)
    gpt2_decode_step(const __grid_constant__ fk::decode::Params p,
                     const __grid_constant__ fk::decode::Maps m) {
  fk::decode::decode_body<WT, CT, false>(p, m);
}

namespace {

using fk::decode::Params;

// The shapes of a GPT-2 step; the pointers are set by the entry point.
Params gpt2_params(int L, int B, int S, int E, int H, int length, int ring,
                   int n_chunk, int items) {
  Params p{};
  p.L = L;
  p.B = B;
  p.S = S;
  p.E = E;
  p.EKV = E;
  p.KV = H;
  p.D = E / H;
  p.R = 1;
  p.F = 4 * E;
  p.length = length;
  p.ring = ring;
  p.n_chunk = n_chunk;
  p.eps = 1e-5f;
  p.att_scale = 1.f / sqrtf(float(E / H));
  const int K[4] = {E, E, E, 4 * E}, N[4] = {3 * E, E, 4 * E, E};
  for (int q = 0; q < 4; ++q) {
    p.K[q] = K[q];
    p.N[q] = N[q];
    p.nseg[q] = 1;
    p.seg_n[q][0] = N[q];
    p.map_of[q][0] = q;
  }
  fk::decode::plan(p, items);
  return p;
}

bool shape_ok(int L, int B, int S, int E, int H, int length, int kv_int8) {
  if (L < 1 || B < 1 || H < 1 || E % H != 0) return false;
  const int D = E / H;
  return E % fk::decode::KT == 0 && D * (kv_int8 ? 1 : 2) % 16 == 0 &&
         D <= 128 && length >= 0 && length < S;
}

template <typename WT, typename CT>
auto kernel_of() {
  return gpt2_decode_step<WT, CT>;
}

// The kernel instance of a mode.
template <typename F>
int with_kernel(int w_int8, int kv_int8, F&& f) {
  if (kv_int8)
    return w_int8 ? f(kernel_of<int8_t, int8_t>())
                  : f(kernel_of<fk::bf16, int8_t>());
  return w_int8 ? f(kernel_of<int8_t, fk::bf16>())
                : f(kernel_of<fk::bf16, fk::bf16>());
}

}  // namespace

// Bytes of workspace fk_fused_decode_blocks needs (x_res, h, hh, the split-K
// partials and the score rows) for these shapes and knobs.
extern "C" long long fk_fused_decode_workspace_bytes(int L, int B, int S,
                                                     int E, int H, int items,
                                                     int n_chunk,
                                                     int ctas_per_sm) {
  if (!shape_ok(L, B, S, E, H, 0, 0) ||
      !fk::decode::knobs_ok(ctas_per_sm, 1, items, n_chunk))
    return -1;
  Params p = gpt2_params(L, B, S, E, H, 0, 1, n_chunk, items);
  return static_cast<long long>(fk::decode::workspace(
      p, ctas_per_sm * fk::decode::sm_count(), nullptr));
}

// All pointers are device pointers checked by the Python wrapper
// (ops/cuda/fused_decode.py): bf16 x [B, E]; the workspace of
// fk_fused_decode_workspace_bytes; the grid barrier (64 u32, zero before a
// stream's first call, left ready for the next); stamps null, or [grid,
// STAMPS] u64 that receive each CTA's ns split (decode_common.cuh); f32
// LN params and biases [L, D]; weights [L, in, out] bf16, or int8
// (w_int8 = 1) with f32 scales [L, 1, out]; caches [L, B, S, E] bf16, or int8
// codes (kv_int8 = 1) with f32 scales k_scale / v_scale [L, 1, E].
// E % 128 == 0, head_dim * cache bytes a multiple of 16 and head_dim <= 128,
// 0 <= length < S. Knobs (fused_decode.TUNING): CTAs an SM, ring slots,
// the work-item target of the depth splits, the N chunk.
extern "C" int fk_fused_decode_blocks(
    const void* x_in, void* x_out, void* workspace, void* barrier,
    void* stamps, const void* ln1_w, const void* ln1_b, const void* qkv_w,
    const void* qkv_b, const void* proj_w, const void* proj_b,
    const void* ln2_w, const void* ln2_b, const void* fc_w, const void* fc_b,
    const void* fc2_w, const void* fc2_b, const void* qkv_s,
    const void* proj_s, const void* fc_s, const void* fc2_s, void* k_cache,
    void* v_cache, const void* k_scale, const void* v_scale, int L, int B,
    int S, int E, int H, int length, int w_int8, int kv_int8,
    int ctas_per_sm, int ring, int items, int n_chunk, void* stream) {
  if (!shape_ok(L, B, S, E, H, length, kv_int8) ||
      !fk::decode::knobs_ok(ctas_per_sm, ring, items, n_chunk) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return int(cudaErrorInvalidValue);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  Params p = gpt2_params(L, B, S, E, H, length, ring, n_chunk, items);
  fk::decode::workspace(p, ctas_per_sm * fk::decode::sm_count(), workspace);
  p.x_in = static_cast<const fk::bf16*>(x_in);
  p.x_out = static_cast<fk::bf16*>(x_out);
  p.norm1_w = f(ln1_w);
  p.norm1_b = f(ln1_b);
  p.norm2_w = f(ln2_w);
  p.norm2_b = f(ln2_b);
  const float* bias[4] = {f(qkv_b), f(proj_b), f(fc_b), f(fc2_b)};
  const float* scale[4] = {f(qkv_s), f(proj_s), f(fc_s), f(fc2_s)};
  const void* w[4] = {qkv_w, proj_w, fc_w, fc2_w};
  fk::decode::Maps m{};
  for (int q = 0; q < 4; ++q) {
    p.bias[q] = bias[q];
    p.scale[q][0] = w_int8 ? scale[q] : nullptr;
    if (!fk::decode::weight_map(&m.w[q], w[q], L * p.K[q], p.N[q], w_int8))
      return int(cudaErrorInvalidValue);
  }
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = kv_int8 ? f(k_scale) : nullptr;
  p.v_scale = kv_int8 ? f(v_scale) : nullptr;
  if (!fk::decode::cache_map(&m.kc, k_cache, L * B, S, E, p.D, kv_int8) ||
      !fk::decode::cache_map(&m.vc, v_cache, L * B, S, E, p.D, kv_int8))
    return int(cudaErrorInvalidValue);
  p.cache_bytes = kv_int8 ? 1 : 2;
  p.bar = static_cast<unsigned*>(barrier);
  p.stamps = static_cast<unsigned long long*>(stamps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kernel(w_int8, kv_int8, [&](auto kernel) {
    return fk::decode::launch(kernel, p, m, ctas_per_sm, st);
  });
}

// The launch of a mode at these shapes and knobs (fk::decode::describe's
// twelve values into out); 0 or a CUDA error.
extern "C" int fk_fused_decode_info(int L, int B, int S, int E, int H,
                                    int w_int8, int kv_int8, int ctas_per_sm,
                                    int ring, int items, int n_chunk,
                                    int* out) {
  if (!shape_ok(L, B, S, E, H, 0, kv_int8) ||
      !fk::decode::knobs_ok(ctas_per_sm, ring, items, n_chunk))
    return int(cudaErrorInvalidValue);
  Params p = gpt2_params(L, B, S, E, H, 0, ring, n_chunk, items);
  p.cache_bytes = kv_int8 ? 1 : 2;
  return with_kernel(w_int8, kv_int8, [&](auto kernel) {
    return fk::decode::describe(kernel, p, ctas_per_sm, out);
  });
}
