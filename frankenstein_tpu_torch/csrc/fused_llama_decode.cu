// K5: one LLaMA token through all L transformer blocks.
//
// Replaces frankenstein_tpu/ops/pallas/fused_llama_decode.py:
// fused_llama_decode_blocks (the grid kernel _kernel), the manually
// pipelined _fused_llama_decode_pipelined and the big-model
// _fused_llama_decode_bigmodel. Those are three TPU schedules of one
// computation (_layer_math = _attn_math + _mlp_math), chosen by VMEM budget;
// here one kernel family takes every geometry. Per layer:
//   f32 RMSNorm -> q, k, v products -> RoPE of the new q row (E lanes) and k
//   row (E_kv lanes) in f32 with the folded cos/sin rows of position
//   `length` -> GQA attention, q head h reading KV head h / (H / KV) of the
//   UNEXPANDED [L, B, S, E_kv] cache over rows < length plus the token's own
//   k and v -> o_proj + residual -> f32 RMSNorm -> silu(g) * u -> down_proj
//   + residual.
// The residual stays f32 across all layers and is cast to x's dtype at the
// end; the new K/V rows are written IN PLACE at row `length`. The compute
// dtype is bf16 (bf16 or w8a16 weights with a bf16 or int8 cache). JAX's
// rounding points are kept: the normalised rows round to bf16 before each
// product; q (times k_scale for an int8 cache) rounds to bf16 before it
// meets the cache, and each q * k product rounds to bf16 before the f32
// score sum; the probabilities round to bf16 before the f32 AV sum of their
// exact products with v; the token's own score and value term stay f32;
// silu(g) * u rounds to bf16 before down_proj. w8a16: int8 weights
// with [L, 1, out] f32 scales applied to each f32 product. int8 KV: codes
// with fixed [L, 1, E_kv] f32 scales; the AV sum is multiplied by v_scale
// and the new rows are written as rintf(k / k_scale) clamped to +-127
// (round half to even, as jnp.round).
//
// What bounds it on an H100: one decode token moves every weight byte (93 MB
// of int8 at the FrankyLlama width) and every live cache row once, for about
// 2 * B operations a weight: bytes, at every batch a beam search uses. The
// design is K2's persistent step (decode_common.cuh): one cooperative
// launch a token, TMA weight and cache streams through the grid barriers,
// wgmma products. q|k|v and gate|up are each one product over side-by-side
// weight segments (a map each); an attention item is (batch row, KV head)
// and reads each live cache row of the KV head ONCE for its R = H / KV
// query heads (the point of the unexpanded cache).

#include "decode_common.cuh"

template <typename WT, typename CT>
__global__ void __launch_bounds__(fk::decode::THREADS, 2)
    llama_decode_step(const __grid_constant__ fk::decode::Params p,
                      const __grid_constant__ fk::decode::Maps m) {
  fk::decode::decode_body<WT, CT, true>(p, m);
}

namespace {

using fk::decode::Params;

// The shapes of a LLaMA step; the pointers are set by the entry point.
Params llama_params(int L, int B, int S, int E, int H, int KV, int F,
                    int length, float eps, int ring, int n_chunk, int items) {
  Params p{};
  const int D = E / H, EKV = KV * D;
  p.L = L;
  p.B = B;
  p.S = S;
  p.E = E;
  p.EKV = EKV;
  p.KV = KV;
  p.D = D;
  p.R = H / KV;
  p.F = F;
  p.length = length;
  p.ring = ring;
  p.n_chunk = n_chunk;
  p.eps = eps;
  p.att_scale = 1.f / sqrtf(float(D));
  p.llama = 1;
  const int K[4] = {E, E, E, F}, N[4] = {E + 2 * EKV, E, 2 * F, E};
  const int segs[4][3] = {{E, EKV, EKV}, {E, 0, 0}, {F, F, 0}, {E, 0, 0}};
  const int nseg[4] = {3, 1, 2, 1};
  int map = 0;
  for (int q = 0; q < 4; ++q) {
    p.K[q] = K[q];
    p.N[q] = N[q];
    p.nseg[q] = nseg[q];
    for (int s = 0; s < nseg[q]; ++s) {
      p.seg_n[q][s] = segs[q][s];
      p.map_of[q][s] = map++;
    }
  }
  fk::decode::plan(p, items);
  return p;
}

bool shape_ok(int L, int B, int S, int E, int H, int KV, int F, int length,
              int kv_int8) {
  if (L < 1 || B < 1 || H <= 0 || KV <= 0 || H % KV != 0 || E % H != 0)
    return false;
  const int D = E / H;
  return E % fk::decode::KT == 0 && F % fk::decode::KT == 0 &&
         (KV * D) % fk::decode::TILE_M == 0 &&
         D * (kv_int8 ? 1 : 2) % 16 == 0 && D <= 128 && length >= 0 &&
         length < S;
}

template <typename WT, typename CT>
auto kernel_of() {
  return llama_decode_step<WT, CT>;
}

template <typename Fn>
int with_kernel(int w_int8, int kv_int8, Fn&& f) {
  if (kv_int8)
    return w_int8 ? f(kernel_of<int8_t, int8_t>())
                  : f(kernel_of<fk::bf16, int8_t>());
  return w_int8 ? f(kernel_of<int8_t, fk::bf16>())
                : f(kernel_of<fk::bf16, fk::bf16>());
}

}  // namespace

// Bytes of workspace fk_fused_llama_decode_blocks needs for these shapes
// and knobs.
extern "C" long long fk_fused_llama_decode_workspace_bytes(
    int L, int B, int S, int E, int H, int KV, int F, int items, int n_chunk,
    int ctas_per_sm) {
  if (!shape_ok(L, B, S, E, H, KV, F, 0, 0) ||
      !fk::decode::knobs_ok(ctas_per_sm, 1, items, n_chunk))
    return -1;
  Params p = llama_params(L, B, S, E, H, KV, F, 0, 0.f, 1, n_chunk, items);
  return static_cast<long long>(fk::decode::workspace(
      p, ctas_per_sm * fk::decode::sm_count(), nullptr));
}

// Bytes of the attention working set of one (batch row, KV head) item:
// q, the cache-side q and o (R * D f32 each), the own k and v, the R * S
// scores and their own terms, and one tile of ATT_ROWS cache rows. The
// kernel keeps the scores in shared memory where they fit beside a ring of
// one slot a warp, else in global memory; the wrapper's gate takes the
// shapes whose working set fits in 227 KB.
extern "C" long long fk_fused_llama_decode_smem_bytes(int D, int R, int S,
                                                      int cache_bytes) {
  return static_cast<long long>((3 * R * D + 2 * D + R * S + 2 * R + 3) & ~3) *
             4 +
         static_cast<long long>(fk::decode::ATT_ROWS) * D * cache_bytes;
}

// All pointers are device pointers checked by the Python wrapper
// (ops/cuda/fused_llama_decode.py): bf16 x [B, E]; the workspace of
// fk_fused_llama_decode_workspace_bytes; the grid barrier and stamps as
// fk_fused_decode_blocks'; f32 cos/sin rows [1, E]; f32 norm weights
// [L, E]; weights [L, in, out] bf16, or int8 (w_int8 = 1) with f32 scales
// [L, 1, out]; caches [L, B, S, E_kv] bf16, or int8 codes (kv_int8 = 1)
// with f32 scales [L, 1, E_kv]. E, F multiples of 128, E_kv of 64,
// head_dim * cache bytes a multiple of 16 and head_dim <= 128, H % KV == 0,
// 0 <= length < S.
extern "C" int fk_fused_llama_decode_blocks(
    const void* x_in, void* x_out, void* workspace, void* barrier,
    void* stamps, const void* cos, const void* sin, const void* norm1_w,
    const void* norm2_w, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* wg, const void* wu, const void* wd,
    const void* sq, const void* sk, const void* sv, const void* so,
    const void* sg, const void* su, const void* sd, void* k_cache,
    void* v_cache, const void* k_scale, const void* v_scale, int L, int B,
    int S, int E, int H, int KV, int F, int length, float eps, int w_int8,
    int kv_int8, int ctas_per_sm, int ring, int items, int n_chunk,
    void* stream) {
  if (!shape_ok(L, B, S, E, H, KV, F, length, kv_int8) ||
      !fk::decode::knobs_ok(ctas_per_sm, ring, items, n_chunk) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return int(cudaErrorInvalidValue);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  Params p = llama_params(L, B, S, E, H, KV, F, length, eps, ring, n_chunk,
                          items);
  fk::decode::workspace(p, ctas_per_sm * fk::decode::sm_count(), workspace);
  p.x_in = static_cast<const fk::bf16*>(x_in);
  p.x_out = static_cast<fk::bf16*>(x_out);
  p.norm1_w = f(norm1_w);
  p.norm2_w = f(norm2_w);
  p.cos = f(cos);
  p.sin = f(sin);
  const void* w[7] = {wq, wk, wv, wo, wg, wu, wd};
  const float* scale[7] = {f(sq), f(sk), f(sv), f(so), f(sg), f(su), f(sd)};
  fk::decode::Maps m{};
  for (int q = 0; q < 4; ++q)
    for (int s = 0; s < p.nseg[q]; ++s) {
      const int i = p.map_of[q][s];
      p.scale[q][s] = w_int8 ? scale[i] : nullptr;
      if (!fk::decode::weight_map(&m.w[i], w[i], L * p.K[q], p.seg_n[q][s],
                                  w_int8))
        return int(cudaErrorInvalidValue);
    }
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = kv_int8 ? f(k_scale) : nullptr;
  p.v_scale = kv_int8 ? f(v_scale) : nullptr;
  if (!fk::decode::cache_map(&m.kc, k_cache, L * B, S, p.EKV, p.D,
                             kv_int8) ||
      !fk::decode::cache_map(&m.vc, v_cache, L * B, S, p.EKV, p.D, kv_int8))
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
extern "C" int fk_fused_llama_decode_info(int L, int B, int S, int E, int H,
                                          int KV, int F, int w_int8,
                                          int kv_int8, int ctas_per_sm,
                                          int ring, int items, int n_chunk,
                                          int* out) {
  if (!shape_ok(L, B, S, E, H, KV, F, 0, kv_int8) ||
      !fk::decode::knobs_ok(ctas_per_sm, ring, items, n_chunk))
    return int(cudaErrorInvalidValue);
  Params p = llama_params(L, B, S, E, H, KV, F, 0, 1e-5f, ring, n_chunk,
                          items);
  p.cache_bytes = kv_int8 ? 1 : 2;
  return with_kernel(w_int8, kv_int8, [&](auto kernel) {
    return fk::decode::describe(kernel, p, ctas_per_sm, out);
  });
}
