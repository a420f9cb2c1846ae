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
// 2 * B FLOPs per weight: bytes, at every batch a beam search uses. The
// design, from K2's pieces (decode_common.cuh):
//   * q/k/v and gate/up each run as ONE split-K launch over the side-by-side
//     weights, so a few hundred CTAs stream disjoint weight tiles at once;
//     int8 weights stream as int8 and widen exactly to bf16 in shared
//     memory;
//   * fixed-order finalize passes (deterministic) apply the w8 scales and
//     fold in the residual, both RMSNorms and silu(g) * u, so no activation
//     makes an extra round trip;
//   * one attention CTA per (batch row, KV head) finalizes that head's H/KV
//     query heads and its new k, v, rotates them, streams each live cache
//     row of the KV head ONCE for all H/KV queries (the point of the
//     unexpanded cache: half the bytes of an expanded one at 16q / 8kv),
//     and writes the new row.
// The host loop below issues 8 launches per layer. One persistent launch
// per token, and wgmma, are later work.

#include "decode_common.cuh"

namespace {

// rms_f32: x * rsqrt(mean(x^2) + eps) * w, all f32, rounded to bf16 into
// out. xr is one f32 row (shared or global). Called by a whole block.
__device__ void rms_row(const float* xr, const float* __restrict__ w,
                        bf16* __restrict__ out, int E, float eps) {
  float sq = 0.f;
  for (int i = threadIdx.x; i < E; i += blockDim.x) sq += xr[i] * xr[i];
  const float r = rsqrtf(block_sum(sq) / E + eps);
  for (int i = threadIdx.x; i < E; i += blockDim.x)
    out[i] = __float2bfloat16(xr[i] * r * w[i]);
}

// x_res = float(x_in) and h = rms(x_res) with layer 0's norm1; one
// block per row.
__global__ void __launch_bounds__(ROW_THREADS)
llama_start_rows(const bf16* __restrict__ x_in, float* __restrict__ x_res,
                 const float* __restrict__ w, bf16* __restrict__ h, int E,
                 float eps) {
  const size_t r = size_t(blockIdx.x) * E;
  for (int i = threadIdx.x; i < E; i += blockDim.x)
    x_res[r + i] = __bfloat162float(x_in[r + i]);
  __syncthreads();
  rms_row(x_res + r, w, h + r, E, eps);
}

// x_res += y for y the finalized product, then either the next RMSNorm
// (norm_w != null) into h, or the output cast into x_out.
__global__ void __launch_bounds__(ROW_THREADS)
llama_residual_rows(const float* __restrict__ part, int splits,
                    const float* __restrict__ scale,
                    float* __restrict__ x_res,
                    const float* __restrict__ norm_w, bf16* __restrict__ h,
                    bf16* __restrict__ x_out, int B, int E, float eps) {
  const size_t r = size_t(blockIdx.x) * E;
  const size_t plane = size_t(B) * E;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const float x = x_res[r + i] + finalize(part, splits, plane, r + i,
                                            scale, i);
    x_res[r + i] = x;
    if (norm_w == nullptr) x_out[r + i] = __float2bfloat16(x);
  }
  if (norm_w == nullptr) return;
  __syncthreads();
  rms_row(x_res + r, norm_w, h + r, E, eps);
}

// act = bf16(g * sigmoid(g) * u) over [B, F]; g and u are the columns
// [0, F) and [F, 2F) of the gate/up partial.
__global__ void llama_swiglu_rows(const float* __restrict__ part, int splits,
                                  const float* __restrict__ g_scale,
                                  const float* __restrict__ u_scale,
                                  bf16* __restrict__ act, int B, int F) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size_t(B) * F) return;
  const int col = int(i % F);
  const size_t row = i / F;
  const size_t plane = size_t(B) * 2 * F;
  const float g = finalize(part, splits, plane, row * 2 * F + col, g_scale,
                           col);
  const float u = finalize(part, splits, plane, row * 2 * F + F + col,
                           u_scale, col);
  act[i] = __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
}

// RoPE of adjacent pairs, as the JAX _rot_row computes it in f32:
// out[2i] = x[2i] c - x[2i+1] s, out[2i+1] = x[2i+1] c + x[2i] s, each
// product and the sum rounded once (no FMA contraction).
__device__ __forceinline__ float rotate(const float* x, int i, float c,
                                        float s) {
  const float partner = (i & 1) ? x[i - 1] : -x[i + 1];
  return __fadd_rn(__fmul_rn(x[i], c), __fmul_rn(partner, s));
}

// Attention of one (KV head g, batch row b): its R = H / KV query heads
// h = g * R + r, over cache rows < length plus the token's own k and v,
// then the new rows at row `length`. part is the [splits, B, E + 2 E_kv]
// q|k|v partial. Shared memory (llama_attention_smem_bytes): f32 q (R*D,
// rotated), qc (R*D, scaled and bf16-rounded), k, v (D each, k rotated), o
// (R*D), scores (R*S), own score and own weight (R each); then ATTN_ROWS
// cache rows of D lanes, 16-byte aligned.
template <typename CT>
__global__ void __launch_bounds__(ATTN_THREADS)
llama_attention(const float* __restrict__ part, int splits,
                const float* __restrict__ sq_w, const float* __restrict__ sk_w,
                const float* __restrict__ sv_w, const float* __restrict__ cos,
                const float* __restrict__ sin, CT* __restrict__ kc,
                CT* __restrict__ vc, const float* __restrict__ ks,
                const float* __restrict__ vs, bf16* __restrict__ o_out,
                int B, int S, int E, int EKV, int D, int R, int length,
                float att_scale) {
  extern __shared__ float smem[];
  const int RD = R * D;
  float* sq = smem;
  float* sqc = sq + RD;
  float* sk = sqc + RD;
  float* sv = sk + D;
  float* so = sv + D;
  float* sp = so + RD;
  float* s_own = sp + R * S;
  float* w_own = s_own + R;
  CT* rows = reinterpret_cast<CT*>(smem + ((3 * RD + 2 * D + R * S + 2 * R
                                            + 3) & ~3));
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int qcol = g * RD, kcol = g * D;
  const int N = E + 2 * EKV;
  const size_t plane = size_t(B) * N, row = size_t(b) * N;

  // raw q into so and raw k into sqc (scratch), v straight into sv
  for (int i = tid; i < RD; i += blockDim.x)
    so[i] = finalize(part, splits, plane, row + qcol + i, sq_w, qcol + i);
  for (int i = tid; i < D; i += blockDim.x) {
    sqc[i] = finalize(part, splits, plane, row + E + kcol + i, sk_w,
                      kcol + i);
    sv[i] = finalize(part, splits, plane, row + E + EKV + kcol + i, sv_w,
                     kcol + i);
  }
  __syncthreads();
  for (int i = tid; i < RD; i += blockDim.x)
    sq[i] = rotate(so, i, cos[qcol + i], sin[qcol + i]);
  for (int i = tid; i < D; i += blockDim.x)
    sk[i] = rotate(sqc, i, cos[kcol + i], sin[kcol + i]);
  __syncthreads();
  for (int i = tid; i < RD; i += blockDim.x) {
    const int d = i % D;
    sqc[i] = round_bf16(ks == nullptr ? sq[i] : sq[i] * ks[kcol + d]);
    so[i] = 0.f;
  }
  for (int r = warp; r < R; r += nwarps) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += sq[r * D + d] * sk[d];
    acc = warp_sum(acc);
    if (lane == 0) s_own[r] = acc * att_scale;
  }
  CT* kb = kc + size_t(b) * S * EKV + kcol;
  CT* vb = vc + size_t(b) * S * EKV + kcol;

  // scores: each staged k row is read once for all R query heads
  for (int j0 = 0; j0 < length; j0 += ATTN_ROWS) {
    const int n = min(ATTN_ROWS, length - j0);
    __syncthreads();   // qc written / previous chunk consumed
    stage_rows(kb + size_t(j0) * EKV, rows, n, D, EKV);
    __syncthreads();
    for (int t = warp; t < n * R; t += nwarps) {
      const int j = t / R, r = t % R;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32)
        acc += round_bf16(sqc[r * D + d] * widen(rows[j * D + d]));
      acc = warp_sum(acc);
      if (lane == 0) sp[r * S + j0 + j] = acc * att_scale;
    }
  }
  __syncthreads();
  for (int r = warp; r < R; r += nwarps) {
    float* p = sp + r * S;
    float mx = s_own[r];
    for (int j = lane; j < length; j += 32) mx = fmaxf(mx, p[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < length; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float p_own = expf(s_own[r] - mx);
    const float denom = sum + p_own;
    for (int j = lane; j < length; j += 32) p[j] = round_bf16(p[j] / denom);
    if (lane == 0) w_own[r] = p_own / denom;
  }
  // o[r, d] = sum_j p[r, j] v[j, d] in f32: each output has one owner, which
  // sums the staged chunks in row order; each v row is read once for all R
  for (int j0 = 0; j0 < length; j0 += ATTN_ROWS) {
    const int n = min(ATTN_ROWS, length - j0);
    __syncthreads();   // probabilities ready / previous chunk consumed
    stage_rows(vb + size_t(j0) * EKV, rows, n, D, EKV);
    __syncthreads();
    for (int i = tid; i < RD; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const float* p = sp + r * S + j0;
      float acc = so[i];
      for (int j = 0; j < n; ++j)
        acc += p[j] * widen(rows[j * D + d]);
      so[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < RD; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float o = so[i];
    if (vs != nullptr) o *= vs[kcol + d];
    o += w_own[r] * sv[d];
    o_out[size_t(b) * E + qcol + i] = __float2bfloat16(o);
  }
  for (int d = tid; d < D; d += blockDim.x) {
    put(kb + size_t(length) * EKV + d, sk[d],
        ks == nullptr ? 1.f : ks[kcol + d]);
    put(vb + size_t(length) * EKV + d, sv[d],
        vs == nullptr ? 1.f : vs[kcol + d]);
  }
}

size_t llama_attention_smem_bytes(int D, int R, int S, int cache_bytes) {
  return size_t((3 * R * D + 2 * D + R * S + 2 * R + 3) & ~3) * sizeof(float)
         + size_t(ATTN_ROWS) * D * cache_bytes;
}

constexpr size_t MAX_SMEM = 227 * 1024;   // an H100 block's opt-in limit

size_t llama_workspace_floats(int B, int E, int EKV, int F) {
  const int shapes[4][2] = {{E, E + 2 * EKV}, {E, E}, {E, 2 * F}, {F, E}};
  size_t most = 0;
  for (const auto& kn : shapes) {
    const size_t n = size_t(splits_for(B, kn[0], kn[1])) * B * kn[1];
    if (n > most) most = n;
  }
  return most;
}

struct LlamaWeights {
  const float *norm1, *norm2;
  const void *wq, *wk, *wv, *wo, *wg, *wu, *wd;
  const float *sq, *sk, *sv, *so, *sg, *su, *sd;   // null unless w8a16
};

template <typename WT, typename CT>
cudaError_t run_llama_layers(const bf16* x_in, bf16* x_out, float* x_res,
                             bf16* hbuf, bf16* act, float* part,
                             const float* cos, const float* sin,
                             const LlamaWeights& w, CT* k_cache, CT* v_cache,
                             const float* k_scale, const float* v_scale,
                             int L, int B, int S, int E, int H, int KV, int F,
                             int length, float eps, cudaStream_t st) {
  const int D = E / H, R = H / KV, EKV = KV * D;
  const float att_scale = 1.f / sqrtf(float(D));
  const size_t cache_layer = size_t(B) * S * EKV;
  const int s_qkv = splits_for(B, E, E + 2 * EKV);
  const int s_o = splits_for(B, E, E), s_gu = splits_for(B, E, 2 * F);
  const int s_d = splits_for(B, F, E);
  const size_t smem = llama_attention_smem_bytes(D, R, S, sizeof(CT));
  if (smem > 48 * 1024)
    FK_TRY(cudaFuncSetAttribute(llama_attention<CT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(smem)));
  auto at = [](const float* p, size_t off) {
    return p == nullptr ? nullptr : p + off;
  };
  const WT* wq = static_cast<const WT*>(w.wq);
  const WT* wk = static_cast<const WT*>(w.wk);
  const WT* wv = static_cast<const WT*>(w.wv);
  const WT* wg = static_cast<const WT*>(w.wg);
  const WT* wu = static_cast<const WT*>(w.wu);
  llama_start_rows<<<B, ROW_THREADS, 0, st>>>(x_in, x_res, w.norm1, hbuf, E,
                                              eps);
  FK_TRY(cudaGetLastError());
  for (int l = 0; l < L; ++l) {
    const size_t le = size_t(l) * E, lkv = size_t(l) * EKV;
    const size_t lf = size_t(l) * F;
    const GemmSegs qkv{{wq + le * E, wk + le * EKV, wv + le * EKV},
                       {E, EKV, EKV}, 3};
    FK_TRY(gemm_segs<WT>(hbuf, qkv, part, s_qkv, B, E, st));
    llama_attention<CT><<<dim3(KV, B), ATTN_THREADS, smem, st>>>(
        part, s_qkv, at(w.sq, le), at(w.sk, lkv), at(w.sv, lkv), cos, sin,
        k_cache + l * cache_layer, v_cache + l * cache_layer,
        at(k_scale, lkv), at(v_scale, lkv), hbuf, B, S, E, EKV, D, R, length,
        att_scale);
    FK_TRY(cudaGetLastError());
    FK_TRY(gemm<WT>(hbuf, w.wo, le * E, part, s_o, B, E, E, st));
    llama_residual_rows<<<B, ROW_THREADS, 0, st>>>(
        part, s_o, at(w.so, le), x_res, w.norm2 + le, hbuf, nullptr, B, E,
        eps);
    FK_TRY(cudaGetLastError());
    const GemmSegs gu{{wg + le * F, wu + le * F, nullptr}, {F, F, 0}, 2};
    FK_TRY(gemm_segs<WT>(hbuf, gu, part, s_gu, B, E, st));
    const int n_act = B * F;
    llama_swiglu_rows<<<(n_act + 255) / 256, 256, 0, st>>>(
        part, s_gu, at(w.sg, lf), at(w.su, lf), act, B, F);
    FK_TRY(cudaGetLastError());
    FK_TRY(gemm<WT>(act, w.wd, lf * E, part, s_d, B, F, E, st));
    const bool last = l == L - 1;
    llama_residual_rows<<<B, ROW_THREADS, 0, st>>>(
        part, s_d, at(w.sd, le), x_res, last ? nullptr : w.norm1 + le + E,
        hbuf, x_out, B, E, eps);
    FK_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace

// Bytes of f32 workspace fk_fused_llama_decode_blocks needs.
extern "C" long long fk_fused_llama_decode_workspace_bytes(int B, int E,
                                                           int EKV, int F) {
  return static_cast<long long>(llama_workspace_floats(B, E, EKV, F) *
                                sizeof(float));
}

// Bytes of dynamic shared memory one attention CTA needs (at most 227 KB).
extern "C" long long fk_fused_llama_decode_smem_bytes(int D, int R, int S,
                                                      int cache_bytes) {
  return static_cast<long long>(
      llama_attention_smem_bytes(D, R, S, cache_bytes));
}

// All pointers are device pointers checked by the Python wrapper
// (ops/cuda/fused_llama_decode.py): bf16 x [B, E]; scratch f32 x_res
// [B, E], bf16 hbuf [B, E] and act [B, F], f32 workspace of
// fk_fused_llama_decode_workspace_bytes; f32 cos/sin rows [1, E]; f32 norm
// weights [L, E]; weights [L, in, out] bf16, or int8 (w_int8 = 1) with f32
// scales [L, 1, out]; caches [L, B, S, E_kv] bf16, or int8 codes
// (kv_int8 = 1) with f32 scales [L, 1, E_kv]. E, F multiples of 128, E_kv
// of 64, head_dim * cache bytes a multiple of 16 and head_dim <= 128,
// H % KV == 0, 0 <= length < S.
extern "C" int fk_fused_llama_decode_blocks(
    const void* x_in, void* x_out, void* x_res, void* hbuf, void* act,
    void* workspace, const void* cos, const void* sin, const void* norm1_w,
    const void* norm2_w, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* wg, const void* wu, const void* wd,
    const void* sq, const void* sk, const void* sv, const void* so,
    const void* sg, const void* su, const void* sd, void* k_cache,
    void* v_cache, const void* k_scale, const void* v_scale, int L, int B,
    int S, int E, int H, int KV, int F, int length, float eps, int w_int8,
    int kv_int8, void* stream) {
  const int cache_bytes = kv_int8 ? 1 : 2;
  if (H <= 0 || KV <= 0 || H % KV != 0 || E % H != 0)
    return int(cudaErrorInvalidValue);
  const int D = E / H;
  if (E % GEMM_BK != 0 || F % GEMM_BK != 0 || (KV * D) % GEMM_BN != 0 ||
      D * cache_bytes % 16 != 0 || D > 128 || length < 0 || length >= S ||
      llama_attention_smem_bytes(D, H / KV, S, cache_bytes) > MAX_SMEM ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return int(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const LlamaWeights w{f(norm1_w), f(norm2_w), wq,    wk,    wv,    wo,
                       wg,         wu,         wd,    f(sq), f(sk), f(sv),
                       f(so),      f(sg),      f(su), f(sd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto wtag, auto ctag) {
    using WT = decltype(wtag);
    using CT = decltype(ctag);
    return run_llama_layers<WT, CT>(
        static_cast<const bf16*>(x_in), static_cast<bf16*>(x_out),
        static_cast<float*>(x_res), static_cast<bf16*>(hbuf),
        static_cast<bf16*>(act), static_cast<float*>(workspace), f(cos),
        f(sin), w, static_cast<CT*>(k_cache), static_cast<CT*>(v_cache),
        kv_int8 ? f(k_scale) : nullptr, kv_int8 ? f(v_scale) : nullptr, L, B,
        S, E, H, KV, F, length, eps, st);
  };
  cudaError_t err;
  if (kv_int8)
    err = w_int8 ? run(int8_t{}, int8_t{}) : run(bf16{}, int8_t{});
  else
    err = w_int8 ? run(int8_t{}, bf16{}) : run(bf16{}, bf16{});
  return int(err);
}
