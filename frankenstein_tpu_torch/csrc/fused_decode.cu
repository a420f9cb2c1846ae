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
// and the whole KV cache once per token for a few FLOPs per byte, so it is
// bound by bytes, and at these sizes by how many bytes are in flight. The
// design:
//   * each [B, in] x [in, out] product is split over its depth (split-K)
//     so that a few hundred CTAs stream disjoint weight tiles at once; each
//     CTA reads its tile once per 32 batch rows, int8 weights as int8 (half
//     the bytes of bf16) widened exactly to bf16 in shared memory, and runs
//     nvcuda::wmma bf16 tiles with f32 accumulation into its own partial;
//   * one "finalize" pass per product sums the partials in a fixed order
//     (deterministic) and applies the w8 scale, bias, GELU or residual add;
//     the residual finalize also computes the next LayerNorm, and the
//     attention kernel finalizes q, k, v itself, so no activation makes an
//     extra round trip;
//   * one attention CTA per (batch, head) reads its cache rows once and
//     writes the new row in the same pass; an int8 cache moves half the
//     bytes of a bf16 one, and its codes widen exactly to float in
//     registers.
// The host loop below issues 8 launches per layer on the caller's stream.
// Fusing all layers into one persistent kernel, as the TPU kernel does, is
// later work.

#include "decode_common.cuh"

namespace {

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// LayerNorm of the f32 row held in xr (shared or global), rounded to bf16:
// ((x - mu) * rsqrt(var + eps)) * w + b. Called by a whole block.
__device__ void layer_norm_row(const float* xr, const float* __restrict__ w,
                               const float* __restrict__ b,
                               bf16* __restrict__ out, int E) {
  float s = 0.f;
  for (int i = threadIdx.x; i < E; i += blockDim.x) s += xr[i];
  const float mu = block_sum(s) / E;
  float sq = 0.f;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const float d = xr[i] - mu;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq) / E + 1e-5f);
  for (int i = threadIdx.x; i < E; i += blockDim.x)
    out[i] = __float2bfloat16((xr[i] - mu) * rstd * w[i] + b[i]);
}

// x_res = float(x_in) and h = LN(x_res) with layer 0's ln_1; one block/row.
__global__ void __launch_bounds__(ROW_THREADS)
start_rows(const bf16* __restrict__ x_in, float* __restrict__ x_res,
           const float* __restrict__ w, const float* __restrict__ b,
           bf16* __restrict__ h, int E) {
  const size_t r = size_t(blockIdx.x) * E;
  for (int i = threadIdx.x; i < E; i += blockDim.x)
    x_res[r + i] = __bfloat162float(x_in[r + i]);
  __syncthreads();
  layer_norm_row(x_res + r, w, b, h + r, E);
}

// x_res = (x_res + y) + bias for y the finalized product, then either the
// next LayerNorm (ln_w != null) into h, or the output cast into x_out.
__global__ void __launch_bounds__(ROW_THREADS)
residual_rows(const float* __restrict__ part, int splits,
              const float* __restrict__ scale, const float* __restrict__ bias,
              float* __restrict__ x_res, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, bf16* __restrict__ h,
              bf16* __restrict__ x_out, int B, int E) {
  const size_t r = size_t(blockIdx.x) * E;
  const size_t plane = size_t(B) * E;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const float y = finalize(part, splits, plane, r + i, scale, i);
    const float x = (x_res[r + i] + y) + bias[i];
    x_res[r + i] = x;
    if (ln_w == nullptr) x_out[r + i] = __float2bfloat16(x);
  }
  if (ln_w == nullptr) return;
  __syncthreads();
  layer_norm_row(x_res + r, ln_w, ln_b, h + r, E);
}

// hh = gelu(y + bias) rounded to bf16, elementwise over [B, N].
__global__ void gelu_rows(const float* __restrict__ part, int splits,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          bf16* __restrict__ hh, int B, int N) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size_t(B) * N) return;
  const int col = int(i % N);
  const float y = finalize(part, splits, size_t(B) * N, i, scale, col);
  hh[i] = __float2bfloat16(gelu_erf(y + bias[col]));
}

// Attention of one (head, batch row) over cache rows < length plus the
// token's own K/V, then the new rows are written at row `length`. q, k, v
// are finalized here from the qkv partials (f32). Cached-row scores take q
// (times k_scale for an int8 cache) rounded to bf16; the own score and
// own-value term stay f32; the probabilities round to bf16 before the AV
// sum (JAX's rounding points). Cache rows (CT = bf16 or int8 codes) are
// staged through shared memory ATTN_ROWS at a time with 16-byte loads, all
// issued before any is used. kc/vc point at this layer's [B, S, E] cache,
// ks/vs at its [E] scales (null for bf16); o is [B, E] bf16. Needs
// D * sizeof(CT) % 16 == 0 and D <= 128.
template <typename CT>
__global__ void __launch_bounds__(ATTN_THREADS)
decode_attention(const float* __restrict__ part, int splits,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, CT* __restrict__ kc,
                 CT* __restrict__ vc, const float* __restrict__ ks,
                 const float* __restrict__ vs, bf16* __restrict__ o, int B,
                 int S, int E, int D, int length, float att_scale) {
  // [4 * D] f32 q, k_new, v_new, bf16-rounded (scaled) q | [S] f32 scores
  // | [ATTN_ROWS * D] cache rows, 16-byte aligned (attention_smem_bytes)
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = smem + D;
  float* sv = smem + 2 * D;
  float* sqc = smem + 3 * D;
  float* sp = smem + 4 * D;
  CT* rows = reinterpret_cast<CT*>(smem + ((4 * D + S + 3) & ~3));
  __shared__ float s_own, w_own;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int col0 = h * D;
  const size_t plane = size_t(B) * 3 * E;
  for (int i = tid; i < 3 * D; i += blockDim.x) {
    const int col = (i / D) * E + col0 + i % D;
    smem[i] = finalize(part, splits, plane, size_t(b) * 3 * E + col, scale,
                       col) + bias[col];
  }
  __syncthreads();
  for (int i = tid; i < D; i += blockDim.x)
    sqc[i] = round_bf16(ks == nullptr ? sq[i] : sq[i] * ks[col0 + i]);
  CT* kb = kc + size_t(b) * S * E + col0;
  CT* vb = vc + size_t(b) * S * E + col0;

  for (int j0 = 0; j0 < length; j0 += ATTN_ROWS) {
    const int n = min(ATTN_ROWS, length - j0);
    __syncthreads();   // sqc written / previous chunk consumed
    stage_rows(kb + size_t(j0) * E, rows, n, D, E);
    __syncthreads();
    for (int j = warp; j < n; j += nwarps) {
      float acc = 0.f;
      for (int d = lane; d < D; d += 32)
        acc += sqc[d] * widen(rows[j * D + d]);
      acc = warp_sum(acc);
      if (lane == 0) sp[j0 + j] = acc * att_scale;
    }
  }
  if (warp == nwarps - 1) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += sq[d] * sk[d];
    acc = warp_sum(acc);
    if (lane == 0) s_own = acc * att_scale;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = s_own;
    for (int j = lane; j < length; j += 32) mx = fmaxf(mx, sp[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < length; j += 32) {
      const float e = expf(sp[j] - mx);
      sp[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float p_own = expf(s_own - mx);
    const float denom = sum + p_own;
    for (int j = lane; j < length; j += 32) sp[j] = round_bf16(sp[j] / denom);
    if (lane == 0) w_own = p_own / denom;
  }
  // o[d] = sum_j p_j v_j[d]: thread (d, part) sums rows part, part + P, ...
  // of each staged chunk; the P partial sums meet in shared memory.
  __shared__ float osum[ATTN_THREADS];
  const int parts = max(1, int(blockDim.x) / D);
  const int d = tid % D, pi = tid / D;
  float acc = 0.f;
  for (int j0 = 0; j0 < length; j0 += ATTN_ROWS) {
    const int n = min(ATTN_ROWS, length - j0);
    __syncthreads();   // probabilities ready / previous chunk consumed
    stage_rows(vb + size_t(j0) * E, rows, n, D, E);
    __syncthreads();
    if (pi < parts && d < D)
      for (int j = pi; j < n; j += parts)
        acc += sp[j0 + j] * widen(rows[j * D + d]);
  }
  __syncthreads();
  osum[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
    for (int q = 0; q < parts; ++q) total += osum[q * D + tid];
    if (vs != nullptr) total *= vs[col0 + tid];
    total += w_own * sv[tid];
    o[size_t(b) * E + col0 + tid] = __float2bfloat16(total);
    put(kb + size_t(length) * E + tid, sk[tid],
        ks == nullptr ? 1.f : ks[col0 + tid]);
    put(vb + size_t(length) * E + tid, sv[tid],
        vs == nullptr ? 1.f : vs[col0 + tid]);
  }
}

size_t attention_smem_bytes(int D, int S, int cache_bytes) {
  return size_t((4 * D + S + 3) & ~3) * sizeof(float) +
         size_t(ATTN_ROWS) * D * cache_bytes;
}

size_t workspace_floats(int B, int E) {
  size_t most = 0;
  const int shapes[4][2] = {{E, 3 * E}, {E, E}, {E, 4 * E}, {4 * E, E}};
  for (const auto& kn : shapes) {
    const size_t n = size_t(splits_for(B, kn[0], kn[1])) * B * kn[1];
    if (n > most) most = n;
  }
  return most;
}

struct Weights {
  const float *ln1_w, *ln1_b, *qkv_b, *proj_b, *ln2_w, *ln2_b, *fc_b, *fc2_b;
  const void *qkv_w, *proj_w, *fc_w, *fc2_w;
  const float *qkv_s, *proj_s, *fc_s, *fc2_s;   // null unless w8a16
};

template <typename WT, typename CT>
cudaError_t run_layers(const bf16* x_in, bf16* x_out, float* x_res,
                       bf16* hbuf, bf16* hh, float* part, const Weights& w,
                       CT* k_cache, CT* v_cache, const float* k_scale,
                       const float* v_scale, int L, int B, int S, int E,
                       int H, int length, cudaStream_t st) {
  const int D = E / H;
  const float att_scale = 1.f / sqrtf(float(D));
  const size_t cache_layer = size_t(B) * S * E;
  const int s_qkv = splits_for(B, E, 3 * E), s_proj = splits_for(B, E, E);
  const int s_fc = splits_for(B, E, 4 * E), s_fc2 = splits_for(B, 4 * E, E);
  auto at = [](const float* p, size_t off) {
    return p == nullptr ? nullptr : p + off;
  };
  start_rows<<<B, ROW_THREADS, 0, st>>>(x_in, x_res, w.ln1_w, w.ln1_b, hbuf,
                                        E);
  FK_TRY(cudaGetLastError());
  for (int l = 0; l < L; ++l) {
    const size_t e1 = size_t(l) * E, e3 = 3 * e1, e4 = 4 * e1;
    FK_TRY(gemm<WT>(hbuf, w.qkv_w, e1 * 3 * E, part, s_qkv, B, E, 3 * E, st));
    decode_attention<CT><<<dim3(H, B), ATTN_THREADS,
                           attention_smem_bytes(D, S, sizeof(CT)), st>>>(
        part, s_qkv, at(w.qkv_s, e3), w.qkv_b + e3,
        k_cache + l * cache_layer, v_cache + l * cache_layer,
        at(k_scale, e1), at(v_scale, e1), hbuf, B, S, E, D, length,
        att_scale);
    FK_TRY(cudaGetLastError());
    FK_TRY(gemm<WT>(hbuf, w.proj_w, e1 * E, part, s_proj, B, E, E, st));
    residual_rows<<<B, ROW_THREADS, 0, st>>>(
        part, s_proj, at(w.proj_s, e1), w.proj_b + e1, x_res, w.ln2_w + e1,
        w.ln2_b + e1, hbuf, nullptr, B, E);
    FK_TRY(cudaGetLastError());
    FK_TRY(gemm<WT>(hbuf, w.fc_w, e1 * 4 * E, part, s_fc, B, E, 4 * E, st));
    const int n_fc = B * 4 * E;
    gelu_rows<<<(n_fc + 255) / 256, 256, 0, st>>>(
        part, s_fc, at(w.fc_s, e4), w.fc_b + e4, hh, B, 4 * E);
    FK_TRY(cudaGetLastError());
    FK_TRY(gemm<WT>(hh, w.fc2_w, e4 * E, part, s_fc2, B, 4 * E, E, st));
    const bool last = l == L - 1;
    residual_rows<<<B, ROW_THREADS, 0, st>>>(
        part, s_fc2, at(w.fc2_s, e1), w.fc2_b + e1, x_res,
        last ? nullptr : w.ln1_w + e1 + E, last ? nullptr : w.ln1_b + e1 + E,
        hbuf, x_out, B, E);
    FK_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace

// Bytes of f32 workspace fk_fused_decode_blocks needs for batch B, width E.
extern "C" long long fk_fused_decode_workspace_bytes(int B, int E) {
  return static_cast<long long>(workspace_floats(B, E) * sizeof(float));
}

// All pointers are device pointers checked by the Python wrapper
// (ops/cuda/fused_decode.py): bf16 x [B, E] and caches [L, B, S, E];
// scratch: f32 x_res [B, E], bf16 hbuf [B, E] and hh [B, 4E], f32
// workspace of fk_fused_decode_workspace_bytes(B, E); f32 LN params and
// biases [L, D]; weights [L, in, out] bf16, or int8 (w_int8 = 1) with f32
// scales [L, 1, out]; caches bf16, or int8 codes (kv_int8 = 1) with f32
// scales k_scale/v_scale [L, 1, E]. E % 128 == 0, head_dim * cache bytes a
// multiple of 16 and head_dim <= 128, 0 <= length < S, S small enough for
// the attention's shared memory.
extern "C" int fk_fused_decode_blocks(
    const void* x_in, void* x_out, void* x_res, void* hbuf, void* hh,
    void* workspace, const void* ln1_w, const void* ln1_b, const void* qkv_w,
    const void* qkv_b, const void* proj_w, const void* proj_b,
    const void* ln2_w, const void* ln2_b, const void* fc_w, const void* fc_b,
    const void* fc2_w, const void* fc2_b, const void* qkv_s,
    const void* proj_s, const void* fc_s, const void* fc2_s, void* k_cache,
    void* v_cache, const void* k_scale, const void* v_scale, int L, int B,
    int S, int E, int H, int length, int w_int8, int kv_int8, void* stream) {
  const int cache_bytes = kv_int8 ? 1 : 2;
  if (E % GEMM_BK != 0 || E % H != 0 || (E / H) * cache_bytes % 16 != 0 ||
      E / H > ATTN_THREADS || length < 0 || length >= S ||
      attention_smem_bytes(E / H, S, cache_bytes) > 48 * 1024 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return int(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Weights w{f(ln1_w), f(ln1_b), f(qkv_b), f(proj_b), f(ln2_w),
                  f(ln2_b), f(fc_b),  f(fc2_b), qkv_w,     proj_w,
                  fc_w,     fc2_w,    f(qkv_s), f(proj_s), f(fc_s),
                  f(fc2_s)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto wtag, auto ctag) {
    using WT = decltype(wtag);
    using CT = decltype(ctag);
    return run_layers<WT, CT>(
        static_cast<const bf16*>(x_in), static_cast<bf16*>(x_out),
        static_cast<float*>(x_res), static_cast<bf16*>(hbuf),
        static_cast<bf16*>(hh), static_cast<float*>(workspace), w,
        static_cast<CT*>(k_cache), static_cast<CT*>(v_cache),
        kv_int8 ? f(k_scale) : nullptr, kv_int8 ? f(v_scale) : nullptr, L, B,
        S, E, H, length, st);
  };
  cudaError_t err;
  if (kv_int8)
    err = w_int8 ? run(int8_t{}, int8_t{}) : run(bf16{}, int8_t{});
  else
    err = w_int8 ? run(int8_t{}, bf16{}) : run(bf16{}, bf16{});
  return int(err);
}
