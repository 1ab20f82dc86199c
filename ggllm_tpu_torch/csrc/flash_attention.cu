// Causal MQA/GQA prefill attention for bf16 q/k/v of head dim 32 (the small
// test models), on the CUDA cores with an f32 online softmax.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_attention.py `_kern`
// (launched by flash_mqa) for bf16 at D = 32. bf16 at D = 64 and 128 runs on
// the tensor cores (flash_attention_tc.cu), f32 at every head dim in
// flash_attention_f32.cu. Semantics match the Pallas kernel exactly: key t
// is visible to query i of batch row b iff t <= n_past[b] + i; masked
// scores are -1e30 (not -inf); out = acc / max(l, 1e-30) in bf16.
//
// What bounds it on an H100: the score and P.V dot products (4 D per
// visible (query, key) pair and head) in f32 on the CUDA cores; no model the
// repository runs at full width has D = 32, so the design is kept simple:
//  * one block serves HB = 8 query heads x BQ = 16 positions that share one
//    K/V head, so every K/V tile it stages in shared memory (as f32) feeds
//    128 query rows; with G == 1 one head slot of the 8 is used;
//  * each thread owns one query row, keeping q and the f32 accumulator in
//    registers; all threads read the same staged key at once, which is a
//    shared-memory broadcast (no bank conflicts);
//  * the key loop stops at the block's last visible key, so tiles wholly
//    above the causal diagonal are never loaded;
//  * K/V tiles are staged with 16-byte loads, all in flight at once;
//  * the softmax rescale runs once per 8 keys, not once per key.

#include "common.cuh"

namespace {

using gq::store;
using gq::to_f32;

using T = __nv_bfloat16;
constexpr int D = 32;    // head dim
constexpr int BQ = 16;   // query positions per block
constexpr int HB = 8;    // query heads per block (all on one K/V head)
constexpr int BT = 64;   // keys per staged tile
constexpr int SUB = 8;   // keys per online-softmax rescale
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(BQ * HB)
flash_mqa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, const int* __restrict__ n_past_vec, int n_past_scalar,
                 int S, int H, int Tn, int KV, long long kv_bstride, long long kv_tstride) {
  __shared__ __align__(16) float ks[BT][D];
  __shared__ __align__(16) float vs[BT][D];
  const int b = blockIdx.z;
  const int G = H / KV;
  const int hblocks = (G + HB - 1) / HB;
  const int kvh = blockIdx.y / hblocks;
  const int g = (blockIdx.y % hblocks) * HB + threadIdx.x / BQ;
  const int pos = blockIdx.x * BQ + threadIdx.x % BQ;
  const bool active = g < G && pos < S;
  const int h = kvh * G + g;
  const int n_past = n_past_vec ? n_past_vec[b] : n_past_scalar;
  const int qpos = n_past + pos;
  // last key any row of this block can see (+1), capped by the buffer
  const int last_pos = min(S, (int)(blockIdx.x + 1) * BQ) - 1;
  const int t_end = min(Tn, n_past + last_pos + 1);
  const float scale = 1.0f / sqrtf((float)D);

  float qr[D], acc[D];
  const size_t qoff = (((size_t)b * S + pos) * H + h) * D;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qr[dd] = active ? to_f32(q[qoff + dd]) : 0.f;
    acc[dd] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const T* kb = k + (size_t)b * kv_bstride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * kv_bstride + (size_t)kvh * D;

  for (int t0 = 0; t0 < t_end; t0 += BT) {
    __syncthreads();
    gq::stage_kv<T, BT, D, BQ * HB>(ks, vs, kb + (size_t)t0 * kv_tstride,
                                    vb + (size_t)t0 * kv_tstride, (size_t)kv_tstride,
                                    t_end - t0);
    __syncthreads();
    if (!active) continue;
    const int n = min(BT, t_end - t0);
    for (int tt = 0; tt < n; tt += SUB) {
      float s[SUB];
      float mx = m;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int dd = 0; dd < D; dd += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[tt + u][dd]);
          dot += qr[dd] * kk.x + qr[dd + 1] * kk.y + qr[dd + 2] * kk.z + qr[dd + 3] * kk.w;
        }
        const bool vis = (tt + u < n) && (t0 + tt + u <= qpos);
        s[u] = vis ? dot * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[dd] *= alpha;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        const float p = expf(s[u] - mx);
        l += p;
#pragma unroll
        for (int dd = 0; dd < D; dd += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[tt + u][dd]);
          acc[dd] += p * vv.x;
          acc[dd + 1] += p * vv.y;
          acc[dd + 2] += p * vv.z;
          acc[dd + 3] += p * vv.w;
        }
      }
      m = mx;
    }
  }
  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) store(out + qoff + dd, acc[dd] * inv);
}

}  // namespace

// bf16 q (B, S, H, D) and out contiguous, D = 32; k/v (B, T, KV, D) bf16,
// 16-byte aligned, with the given batch and time strides (in elements,
// multiples of 16 bytes) and contiguous heads. n_past_vec (B,) int32 on the
// device, or null to use n_past for every row.
extern "C" int gq_flash_mqa(const void* q, const void* k, const void* v, void* out,
                            const void* n_past_vec, int n_past, int B, int S, int H, int Tn,
                            int KV, int head_dim, int kv_bstride, int kv_tstride,
                            void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || head_dim != D) return cudaErrorInvalidValue;
  dim3 grid((S + BQ - 1) / BQ, KV * ((H / KV + HB - 1) / HB), B);
  flash_mqa_kernel<<<grid, BQ * HB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<const int*>(n_past_vec), n_past, S, H, Tn, KV,
      kv_bstride, kv_tstride);
  return cudaGetLastError();
}
