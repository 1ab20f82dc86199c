// Causal MQA/GQA prefill attention with an f32 online softmax.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_attention.py `_kern`
// (launched by flash_mqa). Semantics match it exactly: key t is visible to
// query i of batch row b iff t <= n_past[b] + i; masked scores are -1e30
// (not -inf); out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: at Falcon-7B prefill (S = 512, 71 query heads
// over ONE K/V head, D = 64) the work is the score and P.V dot products,
// about 4 * S * (n_past + S/2) * H * D operations; the K/V bytes are small.
// bf16 inputs at D = 64 and 128 run on the tensor cores
// (flash_attention_tc.cu). These kernels serve f32 inputs, which have to stay
// within f32 accuracy, and D = 32; they run on the CUDA cores in f32, so
// their design is about reuse and skipped work:
//  * one block serves HB = 8 query heads x BQ = 16 positions that share one
//    K/V head (with MQA all 71 heads do), so every K/V tile it stages in
//    shared memory feeds 128 query rows;
//  * each thread owns one query row, keeping q and the f32 accumulator in
//    registers; all threads read the same staged key at once, which is a
//    shared-memory broadcast (no bank conflicts);
//  * the key loop stops at the block's last visible key, so tiles wholly
//    above the causal diagonal are never loaded;
//  * K/V tiles are staged with 16-byte loads, all in flight at once;
//  * the softmax rescale runs once per 8 keys, not once per key.
// No head padding is needed (the TPU kernel padded 71 heads to 72).
//
// flash_mha_kernel is the same function for the shapes that layout does not
// fit: G = 1 (every query head has its own K/V head, LLaMA: H = KV = 32),
// where the HB = 8 head slots of a block would hold one head, and D = 128,
// where two staged 64-key tiles are 64 KB of static shared memory and q plus
// the accumulator are 256 registers a thread. Its block serves one head:
//  * a query row is split over SPLIT = D / 32 neighbouring lanes, each
//    holding 32 dimensions of q and of the accumulator in registers; a score
//    is their partial dots summed with log2(SPLIT) warp shuffles;
//  * 128 threads serve 128 / SPLIT query positions (32 at D = 128) against
//    K/V tiles of 32 keys staged as f32 (32 KB at D = 128);
//  * lane `part` of a row owns the float4 groups part, part + SPLIT, ... of
//    the head dimension, so the SPLIT lanes read neighbouring 16-byte words
//    of a staged key (no bank conflict) while all rows read the same key
//    (a broadcast);
//  * causal tile skipping, 16-byte staging and the 8-key rescale as above.

#include "common.cuh"

namespace {

using gq::store;
using gq::to_f32;

constexpr int BQ = 16;   // query positions per block
constexpr int HB = 8;    // query heads per block (all on one K/V head)
constexpr int BT = 64;   // keys per staged tile
constexpr int SUB = 8;   // keys per online-softmax rescale
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
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

constexpr int MHA_THREADS = 128;
constexpr int MHA_BT = 32;  // keys per staged tile
constexpr int DP = 32;      // head dimensions per thread

template <typename T, int D>
__global__ void __launch_bounds__(MHA_THREADS)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, const int* __restrict__ n_past_vec, int n_past_scalar,
                 int S, int H, int Tn, int KV, long long kv_bstride, long long kv_tstride) {
  constexpr int SPLIT = D / DP;             // lanes per query row
  constexpr int ROWS = MHA_THREADS / SPLIT; // query positions per block
  constexpr int NV = DP / 4;                // float4 groups per thread
  __shared__ __align__(16) float ks[MHA_BT][D];
  __shared__ __align__(16) float vs[MHA_BT][D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int part = threadIdx.x % SPLIT;
  const int pos = blockIdx.x * ROWS + threadIdx.x / SPLIT;
  const bool active = pos < S;
  const int n_past = n_past_vec ? n_past_vec[b] : n_past_scalar;
  const int qpos = n_past + pos;
  const int last_pos = min(S, (int)(blockIdx.x + 1) * ROWS) - 1;
  const int t_end = min(Tn, n_past + last_pos + 1);
  const float scale = 1.0f / sqrtf((float)D);

  // this thread's dimension j * 4 + e is head dimension (j * SPLIT + part) * 4 + e
  float qr[DP], acc[DP];
  const size_t qoff = (((size_t)b * S + pos) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[j * 4 + e] = active ? to_f32(q[qoff + (j * SPLIT + part) * 4 + e]) : 0.f;
      acc[j * 4 + e] = 0.f;
    }
  float m = NEG_INF, l = 0.f;
  const T* kb = k + (size_t)b * kv_bstride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * kv_bstride + (size_t)kvh * D;

  // rows past S keep q = 0 and run along: the shuffles need every lane
  for (int t0 = 0; t0 < t_end; t0 += MHA_BT) {
    __syncthreads();
    gq::stage_kv<T, MHA_BT, D, MHA_THREADS>(ks, vs, kb + (size_t)t0 * kv_tstride,
                                            vb + (size_t)t0 * kv_tstride, (size_t)kv_tstride,
                                            t_end - t0);
    __syncthreads();
    const int n = min(MHA_BT, t_end - t0);
    for (int tt = 0; tt < n; tt += SUB) {
      float s[SUB];
      float mx = m;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[tt + u][(j * SPLIT + part) * 4]);
          dot += qr[j * 4] * kk.x + qr[j * 4 + 1] * kk.y + qr[j * 4 + 2] * kk.z +
                 qr[j * 4 + 3] * kk.w;
        }
#pragma unroll
        for (int off = SPLIT / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const bool vis = (tt + u < n) && (t0 + tt + u <= qpos);
        s[u] = vis ? dot * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int dd = 0; dd < DP; ++dd) acc[dd] *= alpha;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        const float p = expf(s[u] - mx);
        l += p;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[tt + u][(j * SPLIT + part) * 4]);
          acc[j * 4] += p * vv.x;
          acc[j * 4 + 1] += p * vv.y;
          acc[j * 4 + 2] += p * vv.z;
          acc[j * 4 + 3] += p * vv.w;
        }
      }
      m = mx;
    }
  }
  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(out + qoff + (j * SPLIT + part) * 4 + e, acc[j * 4 + e] * inv);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, const int* npv, int np,
            int B, int S, int H, int Tn, int KV, long long bstride, long long tstride,
            cudaStream_t st) {
  const int G = H / KV;
  if constexpr (D <= 64) {
    if (G > 1) {
      dim3 grid((S + BQ - 1) / BQ, KV * ((G + HB - 1) / HB), B);
      flash_mqa_kernel<T, D><<<grid, BQ * HB, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), npv, np, S, H, Tn, KV, bstride, tstride);
      return;
    }
  }
  // G == 1, or D = 128: one head per block
  constexpr int ROWS = MHA_THREADS / (D / DP);
  dim3 grid((S + ROWS - 1) / ROWS, H, B);
  flash_mha_kernel<T, D><<<grid, MHA_THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), npv, np, S, H, Tn, KV, bstride, tstride);
}

}  // namespace

// q (B, S, H, D) and out contiguous, D in {32, 64, 128}; k/v (B, T, KV, D) 16-byte aligned,
// with the given batch and time strides (in elements, multiples of 16
// bytes) and contiguous heads. n_past_vec (B,) int32 on the device, or null
// to use n_past for every row.
extern "C" int gq_flash_mqa(const void* q, const void* k, const void* v, void* out, int is_bf16,
                            const void* n_past_vec, int n_past, int B, int S, int H, int Tn,
                            int KV, int D, int kv_bstride, int kv_tstride, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* npv = static_cast<const int*>(n_past_vec);
#define GQ_FLASH_CASE(DV)                                                                    \
  if (D == DV) {                                                                             \
    if (is_bf16)                                                                             \
      launch<__nv_bfloat16, DV>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride,      \
                                kv_tstride, st);                                             \
    else                                                                                     \
      launch<float, DV>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride, kv_tstride,  \
                        st);                                                                 \
    return cudaGetLastError();                                                               \
  }
  GQ_FLASH_CASE(32)
  GQ_FLASH_CASE(64)
  GQ_FLASH_CASE(128)
#undef GQ_FLASH_CASE
  return cudaErrorInvalidValue;
}
