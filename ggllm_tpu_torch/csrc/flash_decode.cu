// One-token decode attention partials over the valid prefix of one layer of
// the stacked KV cache (flash-decoding).
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_decode.py `_kern`
// (launched by cache_partials, wrapped by flash_decode), for bf16 and f32
// caches. It returns the un-normalized online-softmax partials (acc, m, l)
// of each query head against cache rows t < valid[b] of layer `layer`, read
// straight from the 6-D cache (L, 2, B, T, KV, D) at the layer's offset; the
// layer is a run-time argument, so one kernel serves every layer. A row with
// valid = 0 comes out as m = -1e30, l = 0, acc = 0.
//
// What bounds it on an H100: the bytes of the valid K/V prefix (at
// Falcon-7B, KV = 1 and D = 64: 256 bytes per cached position in bf16) plus
// launch latency; at decode there is one query row and one K/V head, so the
// TPU grid's (row, head) parallelism is gone. The design:
//  * the time axis is split across blocks of CT = 64 positions
//    (flash-decoding), so a 2047-long prefix runs 32 blocks at once;
//  * each block stages its K/V rows in shared memory once, with 16-byte
//    loads all in flight at once, and one thread per query head of the K/V
//    group (G = 71 at Falcon-7B) reads them as broadcasts, keeping q and
//    its f32 accumulator in registers;
//  * a second small kernel merges the per-block (acc, m, l) with the usual
//    partial-softmax algebra. Only positions below `valid` are read.

#include "common.cuh"

namespace {

using gq::to_f32;

constexpr int CT = 64;   // cache positions per block
constexpr int THREADS = 128;  // threads per block (>= the group size G)
constexpr int SUB = 8;   // positions per online-softmax rescale
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const T* __restrict__ cache, int layer, const T* __restrict__ q,
                const int* __restrict__ valid_vec, int valid_scalar,
                float* __restrict__ part_acc, float* __restrict__ part_ml,
                int B, int Tn, int KV, int G, int n_chunks) {
  __shared__ __align__(16) float ks[CT][D];
  __shared__ __align__(16) float vs[CT][D];
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x;
  const int valid = valid_vec ? valid_vec[b] : valid_scalar;
  const int t0 = chunk * CT;
  const int n = min(CT, valid - t0);
  const size_t pidx = (((size_t)b * KV + kvh) * n_chunks + chunk) * G + g;
  if (n <= 0) {  // chunk past this row's valid prefix: an empty partial
    if (g < G) {
      part_ml[2 * pidx] = NEG_INF;
      part_ml[2 * pidx + 1] = 0.f;
      for (int dd = 0; dd < D; ++dd) part_acc[pidx * D + dd] = 0.f;
    }
    return;
  }
  const size_t row = (size_t)KV * D;  // elements per cached position
  const size_t kbase = (((size_t)layer * 2) * B + b) * Tn * row + (size_t)kvh * D;
  const size_t vbase = kbase + (size_t)B * Tn * row;
  gq::stage_kv<T, CT, D, THREADS>(ks, vs, cache + kbase + (size_t)t0 * row,
                                  cache + vbase + (size_t)t0 * row, row, n);
  __syncthreads();
  if (g >= G) return;

  const float scale = 1.0f / sqrtf((float)D);
  const size_t qoff = (((size_t)b * KV + kvh) * G + g) * D;
  float qr[D], acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qr[dd] = to_f32(q[qoff + dd]);
    acc[dd] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
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
      s[u] = (tt + u < n) ? dot * scale : NEG_INF;
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
#pragma unroll
  for (int dd = 0; dd < D; ++dd) part_acc[pidx * D + dd] = acc[dd];
  part_ml[2 * pidx] = m;
  part_ml[2 * pidx + 1] = l;
}

// one block per (b, kv, g) row, one thread per head dimension
__global__ void merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                             float* __restrict__ acc, float* __restrict__ m_out,
                             float* __restrict__ l_out, int G, int n_chunks, int D) {
  const int r = blockIdx.x;  // (b * KV + kv) * G + g
  const int bk = r / G, g = r % G;
  const int dd = threadIdx.x;
  float M = NEG_INF;
  for (int c = 0; c < n_chunks; ++c)
    M = fmaxf(M, part_ml[2 * (((size_t)bk * n_chunks + c) * G + g)]);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t p = ((size_t)bk * n_chunks + c) * G + g;
    const float w = expf(part_ml[2 * p] - M);
    L += w * part_ml[2 * p + 1];
    A += w * part_acc[p * D + dd];
  }
  acc[(size_t)r * D + dd] = A;
  if (dd == 0) {
    m_out[r] = M;
    l_out[r] = L;
  }
}

template <typename T, int D>
void launch_partials(const void* cache, int layer, const void* q, const int* vv, int valid,
                     float* pacc, float* pml, int B, int Tn, int KV, int G, int n_chunks,
                     cudaStream_t st) {
  dim3 grid(n_chunks, KV, B);
  partials_kernel<T, D><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(cache), layer, static_cast<const T*>(q), vv, valid, pacc, pml,
      B, Tn, KV, G, n_chunks);
}

}  // namespace

// cache (L, 2, B, T, KV, D) contiguous; q (B, KV, G, D) contiguous in the
// cache's dtype. Writes acc (B, KV, G, D), m and l (B, KV, G) in f32, using
// part_acc (B, KV, n_chunks, G, D) and part_ml (B, KV, n_chunks, G, 2) as
// scratch. n_chunks * 64 must cover every row's valid length; valid_vec
// (B,) int32 on the device, or null to use `valid` for every row.
extern "C" int gq_cache_partials(const void* cache, int is_bf16, int layer, const void* q,
                                 const void* valid_vec, int valid, void* acc, void* m, void* l,
                                 void* part_acc, void* part_ml, int L, int B, int Tn, int KV,
                                 int G, int D, int n_chunks, void* stream) {
  if (layer < 0 || layer >= L || B < 1 || KV < 1 || G < 1 || G > THREADS || n_chunks < 0 ||
      n_chunks * CT > Tn + CT - 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vv = static_cast<const int*>(valid_vec);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  bool launched = false;
  if (n_chunks > 0) {
#define GQ_DECODE_CASE(DV)                                                                     \
  if (D == DV) {                                                                               \
    if (is_bf16)                                                                               \
      launch_partials<__nv_bfloat16, DV>(cache, layer, q, vv, valid, pacc, pml, B, Tn, KV, G,  \
                                         n_chunks, st);                                        \
    else                                                                                       \
      launch_partials<float, DV>(cache, layer, q, vv, valid, pacc, pml, B, Tn, KV, G,          \
                                 n_chunks, st);                                                \
    launched = true;                                                                           \
  }
    GQ_DECODE_CASE(32)
    GQ_DECODE_CASE(64)
#undef GQ_DECODE_CASE
    if (!launched) return cudaErrorInvalidValue;
  } else if (D != 32 && D != 64) {
    return cudaErrorInvalidValue;
  }
  merge_kernel<<<B * KV * G, D, 0, st>>>(pacc, pml, static_cast<float*>(acc),
                                         static_cast<float*>(m), static_cast<float*>(l), G,
                                         n_chunks, D);
  return cudaGetLastError();
}
