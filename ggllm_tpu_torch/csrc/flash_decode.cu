// One-token decode attention over the valid prefix of one layer of the
// stacked KV cache (flash-decoding).
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_decode.py `_kern`
// (launched by cache_partials, wrapped by flash_decode), for bf16 and f32
// caches and, as that kernel's quant=True variant, for an int8 cache: int8
// codes (L, 2, B, T, KV, D) with one f32 scale per cached (position, head),
// (L, 2, B, T, KV). There K's scale multiplies the score (q . k_codes) and
// V's the probability before it weighs the V codes, so the scales factor
// out of both dots over D; q stays in the compute dtype.
//
// The partials kernel returns the un-normalized online-softmax partials
// (acc, m, l) of each query head against cache rows t < valid[b] of layer
// `layer`, read straight from the 6-D cache at the layer's offset; the layer
// is a run-time argument, so one kernel serves every layer. A row with
// valid = 0 comes out as m = -1e30, l = 0, acc = 0.
//
// What bounds it on an H100: the bytes of the valid K/V prefix (at
// Falcon-7B, KV = 1 and D = 64: 256 bytes per cached position in bf16, 136
// as int8 codes and two scales) plus launch latency; at decode there is one
// query row and one K/V head, so the TPU grid's (row, head) parallelism is
// gone. The design:
//  * the time axis is split across blocks of CT = 64 positions
//    (flash-decoding), so a 2047-long prefix runs 32 blocks at once;
//  * each block stages its K/V rows in shared memory once, with 16-byte
//    loads all in flight at once, and one thread per query head of the K/V
//    group (G = 71 at Falcon-7B) reads them as broadcasts, keeping q and
//    its f32 accumulator in registers;
//  * a second small kernel merges the per-block (acc, m, l) with the usual
//    partial-softmax algebra. Only positions below `valid` are read. For
//    flash_decode that kernel (finish_kernel) also folds in the small
//    unwritten [current token; pending] append block, which the JAX package
//    merges in XLA (flash_decode.py:405-427), and writes the normalized
//    output in q's dtype: as eager torch ops that merge is some twenty small
//    launches per layer.
//
// mha_partials_kernel replaces the Pallas kernel `_kern_mha` of the same file
// (launched by _cache_partials_mha), the G == 1 variant: every query head has
// its own K/V head (LLaMA-7B: KV = 32, D = 128), dense and int8 caches. The
// TPU kernel scores all heads of a time tile with one block-diagonal MXU dot
// and expands the probabilities with a 0/1 matrix; neither has a use here.
// What is kept is its reading pattern: a cached position's KV * D elements
// are contiguous (8 KB in bf16 at LLaMA-7B), so the heads of a position come
// in coalesced rows, and only positions below `valid` are read.
//
// What bounds it on an H100: the bytes of the valid K/V prefix (per position
// and layer 16 KB in bf16 at LLaMA-7B, 8.25 KB as int8 codes and two f32
// scales per head) plus launch latency. partials_kernel would give one thread
// of 128 work at G = 1, with q and the accumulator (2 x 128 floats) in its
// registers. The design:
//  * one block per head and chunk of CT = 64 positions (flash-decoding as
//    above; LLaMA-7B at 2047 positions: 32 x 32 blocks of 128 threads), the
//    chunk split over the block's four warps, 16 positions each: what a
//    launch costs at decode is the longest chain of dependent loads, and a
//    warp walking all 64 positions of a chunk (eight steps) took twice the
//    time of this layout whatever the prefix length;
//  * each lane owns D / 32 consecutive dimensions of q and of the f32
//    accumulator in registers, so a warp's load of one position's K (or V)
//    is one contiguous row of D elements (256 B in bf16 at D = 128), and
//    K/V are not staged in shared memory: each element is used once;
//  * SUB = 8 positions per step: their 16 K/V loads (and the int8 scales) are
//    started before any is used, the 8 scores are reduced with warp shuffles,
//    and the online-softmax rescale runs once per step; the four warps'
//    partials merge through shared memory into the chunk's;
//  * int8: K's scale multiplies the score, V's the probability; the scales
//    are read where they lie, (L, 2, B, T, KV): the KV scales of a position
//    are contiguous;
//  * it writes the partials in the layout partials_kernel writes, so
//    merge_kernel and finish_kernel serve both.

#include "common.cuh"

namespace {

using gq::to_f32;

constexpr int CT = 64;   // cache positions per block
constexpr int THREADS = 128;  // threads per block (>= the group size G)
constexpr int SUB = 8;   // positions per online-softmax rescale
constexpr float NEG_INF = -1e30f;

// T: the cache's element (float, bf16, or int8 codes with `scales`); TQ: q's
template <typename T, typename TQ, int D>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const T* __restrict__ cache, const float* __restrict__ scales, int layer,
                const TQ* __restrict__ q, const int* __restrict__ valid_vec, int valid_scalar,
                float* __restrict__ part_acc, float* __restrict__ part_ml,
                int B, int Tn, int KV, int G, int n_chunks) {
  __shared__ __align__(16) float ks[CT][D];
  __shared__ __align__(16) float vs[CT][D];
  constexpr bool QUANT = sizeof(T) == 1;
  __shared__ float ksc[QUANT ? CT : 1], vsc[QUANT ? CT : 1];  // per-position scales
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
  if (QUANT && g < CT) {  // THREADS >= CT
    const size_t sk = ((((size_t)layer * 2) * B + b) * Tn + t0 + g) * KV + kvh;
    ksc[g] = g < n ? scales[sk] : 0.f;
    vsc[g] = g < n ? scales[sk + (size_t)B * Tn * KV] : 0.f;
  }
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
      if (QUANT) dot *= ksc[tt + u];
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
      const float pv = QUANT ? p * vsc[tt + u] : p;
#pragma unroll
      for (int dd = 0; dd < D; dd += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[tt + u][dd]);
        acc[dd] += pv * vv.x;
        acc[dd + 1] += pv * vv.y;
        acc[dd + 2] += pv * vv.z;
        acc[dd + 3] += pv * vv.w;
      }
    }
    m = mx;
  }
#pragma unroll
  for (int dd = 0; dd < D; ++dd) part_acc[pidx * D + dd] = acc[dd];
  part_ml[2 * pidx] = m;
  part_ml[2 * pidx + 1] = l;
}

constexpr int MHA_WARPS = 4;          // warps per block of mha_partials_kernel
constexpr int MHA_T = CT / MHA_WARPS;  // positions per warp

// E consecutive elements at p (aligned to E elements) -> f32
template <int E>
__device__ __forceinline__ void load_elems(const float* p, float (&o)[E]) {
  if constexpr (E == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else if constexpr (E == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x, o[1] = v.y;
  } else {
    o[0] = __ldg(p);
  }
}
template <int E>
__device__ __forceinline__ void load_elems(const __nv_bfloat16* p, float (&o)[E]) {
  if constexpr (E == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x, o[1] = a.y, o[2] = c.x, o[3] = c.y;
  } else if constexpr (E == 2) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    o[0] = a.x, o[1] = a.y;
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}
template <int E>
__device__ __forceinline__ void load_elems(const int8_t* p, float (&o)[E]) {
  if constexpr (E == 4) {
    const int v = __ldg(reinterpret_cast<const int*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = (float)((int)((unsigned)v << (24 - 8 * i)) >> 24);  // sign-extends
  } else if constexpr (E == 2) {
    const int v = __ldg(reinterpret_cast<const short*>(p));
    o[0] = (float)((int)((unsigned)v << 24) >> 24);
    o[1] = (float)((int)((unsigned)v << 16) >> 24);
  } else {
    o[0] = (float)p[0];
  }
}

// G == 1: one block per (time chunk, head, batch row); warp w takes positions
// [w * MHA_T, (w + 1) * MHA_T) of the chunk and lane i owns dimensions
// [i * D/32, (i + 1) * D/32); the warps' partials merge in shared memory.
// Same arguments, cache layout and output layout as partials_kernel with
// G = 1; grid (n_chunks, KV, B).
template <typename T, typename TQ, int D>
__global__ void __launch_bounds__(MHA_WARPS * 32)
mha_partials_kernel(const T* __restrict__ cache, const float* __restrict__ scales, int layer,
                    const TQ* __restrict__ q, const int* __restrict__ valid_vec,
                    int valid_scalar, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int B, int Tn, int KV, int n_chunks) {
  constexpr int E = D / 32;
  constexpr bool QUANT = sizeof(T) == 1;
  __shared__ float w_acc[MHA_WARPS][D];
  __shared__ float w_m[MHA_WARPS], w_l[MHA_WARPS];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int valid = valid_vec ? valid_vec[b] : valid_scalar;
  const int t0 = chunk * CT + warp * MHA_T;      // this warp's first position
  const int n = min(MHA_T, valid - t0);          // and how many of them are valid
  const size_t pidx = ((size_t)b * KV + h) * n_chunks + chunk;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = NEG_INF, l = 0.f;
  if (n > 0) {
    const size_t row = (size_t)KV * D;  // elements per cached position
    const size_t pos0 = (((size_t)layer * 2) * B + b) * Tn + t0;  // K's first position
    const T* kp = cache + pos0 * row + (size_t)h * D + lane * E;
    const T* vp = kp + (size_t)B * Tn * row;
    const float* ksc = QUANT ? scales + pos0 * KV + h : nullptr;
    const float* vsc = QUANT ? ksc + (size_t)B * Tn * KV : nullptr;
    const float scale = 1.0f / sqrtf((float)D);
    const TQ* qp = q + ((size_t)b * KV + h) * D + lane * E;
    float qr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) qr[e] = to_f32(qp[e]);
    for (int tt = 0; tt < n; tt += SUB) {
      float kk[SUB][E], vv[SUB][E], ksv[SUB], vsv[SUB];
#pragma unroll
      for (int u = 0; u < SUB; ++u) {  // all loads of the step before any use
        const int t = tt + u;
        if (t < n) {
          load_elems<E>(kp + (size_t)t * row, kk[u]);
          load_elems<E>(vp + (size_t)t * row, vv[u]);
          ksv[u] = QUANT ? __ldg(ksc + (size_t)t * KV) : 1.f;
          vsv[u] = QUANT ? __ldg(vsc + (size_t)t * KV) : 1.f;
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kk[u][e] = vv[u][e] = 0.f;
          ksv[u] = vsv[u] = 0.f;
        }
      }
      float s[SUB];
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[e] * kk[u][e];
        s[u] = dot;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < SUB; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float mx = m;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        s[u] = (tt + u < n) ? s[u] * ksv[u] * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        const float p = expf(s[u] - mx);
        l += p;
        const float pv = p * vsv[u];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += pv * vv[u][e];
      }
      m = mx;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) w_acc[warp][lane * E + e] = acc[e];
  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
  __syncthreads();
  // merge the warps' partials: thread dd takes head dimension dd. A chunk (or
  // a warp's part of it) past the valid prefix merges as the empty partial
  // (m -1e30, l 0, acc 0)
  const int dd = threadIdx.x;
  if (dd >= D) return;
  float M = w_m[0];
#pragma unroll
  for (int w = 1; w < MHA_WARPS; ++w) M = fmaxf(M, w_m[w]);
  float Lsum = 0.f, A = 0.f;
#pragma unroll
  for (int w = 0; w < MHA_WARPS; ++w) {
    const float wgt = expf(w_m[w] - M);
    Lsum += wgt * w_l[w];
    A += wgt * w_acc[w][dd];
  }
  part_acc[pidx * D + dd] = A;
  if (dd == 0) {
    part_ml[2 * pidx] = M;
    part_ml[2 * pidx + 1] = Lsum;
  }
}

// (M, L, A) of row (bk, g) at head dimension dd, merged over the time chunks
__device__ __forceinline__ void merge_chunks(const float* __restrict__ part_acc,
                                             const float* __restrict__ part_ml, int bk, int g,
                                             int dd, int G, int n_chunks, int D, float& M,
                                             float& L, float& A) {
  M = NEG_INF;
  for (int c = 0; c < n_chunks; ++c)
    M = fmaxf(M, part_ml[2 * (((size_t)bk * n_chunks + c) * G + g)]);
  L = 0.f;
  A = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t p = ((size_t)bk * n_chunks + c) * G + g;
    const float w = expf(part_ml[2 * p] - M);
    L += w * part_ml[2 * p + 1];
    A += w * part_acc[p * D + dd];
  }
}

// one block per (b, kv, g) row, one thread per head dimension
__global__ void merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                             float* __restrict__ acc, float* __restrict__ m_out,
                             float* __restrict__ l_out, int G, int n_chunks, int D) {
  const int r = blockIdx.x;  // (b * KV + kv) * G + g
  const int dd = threadIdx.x;
  float M, L, A;
  merge_chunks(part_acc, part_ml, r / G, r % G, dd, G, n_chunks, D, M, L, A);
  acc[(size_t)r * D + dd] = A;
  if (dd == 0) {
    m_out[r] = M;
    l_out[r] = L;
  }
}

// As merge_kernel, then the append block app (2, B, A, KV, D) of which the
// first app_valid entries are real, then out = acc / l for head kv * G + g,
// which lies at row r of out (B, 1, H, D). blockDim.x == D; A floats of
// dynamic shared memory hold the block's scores.
template <typename TQ>
__global__ void finish_kernel(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml, const TQ* __restrict__ q,
                              const TQ* __restrict__ app, int n_app, int app_valid,
                              TQ* __restrict__ out, int B, int KV, int G, int n_chunks, int D) {
  extern __shared__ float s2[];
  const int r = blockIdx.x;  // (b * KV + kv) * G + g
  const int bk = r / G, b = bk / KV, kvh = bk % KV;
  const int dd = threadIdx.x;
  float M, L, A;
  merge_chunks(part_acc, part_ml, bk, r % G, dd, G, n_chunks, D, M, L, A);
  if (n_app > 0) {
    const float scale = 1.0f / sqrtf((float)D);
    const TQ* qr = q + (size_t)r * D;
    const size_t step = (size_t)KV * D;  // elements per append entry
    const TQ* ka = app + ((size_t)b * n_app * KV + kvh) * D;
    const TQ* va = ka + (size_t)B * n_app * step;
    for (int a = dd; a < n_app; a += D) {
      float dot = 0.f;
      for (int e = 0; e < D; ++e) dot += to_f32(qr[e]) * to_f32(ka[a * step + e]);
      s2[a] = a < app_valid ? dot * scale : NEG_INF;
    }
    __syncthreads();
    float M2 = M;
    for (int a = 0; a < n_app; ++a) M2 = fmaxf(M2, s2[a]);
    const float w = expf(M - M2);
    L *= w;
    A *= w;
    for (int a = 0; a < app_valid; ++a) {
      const float p = expf(s2[a] - M2);
      L += p;
      A += p * to_f32(va[a * step + dd]);
    }
  }
  gq::store(out + (size_t)r * D + dd, A / fmaxf(L, 1e-30f));
}

// G == 1 over several K/V heads takes mha_partials_kernel (the only one
// for D = 128: partials_kernel's staged tiles stop at D = 64)
__host__ __device__ constexpr bool is_mha(int KV, int G) { return G == 1 && KV > 1; }

template <typename T, typename TQ, int D>
bool launch_partials(const void* cache, const void* scales, int layer, const void* q,
                     const int* vv, int valid, float* pacc, float* pml, int B, int Tn, int KV,
                     int G, int n_chunks, cudaStream_t st) {
  if (is_mha(KV, G)) {
    dim3 grid(n_chunks, KV, B);
    mha_partials_kernel<T, TQ, D><<<grid, MHA_WARPS * 32, 0, st>>>(
        static_cast<const T*>(cache), static_cast<const float*>(scales), layer,
        static_cast<const TQ*>(q), vv, valid, pacc, pml, B, Tn, KV, n_chunks);
    return true;
  }
  if constexpr (D <= 64) {
    dim3 grid(n_chunks, KV, B);
    partials_kernel<T, TQ, D><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(cache), static_cast<const float*>(scales), layer,
        static_cast<const TQ*>(q), vv, valid, pacc, pml, B, Tn, KV, G, n_chunks);
    return true;
  }
  return false;
}

template <int D>
bool dispatch_partials(int cache_kind, int q_bf16, const void* cache, const void* scales,
                       int layer, const void* q, const int* vv, int valid, float* pacc,
                       float* pml, int B, int Tn, int KV, int G, int n_chunks, cudaStream_t st) {
#define GQ_ARGS cache, scales, layer, q, vv, valid, pacc, pml, B, Tn, KV, G, n_chunks, st
  if (cache_kind == 0 && !q_bf16) return launch_partials<float, float, D>(GQ_ARGS);
  if (cache_kind == 1 && q_bf16)
    return launch_partials<__nv_bfloat16, __nv_bfloat16, D>(GQ_ARGS);
  if (cache_kind == 2 && q_bf16) return launch_partials<int8_t, __nv_bfloat16, D>(GQ_ARGS);
  if (cache_kind == 2) return launch_partials<int8_t, float, D>(GQ_ARGS);
  return false;
#undef GQ_ARGS
}

// Checks the arguments and launches the partials over n_chunks time chunks.
cudaError_t run_partials(const void* cache, int cache_kind, const void* scales, int layer,
                         const void* q, int q_bf16, const void* valid_vec, int valid,
                         void* part_acc, void* part_ml, int L, int B, int Tn, int KV, int G,
                         int D, int n_chunks, cudaStream_t st) {
  if (layer < 0 || layer >= L || B < 1 || KV < 1 || G < 1 || G > THREADS || n_chunks < 0 ||
      n_chunks * CT > Tn + CT - 1 || (D != 32 && D != 64 && !(D == 128 && is_mha(KV, G))) ||
      (cache_kind == 2) != (scales != nullptr))
    return cudaErrorInvalidValue;
  if (n_chunks == 0) return cudaSuccess;
  const int* vv = static_cast<const int*>(valid_vec);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
#define GQ_ARGS cache_kind, q_bf16, cache, scales, layer, q, vv, valid, pacc, pml, B, Tn, KV, G, \
                n_chunks, st
  const bool ok = D == 32   ? dispatch_partials<32>(GQ_ARGS)
                  : D == 64 ? dispatch_partials<64>(GQ_ARGS)
                            : dispatch_partials<128>(GQ_ARGS);
#undef GQ_ARGS
  return ok ? cudaGetLastError() : cudaErrorInvalidValue;
}

}  // namespace

// cache (L, 2, B, T, KV, D) contiguous, cache_kind 0 = f32, 1 = bf16, 2 = int8
// codes with scales (L, 2, B, T, KV) f32 contiguous (null otherwise); q
// (B, KV, G, D) contiguous, in the cache's dtype for kinds 0 and 1 and f32 or
// bf16 (q_bf16) for kind 2. D is 32 or 64, or 128 where G == 1 and KV > 1
// (that case runs mha_partials_kernel). Writes acc (B, KV, G, D), m and l (B, KV, G) in
// f32, using part_acc (B, KV, n_chunks, G, D) and part_ml (B, KV, n_chunks,
// G, 2) as scratch. n_chunks * 64 must cover every row's valid length;
// valid_vec (B,) int32 on the device, or null to use `valid` for every row.
extern "C" int gq_cache_partials(const void* cache, int cache_kind, const void* scales,
                                 int layer, const void* q, int q_bf16, const void* valid_vec,
                                 int valid, void* acc, void* m, void* l, void* part_acc,
                                 void* part_ml, int L, int B, int Tn, int KV, int G, int D,
                                 int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = run_partials(cache, cache_kind, scales, layer, q, q_bf16, valid_vec, valid,
                               part_acc, part_ml, L, B, Tn, KV, G, D, n_chunks, st);
  if (e != cudaSuccess) return e;
  merge_kernel<<<B * KV * G, D, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), G, n_chunks, D);
  return cudaGetLastError();
}

// The whole decode attention: the partials as above, then their merge with
// the append block app (2, B, n_app, KV, D) in q's dtype (null with n_app =
// 0), of which the first app_valid entries are real, into out (B, 1, H, D)
// in q's dtype.
extern "C" int gq_flash_decode(const void* cache, int cache_kind, const void* scales, int layer,
                               const void* q, int q_bf16, const void* valid_vec, int valid,
                               const void* app, int n_app, int app_valid, void* out,
                               void* part_acc, void* part_ml, int L, int B, int Tn, int KV,
                               int G, int D, int n_chunks, void* stream) {
  if (n_app < 0 || app_valid < 0 || app_valid > n_app || (n_app > 0) != (app != nullptr) ||
      (n_app > 0 && app_valid < 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = run_partials(cache, cache_kind, scales, layer, q, q_bf16, valid_vec, valid,
                               part_acc, part_ml, L, B, Tn, KV, G, D, n_chunks, st);
  if (e != cudaSuccess) return e;
  const float* pacc = static_cast<const float*>(part_acc);
  const float* pml = static_cast<const float*>(part_ml);
  const size_t smem = (size_t)(n_app > 0 ? n_app : 1) * sizeof(float);
  if (q_bf16)
    finish_kernel<__nv_bfloat16><<<B * KV * G, D, smem, st>>>(
        pacc, pml, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(app),
        n_app, app_valid, static_cast<__nv_bfloat16*>(out), B, KV, G, n_chunks, D);
  else
    finish_kernel<float><<<B * KV * G, D, smem, st>>>(
        pacc, pml, static_cast<const float*>(q), static_cast<const float*>(app), n_app,
        app_valid, static_cast<float*>(out), B, KV, G, n_chunks, D);
  return cudaGetLastError();
}
