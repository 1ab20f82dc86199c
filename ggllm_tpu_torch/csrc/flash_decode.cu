// One-token decode attention over the valid prefix of one layer of the
// stacked KV cache (flash-decoding): the G == 1 kernel and the SIMT kernel
// of grouped heads; flash_decode_tc.cu holds the tensor-core kernel.
//
// decode_mha_kernel replaces the Pallas kernel ggllm_tpu/kernels/
// flash_decode.py `_kern_mha` (launched by _cache_partials_mha), the G == 1
// variant: every query head has its own K/V head (LLaMA-7B: KV = 32,
// D = 128), on f32, bf16 and int8 caches (codes (L, 2, B, T, KV, D) with one
// f32 scale per cached (position, head), (L, 2, B, T, KV): K's scale
// multiplies the score, V's the probability, so the scales factor out of
// both dots over D). The TPU kernel scores all heads of a time tile with one
// block-diagonal MXU dot and expands the probabilities with a 0/1 matrix;
// neither has a use here: at G == 1 there is one query row, so there is no
// product for the tensor cores, and the arithmetic stays f32.
//
// What bounds it on an H100: the bytes of the valid K/V prefix (per position
// and layer 16 KB in bf16 at LLaMA-7B, 8.25 KB as int8 codes and two f32
// scales per head), plus the launch and the chain of dependent loads. The
// design:
//  * 16-byte loads per lane. A head's row of one position is D elements
//    (256 B in bf16 at D = 128, 128 B as int8), so LP = D * size / 16 lanes
//    load it and a warp loads 32 / LP positions per instruction (bf16: two,
//    int8: four); each lane owns the matching 16 / size dimensions of q and
//    of the f32 accumulator. Each lane group keeps its own online softmax.
//  * U = 4 positions per lane group and step: all of a step's K and V loads
//    (and the int8 scales, one 4-byte load per position shared by the group)
//    are issued together, and the next step's before this one's are used, so
//    a warp keeps up to 16 x 16 bytes a lane in flight; the scores are reduced
//    over the LP lanes with shuffles.
//  * The time axis is split over blocks (decode_plan in
//    kernels/flash_decode.py: enough blocks to fill the SMs, at least 32 keys
//    each) and the splits are merged INSIDE the launch: each block writes its
//    (acc, m, l) to a workspace, takes a ticket from a counter per (row,
//    head), and the last block merges every split and the unwritten append
//    block ([current token; pending], which the JAX package merges in XLA,
//    flash_decode.py:405-427), writes the output (or the merged partials for
//    cache_partials) and resets the counter. One launch a call, nothing
//    allocated but the output; a device vector of lengths is read on the
//    device, blocks past a row's length only take their ticket.
//
// partials_kernel replaces the Pallas kernel `_kern` (launched by
// cache_partials) where the tensor-core kernel does not serve: f32 queries
// (on an f32 or an int8 cache) and head_dim 32. One block per 64-position
// chunk of one K/V head stages the chunk's K/V rows in shared memory as f32
// (16-byte loads, all in flight at once); one thread per query head of the
// group (G = 71 at Falcon-7B) reads them as broadcasts, keeping q and its f32
// accumulator in registers. It finishes in the same launch as above.

#include "common.cuh"

namespace {

using gq::Finish;
using gq::finish;
using gq::make_finish;
using gq::NEG_INF;
using gq::row_valid;
using gq::to_f32;

constexpr int CT = 64;        // cache positions per block of partials_kernel
constexpr int THREADS = 128;  // threads per block of both kernels (>= the group size G)
constexpr int SUB = 8;        // positions per online-softmax rescale in partials_kernel

// T: the cache's element (float, bf16, or int8 codes with `scales`); TQ: q's.
// Grid (n_split, KV, B), chunk == CT: block (s, kvh, b) takes positions
// [s * CT, (s + 1) * CT) below row b's valid length.
template <typename T, typename TQ, int D>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const T* __restrict__ cache, const float* __restrict__ scales, int layer,
                const TQ* __restrict__ q, Finish<TQ> f, int B, int Tn, int KV, int G) {
  __shared__ __align__(16) float ks[CT][D];
  __shared__ __align__(16) float vs[CT][D];
  constexpr bool QUANT = sizeof(T) == 1;
  __shared__ float ksc[QUANT ? CT : 1], vsc[QUANT ? CT : 1];  // per-position scales
  __shared__ int flag;
  extern __shared__ float merge_sm[];
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x;
  const int valid = row_valid(f, b, Tn);
  const int t0 = chunk * CT;
  const int n = min(CT, valid - t0);
  if (n > 0) {
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
    if (g < G) {
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
          const float p = (tt + u < n) ? expf(s[u] - mx) : 0.f;
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
      const size_t pidx = (((size_t)b * KV + kvh) * f.ws + chunk) * G + g;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) f.part_acc[pidx * D + dd] = acc[dd];
      f.part_ml[2 * pidx] = m;
      f.part_ml[2 * pidx + 1] = l;
    }
  }
  finish(f, q, b, kvh, B, KV, G, D, G, valid, &flag, merge_sm);
}

constexpr int MHA_WARPS = THREADS / 32;
constexpr int MHA_U = 4;  // positions per lane group and step

// 16 bytes of T -> E floats
__device__ __forceinline__ void unpack(const uint4& v, float (&o)[4]) {
  o[0] = __uint_as_float(v.x), o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z), o[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&o)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    o[2 * i] = a.x, o[2 * i + 1] = a.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&o)[16]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = (float)((int)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

// G == 1: one block per (split, head, batch row), grid (n_split, KV, B);
// lane group gi = lane / LP of warp w takes, at step j, positions
// k0 + j * NW * P * U + (u * NW + w) * P + gi (u < U) of the split
// [k0, k0 + chunk) below the row's valid length. Partial slot (b, h, split)
// of R = 1 row.
template <typename T, typename TQ, int D>
__global__ void __launch_bounds__(THREADS)
decode_mha_kernel(const T* __restrict__ cache, const float* __restrict__ scales, int layer,
                  const TQ* __restrict__ q, Finish<TQ> f, int B, int Tn, int KV) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int E = 16 / sizeof(T);  // elements of a lane's 16-byte load
  constexpr int LP = D / E;          // lanes per position
  constexpr int P = 32 / LP;         // positions per warp and load instruction
  constexpr int STEP = MHA_WARPS * P * MHA_U;
  static_assert(LP >= 1 && LP <= 32 && D % E == 0, "head_dim and element size");
  __shared__ float w_acc[MHA_WARPS][D];
  __shared__ float w_m[MHA_WARPS], w_l[MHA_WARPS];
  __shared__ int flag;
  extern __shared__ float merge_sm[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane / LP, li = lane % LP;
  const int valid = row_valid(f, b, Tn);
  const int k0 = split * f.chunk, k1 = min(valid, k0 + f.chunk);

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = NEG_INF, l = 0.f;
  if (k1 > k0) {
    const size_t row = (size_t)KV * D;  // elements per cached position
    const size_t pos0 = (((size_t)layer * 2) * B + b) * Tn;  // K's position 0
    const T* kp = cache + pos0 * row + (size_t)h * D + li * E;
    const T* vp = kp + (size_t)B * Tn * row;
    const float* ksp = QUANT ? scales + pos0 * KV + h : nullptr;
    const float* vsp = QUANT ? ksp + (size_t)B * Tn * KV : nullptr;
    const float scale = 1.0f / sqrtf((float)D);
    float qr[E];
    {
      const TQ* qp = q + ((size_t)b * KV + h) * D + li * E;
#pragma unroll
      for (int e = 0; e < E; ++e) qr[e] = to_f32(qp[e]);
    }
    // a step's K/V loads (and scales) land in registers; the next step's are
    // issued before this one's are used
    uint4 kr[MHA_U], vr[MHA_U];
    float ksv[MHA_U], vsv[MHA_U];
    auto load = [&](int base, uint4 (&kq)[MHA_U], uint4 (&vq)[MHA_U], float (&ks)[MHA_U],
                    float (&vs)[MHA_U]) {
#pragma unroll
      for (int u = 0; u < MHA_U; ++u) {
        const int t = base + (u * MHA_WARPS + warp) * P + gi;
        if (t < k1) {
          kq[u] = __ldg(reinterpret_cast<const uint4*>(kp + (size_t)t * row));
          vq[u] = __ldg(reinterpret_cast<const uint4*>(vp + (size_t)t * row));
          ks[u] = QUANT ? __ldg(ksp + (size_t)t * KV) : 1.f;
          vs[u] = QUANT ? __ldg(vsp + (size_t)t * KV) : 1.f;
        } else {
          kq[u] = vq[u] = make_uint4(0, 0, 0, 0);
          ks[u] = vs[u] = 0.f;
        }
      }
    };
    load(k0, kr, vr, ksv, vsv);
    for (int base = k0; base < k1; base += STEP) {
      uint4 nkr[MHA_U], nvr[MHA_U];
      float nks[MHA_U], nvs[MHA_U];
      load(base + STEP, nkr, nvr, nks, nvs);  // nothing past k1
      float s[MHA_U];
#pragma unroll
      for (int u = 0; u < MHA_U; ++u) {
        float kk[E];
        unpack(kr[u], kk);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[e] * kk[e];
        s[u] = dot;
      }
#pragma unroll
      for (int off = LP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < MHA_U; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float mx = m;
      bool ok[MHA_U];
#pragma unroll
      for (int u = 0; u < MHA_U; ++u) {
        ok[u] = base + (u * MHA_WARPS + warp) * P + gi < k1;
        s[u] = ok[u] ? s[u] * ksv[u] * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < MHA_U; ++u) {
        const float p = ok[u] ? expf(s[u] - mx) : 0.f;
        l += p;
        const float pv = p * vsv[u];
        float vv[E];
        unpack(vr[u], vv);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += pv * vv[e];
      }
      m = mx;
#pragma unroll
      for (int u = 0; u < MHA_U; ++u) {
        kr[u] = nkr[u];
        vr[u] = nvr[u];
        ksv[u] = nks[u];
        vsv[u] = nvs[u];
      }
    }
  }
  // merge the warp's lane groups (lanes li, li + LP, ...), then the warps
#pragma unroll
  for (int off = LP; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float M = fmaxf(m, mo), wa = expf(m - M), wb = expf(mo - M);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = acc[e] * wa + __shfl_xor_sync(0xffffffffu, acc[e], off) * wb;
    l = l * wa + lo * wb;
    m = M;
  }
  if (gi == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) w_acc[warp][li * E + e] = acc[e];
    if (li == 0) {
      w_m[warp] = m;
      w_l[warp] = l;
    }
  }
  __syncthreads();
  if (k1 > k0)
    for (int dd = threadIdx.x; dd < D; dd += THREADS) {
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
      const size_t pidx = ((size_t)b * KV + h) * f.ws + split;
      f.part_acc[pidx * D + dd] = A;
      if (dd == 0) {
        f.part_ml[2 * pidx] = M;
        f.part_ml[2 * pidx + 1] = Lsum;
      }
    }
  finish(f, q, b, h, B, KV, 1, D, 1, valid, &flag, merge_sm);
}

// G == 1 over several K/V heads takes decode_mha_kernel
__host__ __device__ constexpr bool is_mha(int KV, int G) { return G == 1 && KV > 1; }

template <typename T, typename TQ, int D>
cudaError_t launch(const void* cache, const void* scales, int layer, const void* q,
                   const Finish<TQ>& f, int B, int Tn, int KV, int G, cudaStream_t st) {
  // the merge's scratch; past 8 KB it may not fit beside partials_kernel's
  // static 33 KB without leave to take more than 48 KB
  const size_t smem = gq::merge_floats(G, f.ws, f.n_app) * sizeof(float);
  dim3 grid(f.n_split, KV, B);
  if (is_mha(KV, G)) {
    if (smem > 8 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(decode_mha_kernel<T, TQ, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    decode_mha_kernel<T, TQ, D><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(cache), static_cast<const float*>(scales), layer,
        static_cast<const TQ*>(q), f, B, Tn, KV);
  } else if constexpr (D <= 64) {
    if (smem > 8 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(partials_kernel<T, TQ, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    partials_kernel<T, TQ, D><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(cache), static_cast<const float*>(scales), layer,
        static_cast<const TQ*>(q), f, B, Tn, KV, G);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename TQ>
cudaError_t dispatch(int D, const void* cache, const void* scales, int layer, const void* q,
                     const Finish<TQ>& f, int B, int Tn, int KV, int G, cudaStream_t st) {
  if (D == 32) return launch<T, TQ, 32>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  if (D == 64) return launch<T, TQ, 64>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  if (D == 128) return launch<T, TQ, 128>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The whole decode attention of one layer in one launch: G == 1 with KV > 1
// runs decode_mha_kernel (D 32 / 64 / 128), any other group partials_kernel
// (D 32 / 64, chunk 64). cache (L, 2, B, T, KV, D) contiguous, cache_kind
// 0 = f32, 1 = bf16, 2 = int8 codes with scales (L, 2, B, T, KV) f32
// contiguous (null otherwise); q (B, KV, G, D) contiguous, in the cache's
// dtype for kinds 0 and 1 and f32 or bf16 (q_bf16) for kind 2. Row b
// attends cache positions below valid_vec[b] + valid (valid_vec (B,) int32
// on the device, or null), split into n_split splits of `chunk` positions;
// then the append block app (2, B, n_app, KV, D) in q's dtype (null with
// n_app = 0), of which the first app_valid entries are real. Writes out
// (B, KV, G, D) in q's dtype, or, with out null, the merged acc (B, KV, G, D),
// m and l (B, KV, G) in f32. part_acc (B, KV, ws, G, D), part_ml (B, KV, ws,
// G, 2) f32 and counters (B, KV) int32, zero on entry and on return, are the
// caller's workspace (ws >= n_split).
extern "C" int gq_decode(const void* cache, int cache_kind, const void* scales, int layer,
                         const void* q, int q_bf16, const void* valid_vec, int valid,
                         const void* app, int n_app, int app_valid, void* out, void* acc, void* m,
                         void* l, void* part_acc, void* part_ml, void* counters, int L, int B,
                         int Tn, int KV, int G, int D, int n_split, int chunk, int ws,
                         void* stream) {
  const bool mha = is_mha(KV, G);
  if (layer < 0 || layer >= L || B < 1 || KV < 1 || G < 1 || G > THREADS || n_split < 1 ||
      n_split > ws || (!mha && chunk != CT) || chunk < 1 || (D != 32 && D != 64 && D != 128) ||
      (D == 128 && !mha) || (cache_kind == 2) != (scales != nullptr) || n_app < 0 ||
      app_valid < 0 || app_valid > n_app || (n_app > 0) != (app != nullptr) ||
      (n_app > 0 && app_valid < 1) || (out == nullptr) == (acc == nullptr) ||
      (acc == nullptr) != (m == nullptr) || (m == nullptr) != (l == nullptr) || B > 65535 ||
      KV > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GQ_FIN(TQ)                                                                          \
  make_finish<TQ>(valid_vec, valid, app, n_app, app_valid, out, acc, m, l, part_acc, part_ml, \
                  counters, n_split, chunk, ws)
  if (cache_kind == 0 && !q_bf16)
    return dispatch<float, float>(D, cache, scales, layer, q, GQ_FIN(float), B, Tn, KV, G, st);
  if (cache_kind == 1 && q_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(D, cache, scales, layer, q,
                                                  GQ_FIN(__nv_bfloat16), B, Tn, KV, G, st);
  if (cache_kind == 2 && q_bf16)
    return dispatch<int8_t, __nv_bfloat16>(D, cache, scales, layer, q, GQ_FIN(__nv_bfloat16), B,
                                           Tn, KV, G, st);
  if (cache_kind == 2)
    return dispatch<int8_t, float>(D, cache, scales, layer, q, GQ_FIN(float), B, Tn, KV, G, st);
#undef GQ_FIN
  return cudaErrorInvalidValue;
}
