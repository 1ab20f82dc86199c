// Helpers shared by the kernels: the per-device grant of dynamic shared
// memory, dtype conversion, staging of K/V rows (f32, bf16 or int8 codes)
// from device memory into shared memory as f32, and the in-launch merge of
// the flash-decode kernels' time splits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gq {

constexpr int MAX_DEVICES = 64;

// Lets `kernel` launch with `bytes` of dynamic shared memory on the current
// device. cudaFuncSetAttribute acts on the current device only, so the
// grant is kept per device: `granted` is the caller's record for this
// kernel (a static array of the launching function), raised as sizes grow.
template <typename Kernel>
inline cudaError_t grant_smem(Kernel* kernel, size_t bytes, size_t (&granted)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes > granted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    granted[dev] = bytes;
  }
  return cudaSuccess;
}

// a 16-byte read-only load, and word w (0-3) of it
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of T -> f32 at dst (16-byte aligned)
__device__ __forceinline__ void unpack16(const uint4& v, float* dst, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                  __uint_as_float(v.w));
}
__device__ __forceinline__ void unpack16(const uint4& v, float* dst, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

// 16 int8 codes -> 16 floats
__device__ __forceinline__ void unpack16(const uint4& v, float* dst, int8_t) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4((float)c[i], (float)c[i + 1], (float)c[i + 2], (float)c[i + 3]);
}

// Stage ROWS rows of D elements of K and of V (row r at ksrc/vsrc + r *
// stride, 16-byte aligned) into ks/vs as f32; rows r >= n become zeros.
// All of a thread's 16-byte loads are issued before any is used, so the
// block keeps 2 * ROWS * D * sizeof(T) / (16 * THREADS) loads in flight per
// thread instead of waiting on one load at a time. blockDim.x == THREADS.
template <typename T, int ROWS, int D, int THREADS>
__device__ __forceinline__ void stage_kv(float (*ks)[D], float (*vs)[D], const T* __restrict__ ksrc,
                                         const T* __restrict__ vsrc, size_t stride, int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
  uint4 kb[ITERS], vb[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    if (i < TOTAL && r < n) {
      kb[it] = __ldg(reinterpret_cast<const uint4*>(ksrc + r * stride + c));
      vb[it] = __ldg(reinterpret_cast<const uint4*>(vsrc + r * stride + c));
    } else {
      kb[it] = make_uint4(0, 0, 0, 0);
      vb[it] = make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i < TOTAL) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
      unpack16(kb[it], &ks[r][c], T());
      unpack16(vb[it], &vs[r][c], T());
    }
  }
}

constexpr float NEG_INF = -1e30f;

// Every block of one (batch row, K/V head) calls this once, with all its
// threads, after writing its split's partial (or nothing): the partials are
// made visible device-wide, the block takes a ticket from the (row, head)'s
// counter, and only the last block to arrive gets true, after a fence that
// orders its reads of the others' partials (read with __ldcg) after their
// writes: a split-K reduction finished inside one launch.
__device__ __forceinline__ bool last_split(int* counter, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// Floats of shared memory that merge_splits needs.
__host__ __device__ constexpr size_t merge_floats(int G, int n_splits, int n_app) {
  return (size_t)(2 + 2 * n_splits) * G + (size_t)G * n_app;
}

// merge_splits' sum over the splits' acc, 4 columns at a time (D % 4 == 0;
// a row's partial is contiguous, so column block i of split s lies at
// s * R * D + 4 i): U blocks a thread, SU splits' loads issued before any is
// used; then the append block's P V and the output.
template <typename TQ, int U, int SU>
__device__ __forceinline__ void merge_columns(const float* part_acc, int R, int n_used, int G,
                                              int D, const TQ* __restrict__ va, size_t app_step,
                                              int n_app, int app_valid, TQ* __restrict__ out,
                                              float* __restrict__ acc_out, const float* sL,
                                              const float* sW, const float* sP) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n4 = G * D / 4;
  for (int i0 = tid; i0 < n4; i0 += U * nt) {
    float4 A[U];
    int gj[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      A[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      gj[j] = min(i0 + j * nt, n4 - 1) * 4 / D;
    }
    for (int s0 = 0; s0 < n_used; s0 += SU) {
      float4 v[SU][U];
#pragma unroll
      for (int k = 0; k < SU; ++k) {  // past the last split: reloads it, weighed by nothing
        const float4* src =
            reinterpret_cast<const float4*>(part_acc + (size_t)min(s0 + k, n_used - 1) * R * D);
#pragma unroll
        for (int j = 0; j < U; ++j) v[k][j] = __ldcg(src + min(i0 + j * nt, n4 - 1));
      }
#pragma unroll
      for (int k = 0; k < SU; ++k) {
        if (s0 + k < n_used) {
#pragma unroll
          for (int j = 0; j < U; ++j) {
            const float w = sW[(size_t)(s0 + k) * G + gj[j]];
            A[j].x += w * v[k][j].x;
            A[j].y += w * v[k][j].y;
            A[j].z += w * v[k][j].z;
            A[j].w += w * v[k][j].w;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * nt;
      if (i < n4) {
        const int g = gj[j], d0 = 4 * i - g * D;
        float a[4] = {A[j].x, A[j].y, A[j].z, A[j].w};
        for (int e2 = 0; e2 < app_valid; ++e2) {
          const float p = sP[(size_t)g * n_app + e2];
          const TQ* vr = va + e2 * app_step + d0;
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] += p * to_f32(vr[e]);
        }
        if (out) {
          const float inv = 1.0f / fmaxf(sL[g], 1e-30f);
#pragma unroll
          for (int e = 0; e < 4; ++e) store(out + 4 * i + e, a[e] * inv);
        } else {
          *reinterpret_cast<float4*>(acc_out + 4 * i) = make_float4(a[0], a[1], a[2], a[3]);
        }
      }
    }
  }
}

// The last block's merge for one (batch row, K/V head), all threads: the
// partials (acc, m, l) of splits 0..n_used-1 (slot s of row r: acc at
// part_acc + (s * R + r) * D, m and l at part_ml + 2 * (s * R + r)), then
// the append block (row a of K at ka + a * app_step, of V at va + ...; the
// first app_valid of n_app entries are real) against the G query rows q
// (r * D), merged with the partial-softmax algebra. Writes out (G, D) =
// acc / max(l, 1e-30) in q's dtype, or (out null) the merged acc (G, D),
// m and l (G). sm: merge_floats(G, n_used, n_app) floats. Every load from
// the workspace is independent of the others, so they are all issued
// before the values are combined.
template <typename TQ>
__device__ void merge_splits(const float* part_acc, const float* part_ml, int R, int n_used,
                             int G, int D, const TQ* __restrict__ q, const TQ* __restrict__ ka,
                             const TQ* __restrict__ va, size_t app_step, int n_app,
                             int app_valid, TQ* __restrict__ out, float* __restrict__ acc_out,
                             float* __restrict__ m_out, float* __restrict__ l_out, float* sm) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* sM = sm;                          // (G) row maxima
  float* sL = sM + G;                      // (G) row sums
  float* sW = sL + G;                      // (n_used, G) the splits' m, then their weights
  float* sl = sW + (size_t)n_used * G;     // (n_used, G) the splits' l
  float* sP = sl + (size_t)n_used * G;     // (G, n_app) append scores, then probabilities
  const float scale = 1.0f / sqrtf((float)D);
#pragma unroll 4
  for (int i = tid; i < n_used * G; i += nt) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + (size_t)(i / G) * R + i % G);
    sW[i] = ml.x;
    sl[i] = ml.y;
  }
  for (int i = tid; i < G * n_app; i += nt) {
    const int g = i / n_app, a = i % n_app;
    float dot = NEG_INF;
    if (a < app_valid) {
      dot = 0.f;
      for (int d = 0; d < D; ++d) dot += to_f32(q[(size_t)g * D + d]) * to_f32(ka[a * app_step + d]);
      dot *= scale;
    }
    sP[i] = dot;
  }
  __syncthreads();
  for (int g = tid; g < G; g += nt) {
    float M = NEG_INF;
    for (int s = 0; s < n_used; ++s) M = fmaxf(M, sW[(size_t)s * G + g]);
    for (int a = 0; a < app_valid; ++a) M = fmaxf(M, sP[(size_t)g * n_app + a]);
    float L = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const float w = expf(sW[(size_t)s * G + g] - M);
      sW[(size_t)s * G + g] = w;
      L += w * sl[(size_t)s * G + g];
    }
    for (int a = 0; a < n_app; ++a) {
      const float p = a < app_valid ? expf(sP[(size_t)g * n_app + a] - M) : 0.f;
      sP[(size_t)g * n_app + a] = p;
      L += p;
    }
    sM[g] = M;
    sL[g] = L;
  }
  __syncthreads();
  // acc: with at least four column blocks a thread (G * D / 4 >= 4 nt) a
  // thread takes 4 blocks and 4 splits at a time, else 1 block and 16
  // splits: 16 loads in flight a thread either way
  if (G * D >= 16 * nt)
    merge_columns<TQ, 4, 4>(part_acc, R, n_used, G, D, va, app_step, n_app, app_valid, out,
                            acc_out, sL, sW, sP);
  else
    merge_columns<TQ, 1, 16>(part_acc, R, n_used, G, D, va, app_step, n_app, app_valid, out,
                             acc_out, sL, sW, sP);
  if (!out)
    for (int g = tid; g < G; g += nt) {
      m_out[g] = sM[g];
      l_out[g] = sL[g];
    }
}

// Where one flash-decode launch's output goes and what it merges; the same
// for the kernels of flash_decode.cu and flash_decode_tc.cu.
template <typename TQ>
struct Finish {
  const int* valid_vec;  // (B,) int32 or null
  int valid_add;         // added to valid_vec[b] (or the length of every row)
  const TQ* app;         // (2, B, n_app, KV, D) or null
  int n_app, app_valid;
  TQ* out;               // (B, KV, G, D) normalized, or null:
  float *acc, *m, *l;    // the merged partials (B, KV, G, D), (B, KV, G)
  float *part_acc, *part_ml;  // workspace: (B, KV, ws, R, D), (B, KV, ws, R, 2)
  int* counters;         // (B, KV), zero between launches
  int n_split, chunk, ws;
};

// Row b's valid length, clamped to what the cache and the grid cover
template <typename TQ>
__device__ __forceinline__ int row_valid(const Finish<TQ>& f, int b, int Tn) {
  const int v = (f.valid_vec ? f.valid_vec[b] : 0) + f.valid_add;
  return max(0, min(v, min(Tn, f.n_split * f.chunk)));
}

// After a block's partial: the ticket, then (last block only) the merge of
// row b, K/V head kvh; sm holds merge_floats(G, ws, n_app) floats
template <typename TQ>
__device__ __forceinline__ void finish(const Finish<TQ>& f, const TQ* q, int b, int kvh, int B,
                                       int KV, int G, int D, int R, int valid, int* flag,
                                       float* sm) {
  const size_t bk = (size_t)b * KV + kvh;
  if (!last_split(f.counters + bk, flag)) return;
  const int n_used = min(f.n_split, (valid + f.chunk - 1) / f.chunk);
  const TQ* ka = f.app ? f.app + ((size_t)b * f.n_app * KV + kvh) * D : nullptr;
  const TQ* va = f.app ? ka + (size_t)B * f.n_app * KV * D : nullptr;
  merge_splits<TQ>(f.part_acc + bk * f.ws * R * D, f.part_ml + bk * f.ws * R * 2, R, n_used, G,
                       D, q + bk * G * D, ka, va, (size_t)KV * D, f.n_app, f.app_valid,
                       f.out ? f.out + bk * G * D : nullptr, f.acc ? f.acc + bk * G * D : nullptr,
                       f.m ? f.m + bk * G : nullptr, f.l ? f.l + bk * G : nullptr, sm);
  if (threadIdx.x == 0) f.counters[bk] = 0;
}

template <typename TQ>
Finish<TQ> make_finish(const void* valid_vec, int valid, const void* app, int n_app,
                       int app_valid, void* out, void* acc, void* m, void* l, void* part_acc,
                       void* part_ml, void* counters, int n_split, int chunk, int ws) {
  return Finish<TQ>{static_cast<const int*>(valid_vec), valid, static_cast<const TQ*>(app),
                    n_app, app_valid, static_cast<TQ*>(out), static_cast<float*>(acc),
                    static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(part_acc),
                    static_cast<float*>(part_ml), static_cast<int*>(counters), n_split, chunk, ws};
}

}  // namespace gq
