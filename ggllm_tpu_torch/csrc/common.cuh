// Helpers shared by the attention kernels: dtype conversion and staging of
// K/V rows (f32, bf16 or int8 codes) from device memory into shared memory
// as f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gq {

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

}  // namespace gq
