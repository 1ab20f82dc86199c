// Per-group sums of x, the correction input of the f32 quant-matmul tile.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/quant_matmul.py `_xg_kern`
// (launched by _group_sums). The f32 tile (quant_gemm_f32.cuh) keeps the TPU
// kernel's correction form: with w = s_g * q - c_g in each scale group g,
//     y[s,o] = sum_g s_g * (sum_{j in g} q_j x[s,j]) - c_g * xg[s,g],
// and xg[s,g] = sum_{j in g} x[s,j] comes from here (S >= 256) or from the
// caller's plain reduce.
//
// What bounds it on an H100: the bytes of x. One thread per (row, group),
// 16-byte vector loads, f32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sum_vec(const uint4& v, float) {
  return (__uint_as_float(v.x) + __uint_as_float(v.y)) +
         (__uint_as_float(v.z) + __uint_as_float(v.w));
}
__device__ __forceinline__ float sum_vec(const uint4& v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    s += f.x + f.y;
  }
  return s;
}

// --------------------------------------------------------------- group sums
template <typename TX, int G>
__global__ void __launch_bounds__(256)
group_sums_kernel(const TX* __restrict__ x, float* __restrict__ xg, int S, int K) {
  const int ng = K / G;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)S * ng) return;
  const size_t s = idx / ng, g = idx % ng;
  const uint4* p = reinterpret_cast<const uint4*>(x + s * K + g * G);
  constexpr int NV = G * sizeof(TX) / 16;  // 16-byte vectors per group
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc += sum_vec(__ldg(p + i), TX());
  xg[idx] = acc;
}

}  // namespace

// xg (S, K/group) f32 = per-group sums of x (S, K), group 16 or 32; x rows
// 16-byte aligned.
extern "C" int gq_group_sums(const void* x, int x_bf16, void* xg, int S, int K, int group,
                             void* stream) {
  if (S < 1 || K % 32 != 0 || (group != 16 && group != 32)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)S * (K / group);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  float* out = static_cast<float*>(xg);
  if (x_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (group == 16)
      group_sums_kernel<__nv_bfloat16, 16><<<blocks, 256, 0, st>>>(xb, out, S, K);
    else
      group_sums_kernel<__nv_bfloat16, 32><<<blocks, 256, 0, st>>>(xb, out, S, K);
  } else {
    const float* xf = static_cast<const float*>(x);
    if (group == 16)
      group_sums_kernel<float, 16><<<blocks, 256, 0, st>>>(xf, out, S, K);
    else
      group_sums_kernel<float, 32><<<blocks, 256, 0, st>>>(xf, out, S, K);
  }
  return cudaGetLastError();
}
