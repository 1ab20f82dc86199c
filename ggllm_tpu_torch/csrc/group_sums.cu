// Per-group sums of x, the correction input of the f32 quant-matmul tile.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/quant_matmul.py `_xg_kern`
// (launched by _group_sums). The f32 tile (quant_gemm_f32.cuh) keeps the TPU
// kernel's correction form: with w = s_g * q - c_g in each scale group g,
//     y[s,o] = sum_g s_g * (sum_{j in g} q_j x[s,j]) - c_g * xg[s,g],
// and xg[s,g] = sum_{j in g} x[s,j] comes from here (S >= 256) or from the
// caller's plain reduce. Only the f32 tile takes group sums, so x is f32.
//
// What bounds it on an H100: the bytes of x, 4 an element (a sum writes 4
// bytes per 16 or 32 of them). A group never crosses a row (K is a multiple
// of the group), so x is read as one flat array of S * K floats whose group
// i is elements [i g, (i + 1) g):
//  * a lane reads 16-byte vectors at consecutive addresses, so one load
//    instruction of a warp covers 512 contiguous bytes: 4 groups of 32 or 8
//    of 16;
//  * the 8 or 4 lanes of a group add their vector's four floats
//    ((x0 + x1) + (x2 + x3)) and combine the lanes by __shfl_xor_sync (xor 1,
//    2, 4: a pairwise tree in lane order); one lane of each group writes the
//    group's sum (group_sums_emulated in kernels/quant_matmul.py restates
//    this order);
//  * each lane issues its U = 4 loads (a warp's U consecutive 512-byte spans)
//    before it sums any, and the grid is one warp per U spans: at S = 256,
//    K = 4544, 2272 warps in 284 blocks of 8, enough to fill 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 4;      // 512-byte spans a warp, all its loads in flight
constexpr int WARPS = 8;  // per block
constexpr int SPAN = 128; // floats a warp's load covers

template <int G>
__global__ void __launch_bounds__(32 * WARPS)
group_sums_kernel(const float* __restrict__ x, float* __restrict__ xg, size_t n) {
  constexpr int LANES = G / 4;  // lanes of a group
  const size_t warp = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const size_t e0 = warp * (U * SPAN) + 4 * lane;  // the lane's first element
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t e = e0 + (size_t)u * SPAN;  // n is a multiple of G: a group is in or out
    v[u] = e < n ? __ldg(reinterpret_cast<const float4*>(x + e)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float s = (v[u].x + v[u].y) + (v[u].z + v[u].w);
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const size_t e = e0 + (size_t)u * SPAN;
    if (lane % LANES == 0 && e < n) xg[e / G] = s;
  }
}

}  // namespace

// xg (S, K/group) f32 = per-group sums of f32 x (S, K), group 16 or 32, K a
// multiple of 32; x and xg contiguous, x 16-byte aligned.
extern "C" int gq_group_sums(const void* x, void* xg, int S, int K, int group, void* stream) {
  if (S < 1 || K < 32 || K % 32 != 0 || (group != 16 && group != 32) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)S * K;
  const size_t warps = (n + U * SPAN - 1) / (U * SPAN);
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  const float* xf = static_cast<const float*>(x);
  float* out = static_cast<float*>(xg);
  if (group == 16)
    group_sums_kernel<16><<<blocks, 32 * WARPS, 0, st>>>(xf, out, n);
  else
    group_sums_kernel<32><<<blocks, 32 * WARPS, 0, st>>>(xf, out, n);
  return cudaGetLastError();
}
