// Fused Q4_0 dequant x matmul (y = x @ W^T) and per-group sums of x.
//
// Replaces the Pallas kernels ggllm_tpu/kernels/quant_matmul.py `_kern`
// (launched by fused_matmul_2d) and `_xg_kern` (launched by _group_sums).
//
// Weights are ggml's own row-major planar Q4_0 blocks: qs (O, K/32, 16)
// uint8 in ggml's half-split nibble order (element j < 16 is the low nibble
// of byte j, element j >= 16 the high nibble of byte j - 16) and d (O, K/32)
// fp16. Both kernels keep the TPU kernel's correction form: the -8 offset
// never touches the per-element path,
//     y[s,o] = sum_g d[o,g] * (sum_j q[o,g,j] x[s,g,j] - 8 * xg[s,g]),
// with f32 accumulation throughout.
//
// What bounds it on an H100:
//  * S = 1 (decode) is a GEMV bound by the weight bytes (4.5 bits/weight):
//    the x vector is tiny. The GEMV gives each lane one 16-byte block of a
//    row per step, so a warp reads 512 contiguous bytes per row (coalesced,
//    16 bytes a lane); each warp walks GEMV_ROWS rows at once, so every x
//    value read from shared memory feeds GEMV_ROWS rows, and it loads the
//    next step's blocks before using this step's, so two steps of weight
//    bytes are in flight. x is staged once per block in shared memory as
//    f32 with 16-byte loads issued in batches, padded to 33 floats per
//    32-group so lanes on different groups hit different banks; the block
//    forms the group sums from that tile itself.
//  * S > 1 (prefill) is bound by operations. This first kernel is a plain
//    SIMT tile (64 x 64 outputs, 4 x 4 per thread, one 32-group per K step)
//    that dequantizes the W tile into shared memory; tensor cores (wgmma)
//    and TMA come in a later change. The group sums come from
//    gq_group_sums (S >= 256) or the caller.
//  * group sums: one thread per (row, group), 16-byte vector loads; bound by
//    the bytes of x.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

using gq::store;
using gq::to_f32;

constexpr int QK = 32;          // elements per Q4_0 block
constexpr int GEMV_WARPS = 8;   // warps per GEMV block
constexpr int GEMV_ROWS = 4;    // output rows per warp
constexpr int XPAD = QK + 1;    // smem floats per staged x group
constexpr int BM = 64, BN = 64; // prefill tile: x rows x W rows
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

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

// ---------------------------------------------------------------- GEMV (S=1)
template <typename TX, typename TY>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q4_0_gemv(const TX* __restrict__ x, const uint8_t* __restrict__ qs,
          const __half* __restrict__ d, TY* __restrict__ y, int K, int O) {
  extern __shared__ float smem[];
  const int nb = K / QK;
  float* xs = smem;              // nb * XPAD staged x values
  float* xg = smem + nb * XPAD;  // nb group sums
  {
    // 16-byte loads, STAGE_BATCH per thread in flight before any is used
    constexpr int VEC = 16 / sizeof(TX);
    constexpr int STAGE_BATCH = 4;
    const int nvec = K / VEC;  // K % 32 == 0, so vectors never straddle groups
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int base = 0; base < nvec; base += STAGE_BATCH * blockDim.x) {
      uint4 buf[STAGE_BATCH];
#pragma unroll
      for (int b = 0; b < STAGE_BATCH; ++b) {
        const int i = base + b * blockDim.x + threadIdx.x;
        buf[b] = i < nvec ? __ldg(xv + i) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int b = 0; b < STAGE_BATCH; ++b) {
        const int i = base + b * blockDim.x + threadIdx.x;
        if (i < nvec) {
          __align__(16) float f[8];
          gq::unpack16(buf[b], f, TX());
          const int k = i * VEC;
          float* dst = xs + (k / QK) * XPAD + (k % QK);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dst[e] = f[e];
        }
      }
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < nb; g += blockDim.x) {
    const float* xp = xs + g * XPAD;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < QK; ++j) s += xp[j];
    xg[g] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * GEMV_WARPS + warp) * GEMV_ROWS;
  float acc[GEMV_ROWS];
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r) acc[r] = 0.f;

  // software pipeline: the next step's blocks load while this step computes
  uint4 qn[GEMV_ROWS];
  float dn[GEMV_ROWS];
  auto load = [&](int g) {
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) {
      const int row = row0 + r;
      if (row < O && g < nb) {
        const size_t blk = (size_t)row * nb + g;
        qn[r] = __ldg(reinterpret_cast<const uint4*>(qs + blk * 16));
        dn[r] = __half2float(d[blk]);
      } else {
        qn[r] = make_uint4(0, 0, 0, 0);
        dn[r] = 0.f;
      }
    }
  };
  load(lane);
  for (int g = lane; g < nb; g += 32) {
    uint4 q[GEMV_ROWS];
    float dg[GEMV_ROWS];
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) {
      q[r] = qn[r];
      dg[r] = dn[r];
    }
    load(g + 32);
    const float* xp = xs + g * XPAD;
    float dot[GEMV_ROWS];
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) dot[r] = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float xlo = xp[w * 4 + b];
        const float xhi = xp[16 + w * 4 + b];
#pragma unroll
        for (int r = 0; r < GEMV_ROWS; ++r) {
          const uint32_t byte = (word(q[r], w) >> (8 * b)) & 0xFFu;
          dot[r] += float(byte & 0xFu) * xlo + float(byte >> 4) * xhi;
        }
      }
    }
    const float corr = 8.f * xg[g];
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) acc[r] += dg[r] * (dot[r] - corr);
  }
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && row0 + r < O) store(y + row0 + r, v);
  }
}

// ------------------------------------------------------------ tiled (S > 1)
template <typename TX, typename TY>
__global__ void __launch_bounds__(256)
q4_0_gemm(const TX* __restrict__ x, const uint8_t* __restrict__ qs,
          const __half* __restrict__ d, const float* __restrict__ xg,
          TY* __restrict__ y, int S, int K, int O) {
  __shared__ __align__(16) float xs[QK][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float ws[QK][BN + 4];  // nibble codes, transposed
  __shared__ float dsm[BN];
  __shared__ float xgs[BM];
  const int nb = K / QK;
  const int s0 = blockIdx.y * BM, o0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  for (int g = 0; g < nb; ++g) {
    for (int i = tid; i < BM * QK; i += 256) {
      const int s = i / QK, j = i % QK;
      xs[j][s] = (s0 + s < S) ? to_f32(x[(size_t)(s0 + s) * K + g * QK + j]) : 0.f;
    }
    {
      const int r = tid / 4, wd = tid % 4;
      uint32_t bits = 0;
      if (o0 + r < O)
        bits = __ldg(reinterpret_cast<const uint32_t*>(qs + ((size_t)(o0 + r) * nb + g) * 16) + wd);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (bits >> (8 * b)) & 0xFFu;
        ws[wd * 4 + b][r] = float(byte & 0xFu);
        ws[16 + wd * 4 + b][r] = float(byte >> 4);
      }
    }
    if (tid < BN) dsm[tid] = (o0 + tid < O) ? __half2float(d[(size_t)(o0 + tid) * nb + g]) : 0.f;
    if (tid < BM) xgs[tid] = (s0 + tid < S) ? xg[(size_t)(s0 + tid) * nb + g] : 0.f;
    __syncthreads();

    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dot[i][k] = 0.f;
#pragma unroll 8
    for (int j = 0; j < QK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[j][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[j][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) dot[i][k] += av[i] * bv[k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = 8.f * xgs[ty * 4 + i];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] += dsm[tx * 4 + k] * (dot[i][k] - corr);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= S) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = o0 + tx * 4 + k;
      if (o < O) store(y + (size_t)s * O + o, acc[i][k]);
    }
  }
}

// --------------------------------------------------------------- group sums
template <typename TX>
__global__ void __launch_bounds__(256)
group_sums_kernel(const TX* __restrict__ x, float* __restrict__ xg, int S, int K) {
  const int nb = K / QK;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)S * nb) return;
  const size_t s = idx / nb, g = idx % nb;
  const uint4* p = reinterpret_cast<const uint4*>(x + s * K + g * QK);
  constexpr int NV = QK * sizeof(TX) / 16;  // 16-byte vectors per group
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc += sum_vec(__ldg(p + i), TX());
  xg[idx] = acc;
}

template <typename TX, typename TY>
cudaError_t launch_matmul(const void* x, const void* qs, const void* d, const void* xg,
                          void* y, int S, int K, int O, cudaStream_t st) {
  if (S == 1) {
    const size_t smem = (size_t)(K / QK) * (XPAD + 1) * sizeof(float);
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(q4_0_gemv<TX, TY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    const int rows_per_block = GEMV_WARPS * GEMV_ROWS;
    q4_0_gemv<TX, TY><<<(O + rows_per_block - 1) / rows_per_block, GEMV_WARPS * 32, smem, st>>>(
        static_cast<const TX*>(x), static_cast<const uint8_t*>(qs),
        static_cast<const __half*>(d), static_cast<TY*>(y), K, O);
  } else {
    if (xg == nullptr) return cudaErrorInvalidValue;
    dim3 grid((O + BN - 1) / BN, (S + BM - 1) / BM);
    q4_0_gemm<TX, TY><<<grid, 256, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const uint8_t*>(qs),
        static_cast<const __half*>(d), static_cast<const float*>(xg),
        static_cast<TY*>(y), S, K, O);
  }
  return cudaGetLastError();
}

}  // namespace

// y (S, O) = x (S, K) @ W^T from Q4_0 planes; xg (S, K/32) f32 group sums
// of x, required for S > 1 and ignored for S == 1.
extern "C" int gq_q4_0_matmul(const void* x, int x_bf16, const void* qs, const void* d,
                              const void* xg, void* y, int y_bf16, int S, int K, int O,
                              void* stream) {
  if (S < 1 || K % QK != 0 || O < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return y_bf16 ? launch_matmul<__nv_bfloat16, __nv_bfloat16>(x, qs, d, xg, y, S, K, O, st)
                  : launch_matmul<__nv_bfloat16, float>(x, qs, d, xg, y, S, K, O, st);
  }
  return y_bf16 ? launch_matmul<float, __nv_bfloat16>(x, qs, d, xg, y, S, K, O, st)
                : launch_matmul<float, float>(x, qs, d, xg, y, S, K, O, st);
}

// xg (S, K/32) f32 = per-group sums of x (S, K); x rows 16-byte aligned.
extern "C" int gq_group_sums(const void* x, int x_bf16, void* xg, int S, int K, void* stream) {
  if (S < 1 || K % QK != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)S * (K / QK);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (x_bf16)
    group_sums_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xg), S, K);
  else
    group_sums_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(xg), S, K);
  return cudaGetLastError();
}
