// Fused dequant x matmul (y = x @ W^T) for the ggml formats Q4_0, Q4_1,
// Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K and Q6_K, and per-group sums of x.
//
// Replaces the Pallas kernels ggllm_tpu/kernels/quant_matmul.py `_kern`
// (launched by fused_matmul_2d) and `_xg_kern` (launched by _group_sums).
//
// Weights are ggml's own row-major planar blocks (quant/planar.py): code
// planes qs / qh / ql / hmask as ggml packs them, fp16 d (and m or dmin),
// int8 sub-scales sc / scm for K-quants (Q2_K: scb, a scale and a min nibble
// per byte). Both kernels keep the TPU kernel's correction form: with
// w = s_g * q - c_g in each scale group g,
//     y[s,o] = sum_g s_g * (sum_{j in g} q_j x[s,j]) - c_g * xg[s,g],
// f32 accumulation throughout; q is the unsigned code (signed for Q8_0).
//
// One trait per format (Fmt<F>) loads the bytes a 32-element group needs
// (load), yields the code of element i of the group (code), and the scale
// and correction of each of its scale groups (scale, corr: one 32-group, or
// two 16-groups for Q2_K, Q3_K and Q6_K):
//   legacy  s = d;          c = 8d (Q4_0), 16d (Q5_0), -m (Q4_1/Q5_1), 0 (Q8_0)
//   Q4_K/Q5_K s = d * sc;   c = dmin * scm   (products in f32, as k_quants.c)
//   Q6_K    s = d * sc;     c = 32 s         (16-element groups, signed sc)
//   Q3_K    s = d * sc;     c = 4 s          (16-element groups, signed sc;
//                                             code = two | hmask bit << 2)
//   Q2_K    s = d * (scb & 15); c = dmin * (scb >> 4)   (16-element groups)
// Element order within a 32-group: legacy blocks split each byte's nibbles
// between elements j and j + 16; a K-quant 64-element chunk keeps elements
// 0-31 in the low nibbles and 32-63 in the high ones (so 32-group 2j+h of a
// super-block reads nibble h of chunk j's 32 bytes, and Q5_K its qh bit
// 2j+h); Q6_K's 128-halves hold four 32-strips, strip l in nibble l/2 of
// ql bytes [64 half + 32 (l%2), +32) with qh bits 2l; Q2_K's and Q3_K's
// 128-halves hold four 32-strips too, strip l in bits 2l of qs bytes
// [32 half, +32), and Q3_K's third bit of 32-group m of a super-block is bit
// m of all 32 hmask bytes.
//
// What bounds it on an H100 (S = 1, decode, runs the GEMVs of
// csrc/quant_gemv_legacy.cu and csrc/quant_gemv_kq.cu, which this entry point
// refuses):
//  * S > 1 (prefill) is bound by operations. bf16 x runs on the tensor
//    cores (quant_gemm_tc.cuh). f32 x, which has to stay within f32 accuracy,
//    runs this plain SIMT tile (64 x 64 outputs, 4 x 4 per thread, one
//    32-group per K step) that decodes the W tile's codes into shared
//    memory; it is built for f32 x only. The group sums come from
//    group_sums_kernel (S >= 256) or the caller.
//  * group sums: one thread per (row, group), 16-byte vector loads; bound by
//    the bytes of x.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

using gq::ld16;
using gq::store;
using gq::to_f32;
using gq::word;

constexpr int GROUP = 32;       // elements per tile K step
constexpr int BM = 64, BN = 64; // prefill tile: x rows x W rows

// ggml type ids (ggml.h)
enum : int {
  Q4_0 = 2, Q4_1 = 3, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8,
  Q2_K = 10, Q3_K = 11, Q4_K = 12, Q5_K = 13, Q6_K = 14
};

struct Planes {
  const uint8_t* qs;  // Q6_K: ql
  const void* qh;     // Q5_0/Q5_1: one uint32 per block; Q5_K/Q6_K: bytes; Q3_K: hmask
  const __half* d;
  const __half* m;    // Q4_1/Q5_1: m; Q4_K/Q5_K: dmin
  const int8_t* sc;   // Q2_K: scb, unsigned bytes (scale | min << 4)
  const int8_t* scm;
  int nb;             // blocks (legacy) or super-blocks (K-quants) per row
};

// byte i of 16 (or 32, as two vectors); with a constant i the selects fold
__device__ __forceinline__ uint32_t byte16(const uint4& v, int i) {
  return (word(v, (i >> 2) & 3) >> (8 * (i & 3))) & 0xFFu;
}
__device__ __forceinline__ uint32_t byte32(const uint4 (&v)[2], int i) {
  // select the word by value: a select of v[0] / v[1] themselves would put
  // v in local memory when i is not a constant (the tile's decode)
  const uint32_t a = word(v[0], (i >> 2) & 3), b = word(v[1], (i >> 2) & 3);
  return (((i & 16) ? b : a) >> (8 * (i & 3))) & 0xFFu;
}

// -------------------------------------------------------- format traits
// load(p, row, g, r): the bytes and scales of 32-group g of `row`;
// code(r, g, i): element i's code; scale/corr(r, k): scale group k's s, c.

template <int F>
struct Legacy {  // Q4_0, Q4_1, Q5_0, Q5_1: one 32-block per group
  static constexpr int SUB = 32;
  static constexpr bool CORR = true;
  static constexpr bool HAS_MIN = F == Q4_1 || F == Q5_1;
  static constexpr bool HIGH = F == Q5_0 || F == Q5_1;
  struct Raw {
    uint4 q;
    uint32_t h;
    float d, m;
  };
  __device__ static void load(const Planes& p, int row, int g, Raw& r) {
    const size_t blk = (size_t)row * p.nb + g;
    r.q = ld16(p.qs + blk * 16);
    r.d = __half2float(p.d[blk]);
    r.m = HAS_MIN ? __half2float(p.m[blk]) : 0.f;
    r.h = HIGH ? __ldg(static_cast<const uint32_t*>(p.qh) + blk) : 0u;
  }
  __device__ static float code(const Raw& r, int, int i) {
    const uint32_t b = byte16(r.q, i & 15);
    uint32_t q = (i & 16) ? (b >> 4) : (b & 0xFu);
    if (HIGH) q |= ((r.h >> i) & 1u) << 4;
    return (float)q;
  }
  __device__ static float scale(const Raw& r, int) { return r.d; }
  __device__ static float corr(const Raw& r, int) {
    return HAS_MIN ? -r.m : (HIGH ? 16.f : 8.f) * r.d;
  }
};

struct Q8 {  // Q8_0: 32 signed bytes per block, no correction
  static constexpr int SUB = 32;
  static constexpr bool CORR = false;
  struct Raw {
    uint4 q[2];
    float d;
  };
  __device__ static void load(const Planes& p, int row, int g, Raw& r) {
    const size_t blk = (size_t)row * p.nb + g;
    r.q[0] = ld16(p.qs + blk * 32);
    r.q[1] = ld16(p.qs + blk * 32 + 16);
    r.d = __half2float(p.d[blk]);
  }
  __device__ static float code(const Raw& r, int, int i) {
    return (float)static_cast<int8_t>(byte32(r.q, i));
  }
  __device__ static float scale(const Raw& r, int) { return r.d; }
  __device__ static float corr(const Raw&, int) { return 0.f; }
};

template <int F>
struct KQ45 {  // Q4_K, Q5_K: 32-group g = 8 sb + 2j + h of super-block sb
  static constexpr int SUB = 32;
  static constexpr bool CORR = true;
  static constexpr bool HIGH = F == Q5_K;
  struct Raw {
    uint4 q[2], h[2];
    float s, c;
  };
  __device__ static void load(const Planes& p, int row, int g, Raw& r) {
    const int sub = g & 7;
    const size_t blk = (size_t)row * p.nb + (g >> 3);
    const uint8_t* qp = p.qs + blk * 128 + (sub >> 1) * 32;  // chunk j's 32 bytes
    r.q[0] = ld16(qp);
    r.q[1] = ld16(qp + 16);
    if (HIGH) {
      const uint8_t* hp = static_cast<const uint8_t*>(p.qh) + blk * 32;
      r.h[0] = ld16(hp);
      r.h[1] = ld16(hp + 16);
    } else {
      r.h[0] = r.h[1] = make_uint4(0, 0, 0, 0);
    }
    r.s = __half2float(p.d[blk]) * (float)p.sc[blk * 8 + sub];
    r.c = __half2float(p.m[blk]) * (float)p.scm[blk * 8 + sub];
  }
  __device__ static float code(const Raw& r, int g, int i) {
    uint32_t q = (byte32(r.q, i) >> (4 * (g & 1))) & 0xFu;
    if (HIGH) q |= ((byte32(r.h, i) >> (g & 7)) & 1u) << 4;  // qh bit 2j + h
    return (float)q;
  }
  __device__ static float scale(const Raw& r, int) { return r.s; }
  __device__ static float corr(const Raw& r, int) { return r.c; }
};

struct Q6K {  // Q6_K: 32-group g = 8 sb + 4 half + strip; two 16-groups each
  static constexpr int SUB = 16;
  static constexpr bool CORR = true;
  struct Raw {
    uint4 q[2], h[2];
    float s0, s1;
  };
  __device__ static void load(const Planes& p, int row, int g, Raw& r) {
    const int half = (g >> 2) & 1, strip = g & 3;
    const size_t blk = (size_t)row * p.nb + (g >> 3);
    const uint8_t* qp = p.qs + blk * 128 + half * 64 + (strip & 1) * 32;
    const uint8_t* hp = static_cast<const uint8_t*>(p.qh) + blk * 64 + half * 32;
    r.q[0] = ld16(qp);
    r.q[1] = ld16(qp + 16);
    r.h[0] = ld16(hp);
    r.h[1] = ld16(hp + 16);
    const float d = __half2float(p.d[blk]);
    const int8_t* scp = p.sc + blk * 16 + half * 8 + 2 * strip;
    r.s0 = d * (float)scp[0];
    r.s1 = d * (float)scp[1];
  }
  __device__ static float code(const Raw& r, int g, int i) {
    const int strip = g & 3;
    const uint32_t lo = (byte32(r.q, i) >> (4 * (strip >> 1))) & 0xFu;
    return (float)(lo | (((byte32(r.h, i) >> (2 * strip)) & 3u) << 4));
  }
  __device__ static float scale(const Raw& r, int k) { return k ? r.s1 : r.s0; }
  __device__ static float corr(const Raw& r, int k) { return 32.f * (k ? r.s1 : r.s0); }
};

template <int F>
struct KQ23 {  // Q2_K, Q3_K: 32-group g = 8 sb + 4 half + strip; two 16-groups each
  static constexpr int SUB = 16;
  static constexpr bool CORR = true;
  static constexpr bool HIGH = F == Q3_K;
  struct Raw {
    uint4 q[2], h[2];
    float s0, s1, c0, c1;  // c0, c1: Q2_K only (Q3_K's correction is 4 s)
  };
  __device__ static void load(const Planes& p, int row, int g, Raw& r) {
    const int half = (g >> 2) & 1, strip = g & 3;
    const size_t blk = (size_t)row * p.nb + (g >> 3);
    const uint8_t* qp = p.qs + blk * 64 + half * 32;  // the half's 32 bytes
    r.q[0] = ld16(qp);
    r.q[1] = ld16(qp + 16);
    const float d = __half2float(p.d[blk]);
    const size_t k = blk * 16 + half * 8 + 2 * strip;  // first of the two 16-groups
    if (HIGH) {
      const uint8_t* hp = static_cast<const uint8_t*>(p.qh) + blk * 32;
      r.h[0] = ld16(hp);
      r.h[1] = ld16(hp + 16);
      r.s0 = d * (float)p.sc[k];  // signed, -32..31
      r.s1 = d * (float)p.sc[k + 1];
      r.c0 = r.c1 = 0.f;
    } else {
      r.h[0] = r.h[1] = make_uint4(0, 0, 0, 0);
      const uint8_t* scb = reinterpret_cast<const uint8_t*>(p.sc);
      const float dmin = __half2float(p.m[blk]);
      const uint32_t b0 = scb[k], b1 = scb[k + 1];
      r.s0 = d * (float)(b0 & 0xFu);
      r.s1 = d * (float)(b1 & 0xFu);
      r.c0 = dmin * (float)(b0 >> 4);
      r.c1 = dmin * (float)(b1 >> 4);
    }
  }
  __device__ static float code(const Raw& r, int g, int i) {
    uint32_t q = (byte32(r.q, i) >> (2 * (g & 3))) & 3u;
    if (HIGH) q |= ((byte32(r.h, i) >> (g & 7)) & 1u) << 2;  // hmask bit 4 half + strip
    return (float)q;
  }
  __device__ static float scale(const Raw& r, int k) { return k ? r.s1 : r.s0; }
  __device__ static float corr(const Raw& r, int k) {
    return HIGH ? 4.f * (k ? r.s1 : r.s0) : (k ? r.c1 : r.c0);
  }
};

template <int F> struct Fmt : Legacy<F> {};
template <> struct Fmt<Q2_K> : KQ23<Q2_K> {};
template <> struct Fmt<Q3_K> : KQ23<Q3_K> {};
template <> struct Fmt<Q8_0> : Q8 {};
template <> struct Fmt<Q4_K> : KQ45<Q4_K> {};
template <> struct Fmt<Q5_K> : KQ45<Q5_K> {};
template <> struct Fmt<Q6_K> : Q6K {};

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

// ------------------------------------------------------------ tiled (S > 1)
template <int F, typename TX, typename TY>
__global__ void __launch_bounds__(256)
quant_gemm(const TX* __restrict__ x, const Planes p, const float* __restrict__ xg,
           TY* __restrict__ y, int S, int K, int O) {
  using Q = Fmt<F>;
  constexpr int SUB = Q::SUB, NSEG = GROUP / SUB;
  __shared__ __align__(16) float xs[GROUP][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float ws[GROUP][BN + 4];  // codes, transposed
  __shared__ float ssm[NSEG][BN], csm[NSEG][BN];     // per-row scale, correction
  __shared__ float xgs[NSEG][BM];
  const int ng = K / GROUP;
  const int s0 = blockIdx.y * BM, o0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  for (int g = 0; g < ng; ++g) {
    for (int i = tid; i < BM * GROUP; i += 256) {
      const int s = i / GROUP, j = i % GROUP;
      xs[j][s] = (s0 + s < S) ? to_f32(x[(size_t)(s0 + s) * K + g * GROUP + j]) : 0.f;
    }
    {  // four threads per W row, eight codes each
      const int r = tid / 4, part = tid % 4;
      const bool ok = o0 + r < O;
      typename Q::Raw raw{};
      if (ok) Q::load(p, o0 + r, g, raw);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) ws[part * 8 + ii][r] = Q::code(raw, g, part * 8 + ii);
      if (part < NSEG) {
        ssm[part][r] = ok ? Q::scale(raw, part) : 0.f;
        csm[part][r] = ok ? Q::corr(raw, part) : 0.f;
      }
    }
    if (Q::CORR && tid < NSEG * BM) {
      const int s = tid % BM, k = tid / BM;
      xgs[k][s] = (s0 + s < S) ? xg[(size_t)(s0 + s) * ng * NSEG + g * NSEG + k] : 0.f;
    }
    __syncthreads();

    float dot[NSEG][4][4];
#pragma unroll
    for (int k = 0; k < NSEG; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[k][i][c] = 0.f;
#pragma unroll
    for (int k = 0; k < NSEG; ++k) {
#pragma unroll 8
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = k * SUB + jj;
        const float4 a = *reinterpret_cast<const float4*>(&xs[j][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[j][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[k][i][c] += av[i] * bv[c];
      }
    }
#pragma unroll
    for (int k = 0; k < NSEG; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xgv = Q::CORR ? xgs[k][ty * 4 + i] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c] += ssm[k][tx * 4 + c] * dot[k][i][c];
          if (Q::CORR) acc[i][c] -= csm[k][tx * 4 + c] * xgv;
        }
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = o0 + tx * 4 + c;
      if (o < O) store(y + (size_t)s * O + o, acc[i][c]);
    }
  }
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

template <int F, typename TX, typename TY>
cudaError_t launch_matmul(const void* x, const Planes& p, const void* xg, void* y, int S,
                          int K, int O, cudaStream_t st) {
  if (Fmt<F>::CORR && xg == nullptr) return cudaErrorInvalidValue;
  dim3 grid((O + BN - 1) / BN, (S + BM - 1) / BM);
  quant_gemm<F, TX, TY><<<grid, 256, 0, st>>>(static_cast<const TX*>(x), p,
                                              static_cast<const float*>(xg),
                                              static_cast<TY*>(y), S, K, O);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t dispatch(int gtype, const void* x, const Planes& p, const void* xg, void* y, int S,
                     int K, int O, cudaStream_t st) {
  switch (gtype) {
    case Q4_0: return launch_matmul<Q4_0, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q4_1: return launch_matmul<Q4_1, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q5_0: return launch_matmul<Q5_0, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q5_1: return launch_matmul<Q5_1, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q8_0: return launch_matmul<Q8_0, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q2_K: return launch_matmul<Q2_K, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q3_K: return launch_matmul<Q3_K, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q4_K: return launch_matmul<Q4_K, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q5_K: return launch_matmul<Q5_K, TX, TY>(x, p, xg, y, S, K, O, st);
    case Q6_K: return launch_matmul<Q6_K, TX, TY>(x, p, xg, y, S, K, O, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (S, O) = x (S, K) @ W^T from the planes of a ggml-type `gtype` weight
// (null for planes the format lacks; qs holds Q6_K's ql, qh Q3_K's hmask, m
// holds dmin, sc Q2_K's scb); xg (S, K/16 for Q2_K, Q3_K and Q6_K, else K/32)
// f32 group sums of x, required but for Q8_0. f32 x and S > 1 only: one row
// goes to gq_quant_gemv_legacy / gq_quant_gemv_kq, bf16 rows to
// gq_quant_matmul_tc.
extern "C" int gq_quant_matmul(int gtype, const void* x, int x_bf16, const void* qs,
                               const void* qh, const void* d, const void* m, const void* sc,
                               const void* scm, const void* xg, void* y, int y_bf16, int S,
                               int K, int O, void* stream) {
  const bool kq = gtype >= Q2_K && gtype <= Q6_K;
  if (x_bf16 || S < 2 || O < 1 || K % (kq ? 256 : GROUP) != 0) return cudaErrorInvalidValue;
  const Planes p{static_cast<const uint8_t*>(qs), qh, static_cast<const __half*>(d),
                 static_cast<const __half*>(m), static_cast<const int8_t*>(sc),
                 static_cast<const int8_t*>(scm), K / (kq ? 256 : GROUP)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return y_bf16 ? dispatch<float, __nv_bfloat16>(gtype, x, p, xg, y, S, K, O, st)
                : dispatch<float, float>(gtype, x, p, xg, y, S, K, O, st);
}

// xg (S, K/group) f32 = per-group sums of x (S, K), group 16 or 32; x rows
// 16-byte aligned.
extern "C" int gq_group_sums(const void* x, int x_bf16, void* xg, int S, int K, int group,
                             void* stream) {
  if (S < 1 || K % GROUP != 0 || (group != 16 && group != 32)) return cudaErrorInvalidValue;
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
