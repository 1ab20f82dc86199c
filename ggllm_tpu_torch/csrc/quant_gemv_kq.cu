// y (1, O) = x (1, K) @ W^T for the K-quant formats Q2_K, Q3_K, Q4_K, Q5_K
// and Q6_K: the decode GEMV (S = 1) of the fused dequant x matmul.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/quant_matmul.py `_kern`
// (launched by fused_matmul_2d) at one row of x for the K-quants; the legacy
// formats run csrc/quant_gemv_legacy.cu, more rows the tiles.
//
// Weights are ggml's planar blocks (quant/planar.py): per row and 256-element
// super-block the code plane qs (Q6_K: ql), the high-bit plane where the
// format has one (Q5_K qh, Q6_K qh, Q3_K hmask), fp16 d (and dmin), int8
// sub-scales sc / scm (Q2_K: scb, a scale nibble and a min nibble a byte).
// Per scale group g (32 wide for Q4_K / Q5_K, 16 for the others) the kernel
// forms s = d * sc and c = dmin * scm in f32 as the reference does, and
//   y = sum_g s_g * sum_{j in g} (q_j - off) x_j  -  c_g * sum_{j in g} x_j,
// with off = 4 (Q3_K) and 32 (Q6_K), whose corrections 4 s and 32 s are folded
// into the code exactly and need no sum of x; Q2_K, Q4_K and Q5_K pay c_g * sum x.
// kernels/quant_matmul.py gemv_lane_table states the index arithmetic below
// and gemv_emulated the sums, and the CPU tests hold both.
//
// The loop (csrc/gemv.cuh) is the legacy formats' too: lanes own 16 distinct
// code bytes of a super-block a step (a warp's load moves 512 distinct bytes:
// 4 super-blocks of Q4_K / Q5_K / Q6_K, 8 of Q2_K / Q3_K, plus the 16
// high-bit bytes of its columns and its sub-scales, one 2- or 8-byte load, and
// fp16 d / dmin); codes and sub-scales are decoded by PRMT into 2^23 + q and
// one FADD (a signed sub-scale with its sign bit flipped), so the loop holds
// no I2F; x comes through L1; no shared memory.

#include <cuda_fp16.h>

#include "gemv.cuh"

namespace {

using gq::code_f32;
using gq::half_f32;
using gq::ldw;
using gq::ldw16;
using gq::signed_byte_f32;
using gq::word;
using Planes = gq::GemvPlanes;

enum : int { Q2_K = 10, Q3_K = 11, Q4_K = 12, Q5_K = 13, Q6_K = 14 };  // ggml.h type ids
constexpr int KQ_DEPTH = 2;  // steps of row bytes in flight or in use a warp

// ------------------------------------------------------------ format traits
// (csrc/gemv.cuh states what a trait holds); a block is a super-block here

struct KQ45Lane {
  int j, b0;  // chunk (64 elements) and byte offset in it (0 / 16)
};

template <int F>
struct KQ45 {  // Q4_K, Q5_K: byte b0 + i of chunk j holds elements 64j + b0 + i, 64j + 32 + b0 + i
  static constexpr int QK = 256, LPS = 8, QB = 128, RUNS = 2, OFF = 0;
  static constexpr bool CORR = true, HIGH = F == Q5_K;
  // Q4_K's high nibble stays in place (bits 4-7: SH 2); Q5_K's is shifted
  // down to meet its fifth bit
  template <int U> static constexpr int SH = (U == 1 && !HIGH) ? 2 : 0;
  using Lane = KQ45Lane;
  struct Raw {
    uint4 q, h;
    uint16_t d, dmin, sc2, scm2;
  };
  __device__ static Lane lane(int p) { return Lane{p >> 1, 16 * (p & 1)}; }
  __device__ static void load(const Planes& P, size_t blk, const Lane& L, int p, Raw& r) {
    r.q = ldw16(P.qs + blk * QB + 16 * p);
    if (HIGH) r.h = ldw16(P.qh + blk * 32 + L.b0);
    r.d = ldw(reinterpret_cast<const uint16_t*>(P.d) + blk);
    r.dmin = ldw(reinterpret_cast<const uint16_t*>(P.m) + blk);
    r.sc2 = ldw(reinterpret_cast<const uint16_t*>(P.sc + blk * 8 + 2 * L.j));
    r.scm2 = ldw(reinterpret_cast<const uint16_t*>(P.scm + blk * 8 + 2 * L.j));
  }
  __device__ static int xoff(const Lane& L, int u) { return 64 * L.j + 32 * u + L.b0; }
  template <int U>
  __device__ static uint32_t code4(const Raw& r, const Lane& L, int w) {
    if (!HIGH) return word(r.q, w) & (U ? 0xF0F0F0F0u : 0x0F0F0F0Fu);
    return ((word(r.q, w) >> (4 * U)) & 0x0F0F0F0Fu) |
           (((word(r.h, w) >> (2 * L.j + U)) & 0x01010101u) << 4);  // qh bit 2j + u
  }
  __device__ static float scale(const Raw& r, const Lane&, int u) {
    return half_f32(r.d) * code_f32<0, 0>(r.sc2, u);
  }
  __device__ static float corr(const Raw& r, const Lane&, int u) {
    return half_f32(r.dmin) * code_f32<0, 0>(r.scm2, u);
  }
};

struct Q6KLane {
  int half, part, i0;  // 128-half, low (0) or high (1) 32 ql bytes of it, column 0 / 16
};

struct Q6K {  // ql byte 64 half + 32 part + i: strip part (low nibble) and part + 2 (high)
  static constexpr int QK = 256, LPS = 8, QB = 128, RUNS = 2, OFF = 32;
  static constexpr bool CORR = false;
  template <int U> static constexpr int SH = 0;
  using Lane = Q6KLane;
  struct Raw {
    uint4 q, h;
    uint2 sc;  // the half's 8 sub-scales
    uint16_t d;
  };
  __device__ static Lane lane(int p) { return Lane{p >> 2, (p >> 1) & 1, 16 * (p & 1)}; }
  __device__ static void load(const Planes& P, size_t blk, const Lane& L, int p, Raw& r) {
    r.q = ldw16(P.qs + blk * QB + 16 * p);
    r.h = ldw16(P.qh + blk * 64 + 32 * L.half + L.i0);
    r.sc = ldw(reinterpret_cast<const uint2*>(P.sc + blk * 16 + 8 * L.half));
    r.d = ldw(reinterpret_cast<const uint16_t*>(P.d) + blk);
  }
  __device__ static int xoff(const Lane& L, int u) {
    return 128 * L.half + 32 * (L.part + 2 * u) + L.i0;
  }
  template <int U>
  __device__ static uint32_t code4(const Raw& r, const Lane& L, int w) {
    // qh bits 2 strip = 2 part + 4u of each byte, moved to bits 4-5
    const uint32_t h = word(r.h, w) >> (2 * L.part);
    const uint32_t hi = U ? (h & 0x30303030u) : ((h << 4) & 0x30303030u);
    return ((word(r.q, w) >> (4 * U)) & 0x0F0F0F0Fu) | hi;
  }
  __device__ static float scale(const Raw& r, const Lane& L, int u) {
    // sub-scale 8 half + 2 strip + i0 / 16: byte 2 part + (i0 / 16) of word u
    const int b = 2 * L.part + (L.i0 >> 4);
    return half_f32(r.d) * signed_byte_f32(u ? r.sc.y : r.sc.x, b);
  }
  __device__ static float corr(const Raw&, const Lane&, int) { return 0.f; }
};

struct KQ23Lane {
  int half, i0;  // 128-half, column 0 / 16
};

template <int F>
struct KQ23 {  // Q2_K, Q3_K: qs byte 32 half + i holds strips 0-3 (bits 2u) of the half
  static constexpr int QK = 256, LPS = 4, QB = 64, RUNS = 4, OFF = F == Q3_K ? 4 : 0;
  static constexpr bool CORR = F == Q2_K, HIGH = F == Q3_K;
  // Q2_K's strip u stays in place (bits 2u: SH u); Q3_K's is shifted down to
  // meet its third bit
  template <int U> static constexpr int SH = HIGH ? 0 : U;
  using Lane = KQ23Lane;
  struct Raw {
    uint4 q, h;
    uint2 sc;  // the half's 8 sub-scales (Q2_K: scale | min << 4)
    uint16_t d, dmin;
  };
  __device__ static Lane lane(int p) { return Lane{p >> 1, 16 * (p & 1)}; }
  __device__ static void load(const Planes& P, size_t blk, const Lane& L, int p, Raw& r) {
    r.q = ldw16(P.qs + blk * QB + 16 * p);
    if (HIGH) r.h = ldw16(P.qh + blk * 32 + L.i0);
    r.sc = ldw(reinterpret_cast<const uint2*>(P.sc + blk * 16 + 8 * L.half));
    r.d = ldw(reinterpret_cast<const uint16_t*>(P.d) + blk);
    if (!HIGH) r.dmin = ldw(reinterpret_cast<const uint16_t*>(P.m) + blk);
  }
  __device__ static int xoff(const Lane& L, int u) { return 128 * L.half + 32 * u + L.i0; }
  template <int U>
  __device__ static uint32_t code4(const Raw& r, const Lane& L, int w) {
    if (!HIGH) return word(r.q, w) & (0x03030303u << (2 * U));
    const uint32_t h = word(r.h, w) >> (4 * L.half);  // hmask bit 4 half + u, moved to bit 2
    return ((word(r.q, w) >> (2 * U)) & 0x03030303u) |
           ((U <= 2 ? (h << (2 - U)) : (h >> (U - 2))) & 0x04040404u);
  }
  // sub-scale 8 half + 2u + i0 / 16: byte 2 (u & 1) + i0 / 16 of word u >> 1
  __device__ static float scale(const Raw& r, const Lane& L, int u) {
    const uint32_t wv = (u >> 1) ? r.sc.y : r.sc.x;
    const int b = 2 * (u & 1) + (L.i0 >> 4);
    return half_f32(r.d) *
           (HIGH ? signed_byte_f32(wv, b) : code_f32<0, 0>(wv & 0x0F0F0F0Fu, b));
  }
  __device__ static float corr(const Raw& r, const Lane& L, int u) {
    if (HIGH) return 0.f;
    const uint32_t wv = (u >> 1) ? r.sc.y : r.sc.x;
    const int b = 2 * (u & 1) + (L.i0 >> 4);
    return half_f32(r.dmin) * code_f32<2, 0>(wv & 0xF0F0F0F0u, b);
  }
};

template <int F> struct Fmt;
template <> struct Fmt<Q2_K> : KQ23<Q2_K> {};
template <> struct Fmt<Q3_K> : KQ23<Q3_K> {};
template <> struct Fmt<Q4_K> : KQ45<Q4_K> {};
template <> struct Fmt<Q5_K> : KQ45<Q5_K> {};
template <> struct Fmt<Q6_K> : Q6K {};

template <int F, int R, int D, typename TX, typename TY>
__global__ void __launch_bounds__(gq::GEMV_WARPS * 32, gq::GEMV_MIN_BLOCKS)
quant_gemv_kq(const TX* __restrict__ x, const Planes p, TY* __restrict__ y, int O) {
  gq::gemv_rows<Fmt<F>, R, D>(x, p, y, O);
}

template <int F, typename TX, typename TY>
cudaError_t launch(const void* x, const Planes& p, void* y, int O, int rows, cudaStream_t st) {
  const unsigned blocks = gq::gemv_blocks(O, rows), threads = gq::GEMV_WARPS * 32;
  const TX* xt = static_cast<const TX*>(x);
  TY* yt = static_cast<TY*>(y);
  if (rows == 1)
    quant_gemv_kq<F, 1, KQ_DEPTH, TX, TY><<<blocks, threads, 0, st>>>(xt, p, yt, O);
  else
    quant_gemv_kq<F, 2, KQ_DEPTH, TX, TY><<<blocks, threads, 0, st>>>(xt, p, yt, O);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t dispatch(int gtype, const void* x, const Planes& p, void* y, int O, int rows,
                     cudaStream_t st) {
  switch (gtype) {
    case Q2_K: return launch<Q2_K, TX, TY>(x, p, y, O, rows, st);
    case Q3_K: return launch<Q3_K, TX, TY>(x, p, y, O, rows, st);
    case Q4_K: return launch<Q4_K, TX, TY>(x, p, y, O, rows, st);
    case Q5_K: return launch<Q5_K, TX, TY>(x, p, y, O, rows, st);
    case Q6_K: return launch<Q6_K, TX, TY>(x, p, y, O, rows, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (1, O) = x (1, K) @ W^T for a K-quant W (`gtype` Q2_K ... Q6_K), the
// plane pointers in gq_quant_matmul's order (qs: Q6_K's ql; qh: Q3_K's hmask;
// m: dmin; sc: Q2_K's scb; null where the format has none), all 16-byte
// aligned; x bf16 or f32, y f32 or bf16; K whole super-blocks; `rows` W rows
// a warp walks (1 or 2).
extern "C" int gq_quant_gemv_kq(int gtype, const void* x, int x_bf16, const void* qs,
                                const void* qh, const void* d, const void* m, const void* sc,
                                const void* scm, void* y, int y_bf16, int K, int O, int rows,
                                void* stream) {
  if (gtype < Q2_K || gtype > Q6_K || O < 1 || K < 256 || K % 256 != 0 ||
      (rows != 1 && rows != 2))
    return cudaErrorInvalidValue;
  const bool high = gtype == Q3_K || gtype == Q5_K || gtype == Q6_K;
  const bool dmin = gtype == Q2_K || gtype == Q4_K || gtype == Q5_K;
  const bool scm_ = gtype == Q4_K || gtype == Q5_K;
  if (!qs || !d || !sc || (high && !qh) || (dmin && !m) || (scm_ && !scm))
    return cudaErrorInvalidValue;
  const Planes p{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                 static_cast<const __half*>(d), static_cast<const __half*>(m),
                 static_cast<const uint8_t*>(sc), static_cast<const uint8_t*>(scm), K / 256};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return y_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(gtype, x, p, y, O, rows, st)
                  : dispatch<__nv_bfloat16, float>(gtype, x, p, y, O, rows, st);
  return y_bf16 ? dispatch<float, __nv_bfloat16>(gtype, x, p, y, O, rows, st)
                : dispatch<float, float>(gtype, x, p, y, O, rows, st);
}
