// The decode GEMV's loop, y (1, O) = x (1, K) @ W^T for one row of x, shared
// by the legacy formats (quant_gemv_legacy.cu) and the K-quants
// (quant_gemv_kq.cu); each file brings a trait per format (Q below) and its
// own __global__ kernel and entry point around gemv_rows.
//
// What bounds it on an H100: the weight bytes (2.6-8.5 bits a weight, 3.35
// TB/s) and, close behind, instruction issue (a weight needs a decode and an
// FMA; 128 lanes an SM a clock). The design:
//  * Lanes own distinct bytes. Each lane takes 16 contiguous code bytes of a
//    block (a 32-element block of a legacy format, a 256-element super-block
//    of a K-quant) a step with one 16-byte load, so a warp's load moves 512
//    distinct bytes, plus its blocks' high bits and scales. A warp walks R
//    rows (R = 1 or 2) at once, and keeps the next D - 1 steps' loads in
//    flight while it uses this step's: a ring of D buffers, nothing is
//    copied. Weight bytes skip L1, which keeps x.
//  * Codes without int->float conversions: four codes are masked into the
//    bytes of a word at once, PRMT puts one into the low mantissa of 2^23
//    (0x4B0000qq) and one FADD takes 2^23 + off off it: exact, then one FFMA
//    with x. A code masked in place at bit 2k goes into 2^(23 - 2k) instead
//    and needs no shift.
//  * No staged x: a lane reads its runs of 16 x values through L1 (__ldg,
//    16-byte loads; bf16 becomes f32 by a shift, exactly) and sums them itself
//    where the format pays a correction. No shared memory at all, so no shape
//    caps the warps an SM.
//  * One launch a call: ceil(O / (R * GEMV_WARPS)) blocks; the 32 lanes'
//    sums meet by shuffles and lane 0 writes the row.
//
// A trait Q: QK elements a block; LPS lanes share a block (QB code bytes), so
// a warp covers 32 / LPS blocks a step; a lane's 16 bytes hold RUNS runs of
// 16 elements, run u in one scale group. Lane: what the lane's position
// p = lane % LPS fixes. load: the lane's bytes and scales of block blk
// (row * nb + block). xoff: run u's first element within the block. code4<U>:
// the 4 codes of word w of run U as bytes, each 2 SH<U> bits up; OFF is
// taken off every code. scale / corr: run u's s and c, w = s (q - OFF) - c;
// CORR: the format pays c * sum x.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace gq {

constexpr int GEMV_WARPS = 4;       // warps a block
constexpr int GEMV_MIN_BLOCKS = 5;  // blocks an SM the registers must allow: <= 102 a thread

// A weight's planes as both GEMVs take them (null where the format has none)
struct GemvPlanes {
  const uint8_t* qs;  // Q6_K: ql
  const uint8_t* qh;  // Q5_0 / Q5_1: a u32 a block; Q5_K / Q6_K: bytes; Q3_K: hmask
  const __half* d;
  const __half* m;     // Q4_1 / Q5_1: m; Q2_K, Q4_K, Q5_K: dmin
  const uint8_t* sc;   // Q2_K: scb
  const uint8_t* scm;  // Q4_K, Q5_K
  int nb;              // blocks a row
};

// Weight loads: every byte of W is read once, so they skip L1 (a
// non-coherent load that does not allocate there), which keeps x for the
// lanes that read it again
__device__ __forceinline__ uint4 ldw(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ldw(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ldw(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint16_t ldw(const uint16_t* p) {
  uint16_t v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
// 16 bytes of W at p (16-byte aligned)
__device__ __forceinline__ uint4 ldw16(const void* p) {
  return ldw(reinterpret_cast<const uint4*>(p));
}

// Byte b of c4 as f32, less OFF, without I2F: PRMT makes the float whose
// top byte is 0x4B - SH and whose low byte is the byte, 2^(23 - 2 SH) + byte *
// 2^(-2 SH), and one FADD takes 2^(23 - 2 SH) + OFF off it. With SH = 0 that
// is the byte itself; a code masked in place at bits 2 SH and up (a high
// nibble, Q2_K's strips) comes out without a shift. Exact for every byte.
template <int SH, int OFF>
__device__ __forceinline__ float code_f32(uint32_t c4, int b) {
  constexpr float base = (float)(1 << (23 - 2 * SH)) + OFF;
  return __uint_as_float(__byte_perm(c4, 0x4Bu - SH, 0x4550u | b)) - base;
}
// a signed byte b of w as f32: its sign bit flipped gives s + 128
__device__ __forceinline__ float signed_byte_f32(uint32_t w, int b) {
  return code_f32<0, 128>(w ^ 0x80808080u, b);
}
__device__ __forceinline__ float half_f32(uint16_t h) {
  return __half2float(__ushort_as_half(h));
}

// 16 x values from x + k (k a multiple of 16: 16-byte aligned) as f32
__device__ __forceinline__ void load_x16(const float* x, float (&f)[16]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 a = ld16(x + 4 * v);
    f[4 * v] = __uint_as_float(a.x);
    f[4 * v + 1] = __uint_as_float(a.y);
    f[4 * v + 2] = __uint_as_float(a.z);
    f[4 * v + 3] = __uint_as_float(a.w);
  }
}
__device__ __forceinline__ void load_x16(const __nv_bfloat16* x, float (&f)[16]) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 a = ld16(x + 8 * v);
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // a bf16 is the high half of its f32
      const uint32_t b = word(a, w);
      f[8 * v + 2 * w] = __uint_as_float(b << 16);
      f[8 * v + 2 * w + 1] = __uint_as_float(b & 0xFFFF0000u);
    }
  }
}

// run U of the lane's current step against the R rows' codes
template <class Q, int R, int U, typename TX>
__device__ __forceinline__ void gemv_run(const TX* __restrict__ xb,
                                         const typename Q::Raw (&cur)[R],
                                         const typename Q::Lane& L, float (&acc)[R]) {
  float xf[16];
  load_x16(xb + Q::xoff(L, U), xf);
  float sx = 0.f;
  if (Q::CORR) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sx += xf[i];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dot = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t c4 = Q::template code4<U>(cur[r], L, w);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        dot = fmaf(code_f32<Q::template SH<U>, Q::OFF>(c4, b), xf[4 * w + b], dot);
    }
    acc[r] = fmaf(Q::scale(cur[r], L, U), dot, acc[r]);
    if (Q::CORR) acc[r] = fmaf(-Q::corr(cur[r], L, U), sx, acc[r]);
  }
}

template <class Q, int R, typename TX>
__device__ __forceinline__ void gemv_runs(const TX* __restrict__ xb,
                                          const typename Q::Raw (&cur)[R],
                                          const typename Q::Lane& L, float (&acc)[R]) {
  gemv_run<Q, R, 0>(xb, cur, L, acc);
  if constexpr (Q::RUNS >= 2) gemv_run<Q, R, 1>(xb, cur, L, acc);
  if constexpr (Q::RUNS == 4) {
    gemv_run<Q, R, 2>(xb, cur, L, acc);
    gemv_run<Q, R, 3>(xb, cur, L, acc);
  }
}

// The body of a GEMV kernel of GEMV_WARPS warps a block: warp w of block b
// computes rows (b * GEMV_WARPS + w) * R .. + R - 1 of y, D steps of row
// bytes in flight or in use at once
template <class Q, int R, int D, typename TX, typename TY>
__device__ __forceinline__ void gemv_rows(const TX* __restrict__ x, const GemvPlanes p,
                                          TY* __restrict__ y, int O) {
  using Raw = typename Q::Raw;
  constexpr int BPS = 32 / Q::LPS;  // blocks a warp step
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * GEMV_WARPS + threadIdx.x / 32) * R;
  if (row0 >= O) return;  // the whole warp
  const int lp = lane % Q::LPS, bl = lane / Q::LPS;
  const typename Q::Lane L = Q::lane(lp);
  const int nb = p.nb, steps = (nb + BPS - 1) / BPS;
  size_t base[R];  // each row's first block; a row past O reads row O - 1, never stored
#pragma unroll
  for (int r = 0; r < R; ++r) base[r] = (size_t)min(row0 + r, O - 1) * nb;

  // a ring of D buffers of the R rows' bytes: while step t computes, steps
  // t + 1 .. t + D - 1 are in flight; a lane past the last block loads and
  // computes nothing
  Raw buf[D][R];
  auto load = [&](int t, Raw (&dst)[R]) {
    const int blk = t * BPS + bl;
    if (blk < nb) {
#pragma unroll
      for (int r = 0; r < R; ++r) Q::load(p, base[r] + blk, L, lp, dst[r]);
    }
  };
  auto compute = [&](int t, const Raw (&src)[R], float (&acc)[R]) {
    const int blk = t * BPS + bl;
    if (blk < nb) gemv_runs<Q, R>(x + (size_t)blk * Q::QK, src, L, acc);
  };
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
  for (int i = 0; i + 1 < D; ++i) load(i, buf[i]);
  for (int t = 0; t < steps; t += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      load(t + i + D - 1, buf[(i + D - 1) % D]);
      compute(t + i, buf[i], acc);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && row0 + r < O) store(y + row0 + r, v);
  }
}

// blocks of a GEMV launch
inline unsigned gemv_blocks(int O, int rows) {
  const int per_block = GEMV_WARPS * rows;
  return (unsigned)((O + per_block - 1) / per_block);
}

}  // namespace gq
