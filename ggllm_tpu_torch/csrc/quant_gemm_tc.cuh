// Fused dequant x matmul for S > 1 rows of bf16 x on the tensor cores:
// y (S, O) = x (S, K) @ W^T from the planes of a ggml-format weight, all ten
// formats (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K), f32
// accumulation, y in bf16 or f32.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/quant_matmul.py `_kern`
// (launched by fused_matmul_2d) for bf16 prefill (S > 16); the S == 1 GEMVs,
// the rows kernel of 2-16 bf16 rows (quant_mmv.cuh) and the f32 tile
// (quant_gemm_f32.cuh; both share this file's format traits and W staging)
// and the group sums (group_sums.cu) are kernels of their own. The
// TPU kernel keeps the affine part of the dequant out of the per-element
// path and subtracts it as a second product with per-group sums of x. Here
// one more FMA per decoded weight hides under the matrix instruction, so
// each weight is formed whole,
// w = q s - c by one f32 FMA with the group's s and c formed in f32 as the
// reference does (d * sc, dmin * scm), and rounded once to bf16. The code q
// (at most 6 bits) enters the FMA as the float 1 + q / 128, whose bits are
// 0x3F800000 | q << 16 (one byte permute, no integer-to-float conversion):
// w = fma(1 + q / 128, 128 s, -(c + 128 s)). c + 128 s is rounded to f32, so
// w differs from fma(q, s, -c) by at most 2^-17 |s| before the bf16 rounding
// (not at all for Q4_0, Q5_0, Q3_K and Q6_K, whose c is a multiple of s).
// Q8_0's signed byte b enters as 2^23 + (b ^ 0x80), minus 2^23 + 128, times d.
//
// What bounds it on an H100: operations (2 S O K on the bf16 tensor cores)
// from S of about 128 up; below that the decode of W, which is paid once per
// block of x rows. The design:
//  * y^T = W x^T by `wgmma` (m64nNk16). A warpgroup owns 64 rows of W and
//    decodes them straight into the A fragments in registers: dequantized W
//    never touches shared memory.
//  * The raw plane bytes do: per unit of 256 columns (a K-quant super-block,
//    eight legacy blocks) every W row of the block gets one record in shared
//    memory (its code bytes, high-bit bytes and int8 sub-scales copied by
//    16-, 8- or 4-byte `cp.async`, its fp16 scales through registers), one
//    unit ahead of its use, in two stages. Each thread then picks the bytes
//    of its own fragment positions with 2-byte shared-memory loads (a legacy
//    block's byte j holds elements j and j + 16, so the same bytes feed both
//    k steps of a 32-group). Records are an odd number of 16 bytes apart, so
//    the eight rows a warp reads at once lie in different banks. Reading the
//    planes from device memory per thread instead (the first form of this
//    kernel) cost more than the wgmma itself.
//  * The B operand is the x tile as it lies in memory ((S, K) row-major is
//    K-major): NT rows x 64 columns per stage, copied by 16-byte `cp.async`
//    into a ring of four stages in the 128-byte swizzle, two slabs ahead.
//    NT (the x rows of one block) is 256, 128 or 64: every weight is decoded
//    once per NT x rows, and a short S pays a narrow N (2 to 16 rows of x,
//    B decode rows, run a kernel of their own: quant_mmv.cuh).
//  * A block is two warpgroups (128 rows of W) sharing the x stages, so an x
//    tile read from L2 feeds 128 W rows.
//  * The wgmma of one 32-group runs while the next group is decoded into the
//    other fragment buffer (wait_group 1). Two things keep the compiler from
//    serializing them: no branch surrounds a wgmma (a K / 32 that is odd pads
//    its last slab with zero weights), and no ordinary instruction writes the
//    accumulator (the first wgmma overwrites it instead of adding to zeros).
//  * The decode is kept short, because with two warps a scheduler it is
//    instruction dispatch and latency, not the tensor cores, that a block waits
//    for: codes are cut out four to a 32-bit operation, and a byte permute
//    turns each into its float.
//  * Built per format and NT from two sources that compile side by side
//    (quant_gemm_tc_legacy.cu, quant_gemm_tc_kq.cu); y's dtype is a run-time
//    branch of the epilogue.
//  * Rows of x past S and columns past K are zero-filled; rows of W past O
//    repeat row O - 1; both are skipped on stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BK = 64;        // x columns per stage (128 bytes: one swizzle row)
constexpr int STAGES = 4;     // x stages; copies run two slabs ahead
constexpr int WGS = 2;        // warpgroups per block
constexpr int THREADS = WGS * 128;
constexpr int BM = WGS * 64;  // W rows per block
constexpr int WSTAGES = 2;    // W record stages; copies run one unit ahead

enum : int {
  Q4_0 = 2, Q4_1 = 3, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8,
  Q2_K = 10, Q3_K = 11, Q4_K = 12, Q5_K = 13, Q6_K = 14
};

struct Planes {
  const uint8_t* qs;  // Q6_K: ql
  const uint8_t* qh;  // Q5_0/Q5_1: one uint32 per block; Q5_K/Q6_K: bytes; Q3_K: hmask
  const __half* d;
  const __half* m;    // Q4_1/Q5_1: m; Q2_K/Q4_K/Q5_K: dmin
  const int8_t* sc;   // Q2_K: scb, unsigned bytes (scale | min << 4)
  const int8_t* scm;
  int ng;             // 32-groups per row (K / 32)
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
template <int CH>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if constexpr (CH == 16) {
    cp_async16(dst, src, bytes);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(CH),
                 "r"(bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a block needs to stage one plane: rows o_base .. o_base + ROWS - 1
// (clamped to O - 1), unit u, W stage at shared address `stage`, records RS
// bytes apart
struct StageArgs {
  uint32_t stage;
  int rs, o_base, O, ng, u, tid;
};

// Copy unit u of a plane with B bytes per row and unit (B / 8 per 32-group)
// into the records of ROWS rows at byte offset `off`, in chunks of CH bytes,
// by NTH threads; chunks past the row's end become zeros.
template <int B, int CH, int ROWS, int NTH>
__device__ __forceinline__ void stage_plane(const StageArgs& a, int off, const void* plane) {
  constexpr int CPR = B / CH;  // chunks per row
  const size_t row_bytes = (size_t)a.ng * (B / 8);
#pragma unroll
  for (int it = 0; it < (ROWS * CPR + NTH - 1) / NTH; ++it) {
    const int idx = a.tid + it * NTH;
    if ((ROWS * CPR) % NTH == 0 || idx < ROWS * CPR) {
      const int r = idx / CPR, c = idx % CPR;
      const size_t in_row = (size_t)a.u * B + c * CH;
      const bool ok = in_row < row_bytes;
      const uint8_t* src = static_cast<const uint8_t*>(plane) +
                           (size_t)min(a.o_base + r, a.O - 1) * row_bytes + (ok ? in_row : 0);
      cp_async<CH>(a.stage + r * a.rs + off + c * CH, src, ok ? CH : 0);
    }
  }
}

// What a thread holds of one row's 32-group: the bytes at the group's element
// positions i = 2t, 2t+1 (q[0] bits 0-15), 2t+8, 2t+9 (q[0] bits 16-31),
// 2t+16, 2t+17 (q[1] low), 2t+24, 2t+25 (q[1] high), t = lane % 4; the same
// positions of the high-bit plane in h (legacy: the block's 32 bits in h[0]);
// scale s and correction c of the group's one or two scale groups (w = q s - c).
// Slot e (0..7) of the thread is element i(e) = 2t + (e & 1) + 8 (e >> 1).
struct Raw {
  uint32_t q[2], h[2];
  float s[2], c[2];
};

__device__ __forceinline__ uint32_t ld2(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}
__device__ __forceinline__ float ldh(const uint8_t* p) {
  return __half2float(*reinterpret_cast<const __half*>(p));
}
// a signed byte as f32 without an integer-to-float conversion: the float
// 2^23 + (b ^ 0x80) = 2^23 + 128 + b, less 2^23 + 128 (both steps exact)
__device__ __forceinline__ float sbyte_f32(uint32_t b) {
  return __uint_as_float(0x4B000000u | ((b ^ 0x80u) & 0xFFu)) - 8388736.f;
}
// v < 2^23 as f32 the same way: 2^23 + v, less 2^23
__device__ __forceinline__ float small_f32(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.f;
}
// the four 2-byte pieces of a 32-byte run at offsets 2t, 2t+8, 2t+16, 2t+24
__device__ __forceinline__ void ld_run32(const uint8_t* p, int t, uint32_t (&q)[2]) {
  q[0] = ld2(p + 2 * t) | (ld2(p + 2 * t + 8) << 16);
  q[1] = ld2(p + 2 * t + 16) | (ld2(p + 2 * t + 24) << 16);
}
// A format's record of one row and unit: code bytes at 0, then the high-bit
// bytes (OFF_H), the int8 sub-scales (OFF_SC; a second plane at OFF_SC + 8),
// the fp16 scales d (OFF_D, N16 of them) and m / dmin (OFF_D + 2 N16).
//   stage<ROWS, NTH>(a, p): start the cp.async copies of unit a.u of ROWS
//     rows, by NTH threads;
//   load(rec, gl, t, r): fill r for 32-group gl (0..7) of the unit from the
//     row's record;
//   codes(r, gl, t, w): the unsigned codes of slots 0-3 in the bytes of w[0],
//     of slots 4-7 in those of w[1] (Q8_0: the signed bytes themselves);
//   SUB: scale group width; N16 / HAS_M: fp16 scalars per unit and plane.

template <int F>
struct Legacy {  // Q4_0, Q4_1, Q5_0, Q5_1
  static constexpr int SUB = 32, N16 = 8;
  static constexpr bool HAS_M = F == Q4_1 || F == Q5_1;
  static constexpr bool HIGH = F == Q5_0 || F == Q5_1;
  static constexpr int OFF_H = 128, OFF_D = OFF_H + (HIGH ? 32 : 0);
  static constexpr int REC = OFF_D + (HAS_M ? 32 : 16);
  template <int ROWS, int NTH>
  __device__ static void stage(const StageArgs& a, const Planes& p) {
    stage_plane<128, 16, ROWS, NTH>(a, 0, p.qs);
    if (HIGH) stage_plane<32, 4, ROWS, NTH>(a, OFF_H, p.qh);
  }
  __device__ static void load(const uint8_t* rec, int gl, int t, Raw& r) {
    const uint8_t* qp = rec + gl * 16;
    r.q[0] = ld2(qp + 2 * t) | (ld2(qp + 2 * t + 8) << 16);
    if (HIGH) r.h[0] = *reinterpret_cast<const uint32_t*>(rec + OFF_H + gl * 4);
    const float d = ldh(rec + OFF_D + gl * 2);
    r.s[0] = d;
    r.c[0] = HAS_M ? -ldh(rec + OFF_D + 16 + gl * 2) : (HIGH ? 16.f : 8.f) * d;
  }
  __device__ static void codes(const Raw& r, int, int t, uint32_t (&w)[2]) {
    w[0] = r.q[0] & 0x0F0F0F0Fu;
    w[1] = (r.q[0] >> 4) & 0x0F0F0F0Fu;
    if (HIGH) {  // bit i of h is element i's: bits 2t, 2t+1, 2t+8, 2t+9 (+16) -> bit 4 of bytes 0-3
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t hb = r.h[0] >> (2 * t + 16 * j);
        w[j] |= ((hb & 1u) << 4) | ((hb & 2u) << 11) | ((hb & 0x100u) << 12) | ((hb & 0x200u) << 19);
      }
    }
  }
};

struct Q8 {
  static constexpr int SUB = 32, N16 = 8;
  static constexpr bool HAS_M = false;
  static constexpr int OFF_D = 256, REC = OFF_D + 16;
  template <int ROWS, int NTH>
  __device__ static void stage(const StageArgs& a, const Planes& p) {
    stage_plane<256, 16, ROWS, NTH>(a, 0, p.qs);
  }
  __device__ static void load(const uint8_t* rec, int gl, int t, Raw& r) {
    ld_run32(rec + gl * 32, t, r.q);
    r.s[0] = ldh(rec + OFF_D + gl * 2);
    r.c[0] = 0.f;
  }
  __device__ static void codes(const Raw& r, int, int, uint32_t (&w)[2]) {
    w[0] = r.q[0];
    w[1] = r.q[1];
  }
};

template <int F>
struct KQ45 {  // Q4_K, Q5_K: 32-group gl = 2 j + h of the super-block
  static constexpr int SUB = 32, N16 = 1;
  static constexpr bool HAS_M = true;
  static constexpr bool HIGH = F == Q5_K;
  static constexpr int OFF_H = 128, OFF_SC = OFF_H + (HIGH ? 32 : 0), OFF_D = OFF_SC + 16;
  static constexpr int REC = OFF_D + 4;
  template <int ROWS, int NTH>
  __device__ static void stage(const StageArgs& a, const Planes& p) {
    stage_plane<128, 16, ROWS, NTH>(a, 0, p.qs);
    if (HIGH) stage_plane<32, 16, ROWS, NTH>(a, OFF_H, p.qh);
    stage_plane<8, 8, ROWS, NTH>(a, OFF_SC, p.sc);
    stage_plane<8, 8, ROWS, NTH>(a, OFF_SC + 8, p.scm);
  }
  __device__ static void load(const uint8_t* rec, int gl, int t, Raw& r) {
    ld_run32(rec + (gl >> 1) * 32, t, r.q);
    if (HIGH) ld_run32(rec + OFF_H, t, r.h);
    r.s[0] = ldh(rec + OFF_D) * sbyte_f32(rec[OFF_SC + gl]);
    r.c[0] = ldh(rec + OFF_D + 2) * sbyte_f32(rec[OFF_SC + 8 + gl]);
  }
  __device__ static void codes(const Raw& r, int gl, int, uint32_t (&w)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      w[j] = (r.q[j] >> (4 * (gl & 1))) & 0x0F0F0F0Fu;
      if (HIGH) w[j] |= ((r.h[j] >> gl) & 0x01010101u) << 4;
    }
  }
};

struct Q6K {  // 32-group gl = 4 half + strip; two 16-groups
  static constexpr int SUB = 16, N16 = 1;
  static constexpr bool HAS_M = false;
  static constexpr int OFF_H = 128, OFF_SC = 192, OFF_D = 208, REC = OFF_D + 2;
  template <int ROWS, int NTH>
  __device__ static void stage(const StageArgs& a, const Planes& p) {
    stage_plane<128, 16, ROWS, NTH>(a, 0, p.qs);
    stage_plane<64, 16, ROWS, NTH>(a, OFF_H, p.qh);
    stage_plane<16, 16, ROWS, NTH>(a, OFF_SC, p.sc);
  }
  __device__ static void load(const uint8_t* rec, int gl, int t, Raw& r) {
    const int half = gl >> 2, strip = gl & 3;
    ld_run32(rec + half * 64 + (strip & 1) * 32, t, r.q);
    ld_run32(rec + OFF_H + half * 32, t, r.h);
    const float d = ldh(rec + OFF_D);
    const uint8_t* scp = rec + OFF_SC + 2 * gl;
    r.s[0] = d * sbyte_f32(scp[0]);
    r.s[1] = d * sbyte_f32(scp[1]);
    r.c[0] = 32.f * r.s[0];
    r.c[1] = 32.f * r.s[1];
  }
  __device__ static void codes(const Raw& r, int gl, int, uint32_t (&w)[2]) {
    const int strip = gl & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w[j] = ((r.q[j] >> (4 * (strip >> 1))) & 0x0F0F0F0Fu) |
             (((r.h[j] >> (2 * strip)) & 0x03030303u) << 4);
  }
};

template <int F>
struct KQ23 {  // Q2_K, Q3_K: 32-group gl = 4 half + strip; two 16-groups
  static constexpr int SUB = 16, N16 = 1;
  static constexpr bool HIGH = F == Q3_K;
  static constexpr bool HAS_M = !HIGH;
  static constexpr int OFF_H = 64, OFF_SC = OFF_H + (HIGH ? 32 : 0), OFF_D = OFF_SC + 16;
  static constexpr int REC = OFF_D + (HAS_M ? 4 : 2);
  template <int ROWS, int NTH>
  __device__ static void stage(const StageArgs& a, const Planes& p) {
    stage_plane<64, 16, ROWS, NTH>(a, 0, p.qs);
    if (HIGH) stage_plane<32, 16, ROWS, NTH>(a, OFF_H, p.qh);
    stage_plane<16, 16, ROWS, NTH>(a, OFF_SC, p.sc);
  }
  __device__ static void load(const uint8_t* rec, int gl, int t, Raw& r) {
    ld_run32(rec + (gl >> 2) * 32, t, r.q);
    const float d = ldh(rec + OFF_D);
    const uint8_t* scp = rec + OFF_SC + 2 * gl;  // the group's two 16-groups
    if (HIGH) {
      ld_run32(rec + OFF_H, t, r.h);
      r.s[0] = d * sbyte_f32(scp[0]);
      r.s[1] = d * sbyte_f32(scp[1]);
      r.c[0] = 4.f * r.s[0];
      r.c[1] = 4.f * r.s[1];
    } else {
      const float dmin = ldh(rec + OFF_D + 2);
      const uint32_t b0 = scp[0], b1 = scp[1];
      r.s[0] = d * small_f32(b0 & 0xFu);
      r.s[1] = d * small_f32(b1 & 0xFu);
      r.c[0] = dmin * small_f32(b0 >> 4);
      r.c[1] = dmin * small_f32(b1 >> 4);
    }
  }
  __device__ static void codes(const Raw& r, int gl, int, uint32_t (&w)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      w[j] = (r.q[j] >> (2 * (gl & 3))) & 0x03030303u;
      if (HIGH) w[j] |= ((r.h[j] >> gl) & 0x01010101u) << 2;
    }
  }
};

template <int F> struct Fmt : Legacy<F> {};
template <> struct Fmt<Q8_0> : Q8 {};
template <> struct Fmt<Q2_K> : KQ23<Q2_K> {};
template <> struct Fmt<Q3_K> : KQ23<Q3_K> {};
template <> struct Fmt<Q4_K> : KQ45<Q4_K> {};
template <> struct Fmt<Q5_K> : KQ45<Q5_K> {};
template <> struct Fmt<Q6_K> : Q6K {};

// bytes between two rows' records: the record rounded up to an odd number of
// 16 bytes, so eight consecutive rows start in eight different bank groups
template <int F>
struct RecordStride {
  static constexpr int value = (((Fmt<F>::REC + 15) / 16) | 1) * 16;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte k of `codes` as bits 16-23 under the exponent of 1.0: with the byte's
// top bit set (0x80 | q, q < 128) the float is 1 + q / 128
template <int K>
__device__ __forceinline__ float one_plus_q128(uint32_t codes) {
  return __uint_as_float(__byte_perm(codes, 0x3F000000u, 0x7044 | (K << 8)));
}
// byte k of `codes` as the low mantissa byte of 2^23: the float 2^23 + byte
template <int K>
__device__ __forceinline__ float two23_plus(uint32_t codes) {
  return __uint_as_float(__byte_perm(codes, 0x4B000000u, 0x7440 | K));
}

// One row's 32-group -> f[0..3]: (k step 0: elements 2t, 2t+1 | 2t+8, 2t+9),
// (k step 1: 2t+16, 2t+17 | 2t+24, 2t+25); f[j] packs slots 2j and 2j + 1
template <int F>
__device__ __forceinline__ void decode(const Raw& r, int gl, int t, uint32_t (&f)[4]) {
  using Q = Fmt<F>;
  uint32_t w[2];
  Q::codes(r, gl, t, w);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int sg = Q::SUB == 16 ? j : 0;  // slots 0-3 | 4-7 are the two 16-groups
    float v[4];
    if constexpr (F == Q8_0) {
      const uint32_t u = w[j] ^ 0x80808080u;  // b + 128
      v[0] = (two23_plus<0>(u) - 8388736.f) * r.s[0];
      v[1] = (two23_plus<1>(u) - 8388736.f) * r.s[0];
      v[2] = (two23_plus<2>(u) - 8388736.f) * r.s[0];
      v[3] = (two23_plus<3>(u) - 8388736.f) * r.s[0];
    } else {
      const float s128 = 128.f * r.s[sg], c128 = r.c[sg] + s128;
      const uint32_t u = w[j] | 0x80808080u;
      v[0] = fmaf(one_plus_q128<0>(u), s128, -c128);
      v[1] = fmaf(one_plus_q128<1>(u), s128, -c128);
      v[2] = fmaf(one_plus_q128<2>(u), s128, -c128);
      v[3] = fmaf(one_plus_q128<3>(u), s128, -c128);
    }
    f[2 * j] = pack_bf16(v[0], v[1]);
    f[2 * j + 1] = pack_bf16(v[2], v[3]);
  }
}

// The W records of a block of ROWS rows (row r: o_base + r, clamped to
// O - 1), staged by NTH threads: unit u of every plane into stage u % NSTAGE.
// The code, high-bit and sub-scale bytes go by `cp.async` (copy); the fp16
// scales go device memory -> registers (load_scalars) -> the records
// (store_scalars), the two apart so that the loads' latency hides behind
// the products (the tiles: a slab; the rows kernel: a unit).
template <int F, int ROWS = BM, int NTH = THREADS, int NSTAGE = WSTAGES>
struct WStager {
  using Q = Fmt<F>;
  static constexpr int RS = RecordStride<F>::value;
  static constexpr int STAGE_BYTES = ROWS * RS;
  static constexpr int N16 = Q::N16;                          // fp16 scalars per row, unit, plane
  static constexpr int NJ = (ROWS * N16 + NTH - 1) / NTH;     // scalar copies per thread and plane
  const Planes& p;
  uint32_t wsm0;  // the stages' shared address
  uint8_t* wsm;   // and pointer
  int o_base, O, tid;
  uint16_t sreg[2][NJ];

  __device__ __forceinline__ int nunit() const { return (p.ng + 7) / 8; }
  // unit u into stage `slot` % NSTAGE (a block that takes every unit: slot u)
  __device__ __forceinline__ void copy(int u, int slot) const {
    if (u >= nunit()) return;
    const StageArgs a{wsm0 + (slot % NSTAGE) * STAGE_BYTES, RS, o_base, O, p.ng, u, tid};
    Q::template stage<ROWS, NTH>(a, p);
  }
  __device__ __forceinline__ void copy(int u) const { copy(u, u); }
  // where copy j of plane pl of unit u reads (null past the row's end, the
  // last unit or the block's scalars)
  __device__ __forceinline__ const uint16_t* scalar_src(int pl, int j, int u) const {
    const uint16_t* plane = reinterpret_cast<const uint16_t*>(pl ? p.m : p.d);
    const int per_row = (p.ng * N16 + 7) / 8;  // ng (legacy) or ng / 8 (K-quants)
    const int idx = tid + j * NTH;
    const int r = idx / N16, e = u * N16 + idx % N16;
    const bool ok = idx < ROWS * N16 && u < nunit() && e < per_row;
    return ok ? plane + (size_t)min(o_base + r, O - 1) * per_row + e : nullptr;
  }
  __device__ __forceinline__ void load_scalars(int u) {
#pragma unroll
    for (int pl = 0; pl < (Q::HAS_M ? 2 : 1); ++pl)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint16_t* src = scalar_src(pl, j, u);
        sreg[pl][j] = src ? __ldg(src) : 0;
      }
  }
  // the fp16 scales of unit u by 4-byte `cp.async` into the records, as the
  // other planes go: for the legacy formats (8 a row and unit, 16 bytes)
  // when a row's scales start 4-byte aligned (an even count of 32-groups);
  // else they take load_scalars and store_scalars
  __device__ __forceinline__ void copy_scalars(int u, int slot) const {
    static_assert(N16 == 8, "legacy formats: 16 bytes of scales a row and unit");
    if (u >= nunit()) return;
    const StageArgs a{wsm0 + (slot % NSTAGE) * STAGE_BYTES, RS, o_base, O, p.ng, u, tid};
    stage_plane<16, 4, ROWS, NTH>(a, Q::OFF_D, p.d);
    if (Q::HAS_M) stage_plane<16, 4, ROWS, NTH>(a, Q::OFF_D + 16, p.m);
  }
  // asks L2 for the scalars load_scalars(u) will read (the rows kernel,
  // whose units are short, issues this with the unit's copies)
  __device__ __forceinline__ void prefetch_scalars(int u) const {
#pragma unroll
    for (int pl = 0; pl < (Q::HAS_M ? 2 : 1); ++pl)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint16_t* src = scalar_src(pl, j, u);
        if (src) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src));
      }
  }
  // the scalars load_scalars took into stage `slot` % NSTAGE
  __device__ __forceinline__ void store_scalars(int slot) const {
    uint8_t* stage = wsm + (slot % NSTAGE) * STAGE_BYTES;
#pragma unroll
    for (int pl = 0; pl < (Q::HAS_M ? 2 : 1); ++pl)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int idx = tid + j * NTH;
        if (idx < ROWS * N16)
          *reinterpret_cast<uint16_t*>(stage + (idx / N16) * RS + Q::OFF_D + pl * 2 * N16 +
                                       (idx % N16) * 2) = sreg[pl][j];
      }
  }
};

__device__ __forceinline__ void store_y(void* y, bool f32, size_t idx, float v) {
  if (f32)
    static_cast<float*>(y)[idx] = v;
  else
    static_cast<__nv_bfloat16*>(y)[idx] = __float2bfloat16(v);
}

template <int F, int NT>
__global__ void __launch_bounds__(THREADS, NT > 128 ? 1 : 2)
quant_gemm_tc(const __nv_bfloat16* __restrict__ x, const Planes p, void* __restrict__ y,
              int y_f32, int S, int K, int O) {
  using Q = Fmt<F>;
  constexpr int STAGE_BYTES = NT * BK * 2;
  constexpr int RS = RecordStride<F>::value;
  constexpr int WSTAGE_BYTES = WStager<F>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t smem0 = (smem_base + 1023u) & ~1023u;  // x stages, then W stages
  uint8_t* wsm = smem_raw + (smem0 - smem_base) + STAGES * STAGE_BYTES;
  const uint32_t wsm0 = smem0 + STAGES * STAGE_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o_base = blockIdx.x * BM;
  const int ra = wg * 64 + warp * 16 + g;  // the thread's rows of the block: ra and ra + 8
  const int s0 = blockIdx.y * NT;
  const int ng = p.ng, nslab = (ng + 1) / 2;

  // x slab `slab` -> stage slab % STAGES; rows past S and columns past K are
  // zero-filled. A thread copies chunk c = tid % 8 of rows tid / 8 + 32 it.
  const int xc = tid & 7, xr = tid >> 3;
  const __nv_bfloat16* xsrc = x + (size_t)(s0 + xr) * K + xc * 8;
  const uint32_t xdst = smem0 + xr * 128 + ((xc ^ (xr & 7)) << 4);
  auto copy_x = [&](int slab) {
    if (slab >= nslab) return;
    const uint32_t base = xdst + (slab % STAGES) * STAGE_BYTES;
    const bool k_ok = slab * BK + xc * 8 < K;
#pragma unroll
    for (int it = 0; it < (NT + 31) / 32; ++it) {
      if (NT % 32 == 0 || xr + 32 * it < NT) {
        const bool ok = k_ok && s0 + xr + 32 * it < S;
        const __nv_bfloat16* src = xsrc + (size_t)it * 32 * K + slab * BK;
        cp_async16(base + it * 32 * 128, ok ? src : x, ok ? 16 : 0);
      }
    }
  };
  WStager<F> wst{p, wsm0, wsm, o_base, O, tid};
  // the record of the thread's row a for 32-group gi (row b: + 8 RS); the
  // row's offset passes through an empty asm so that it stays in a register
  // instead of being recomputed from the thread index at every group
  int rec_off = ra * RS;
  asm volatile("" : "+r"(rec_off));
  auto record = [&](int gi) { return wsm + ((gi >> 3) & 1) * WSTAGE_BYTES + rec_off; };
  static_assert(WSTAGES == 2, "record() takes the unit's parity as its stage");

  float acc[NT / 2];  // not zeroed: the first wgmma overwrites it (zeroing it here, with
                      // ordinary instructions, makes the compiler serialize the wgmma)

  copy_x(0);
  wst.copy(0);
  cp_async_commit();
  copy_x(1);
  cp_async_commit();
  wst.load_scalars(0);
  wst.store_scalars(0);
  Raw na, nb;              // the next group's bytes of rows a and b
  uint32_t frag[2][2][4];  // [buffer][row a / b][register]

  for (int slab = 0; slab < nslab; ++slab) {
    cp_async_wait<1>();  // this thread's copies of `slab` (and of its unit) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();     // everyone's have; all wgmma on slab - 2 are complete
    copy_x(slab + 2);   // into the stage slab - 2 used
    const int u = slab >> 2;
    if ((slab & 3) == 0) {  // the next unit: its stage was last read in unit u - 1
      wst.copy(u + 1);
      wst.load_scalars(u + 1);
    }
    cp_async_commit();
    if ((slab & 3) == 1) wst.store_scalars(u + 1);
    if (slab == 0) {
      Q::load(record(0), 0, t, na);
      Q::load(record(0) + 8 * RS, 0, t, nb);
    }
    const uint32_t stage = smem0 + (slab % STAGES) * STAGE_BYTES;
    // both 32-groups of the slab, unconditionally (a branch around a wgmma
    // makes the compiler serialize them): past an odd K / 32 the last slab's
    // second group decodes zero-filled records against zero-filled x columns
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gi = 2 * slab + hf;
      const Raw ca = na, cb = nb;
      if (gi + 1 < 2 * nslab) {
        const uint8_t* rec = record(gi + 1);
        Q::load(rec, (gi + 1) & 7, t, na);
        Q::load(rec + 8 * RS, (gi + 1) & 7, t, nb);
      }
      decode<F>(ca, gi & 7, t, frag[hf][0]);
      decode<F>(cb, gi & 7, t, frag[hf][1]);
      gq::wgmma_fence();
      const uint64_t desc = gq::smem_desc_k128(stage) + (uint64_t)(hf * 4);  // 64 bytes
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t a[4] = {frag[hf][0][2 * ks], frag[hf][1][2 * ks],
                               frag[hf][0][2 * ks + 1], frag[hf][1][2 * ks + 1]};
        gq::Wgmma<NT>::rs(acc, a, desc + (uint64_t)(ks * 2),  // 32 bytes a k step
                          (gi | ks) != 0);
      }
      gq::wgmma_commit();
      gq::wgmma_wait<1>();  // the group before this one is done: its fragments are free
    }
  }
  gq::wgmma_wait<0>();

  // acc[4j + c]: x row s0 + 8j + 2t + (c & 1), W row o_base + ra + 8 (c >> 1)
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = s0 + 8 * j + 2 * t + (c & 1);
      const int o = o_base + ra + 8 * (c >> 1);
      if (s < S && o < O) store_y(y, y_f32 != 0, (size_t)s * O + o, acc[4 * j + c]);
    }
}

template <int F, int NT>
cudaError_t launch_nt(const void* x, const Planes& p, void* y, int y_f32, int S, int K, int O,
                      cudaStream_t st) {
  constexpr int SMEM = STAGES * NT * BK * 2 + WSTAGES * BM * RecordStride<F>::value + 1024;
  static size_t granted[gq::MAX_DEVICES] = {};
  cudaError_t e = gq::grant_smem(quant_gemm_tc<F, NT>, SMEM, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((O + BM - 1) / BM, (S + NT - 1) / NT);
  quant_gemm_tc<F, NT><<<grid, THREADS, SMEM, st>>>(static_cast<const __nv_bfloat16*>(x), p, y,
                                                    y_f32, S, K, O);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_fmt(int nt, const void* x, const Planes& p, void* y, int y_f32, int S, int K,
                       int O, cudaStream_t st) {
  switch (nt) {
    case 64: return launch_nt<F, 64>(x, p, y, y_f32, S, K, O, st);
    case 128: return launch_nt<F, 128>(x, p, y, y_f32, S, K, O, st);
    case 256: return launch_nt<F, 256>(x, p, y, y_f32, S, K, O, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
