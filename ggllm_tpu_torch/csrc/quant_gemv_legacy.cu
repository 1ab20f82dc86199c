// y (1, O) = x (1, K) @ W^T for the legacy formats Q4_0, Q4_1, Q5_0, Q5_1
// and Q8_0: the decode GEMV (S = 1) of the fused dequant x matmul.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/quant_matmul.py `_kern`
// (launched by fused_matmul_2d) at one row of x for the legacy formats; the
// K-quants run csrc/quant_gemv_kq.cu, more rows the tiles.
//
// Weights are ggml's planar blocks (quant/planar.py): per row and 32-element
// block the code plane qs (16 bytes: byte i holds element i in its low nibble
// and 16 + i in its high one; Q8_0: 32 signed bytes), fp16 d, Q4_1 / Q5_1's
// fp16 m and Q5_0 / Q5_1's u32 qh (bit i: the fifth bit of element i). With
// w = d (q - off) + m,
//   y = sum_b d_b * sum_{j in b} (q_j - off) x_j  +  m_b * sum_{j in b} x_j,
// off = 8 (Q4_0), 16 (Q5_0), 128 (Q8_0, whose signed byte becomes s + 128
// when its sign bit is flipped) folded into the code exactly, so only Q4_1
// and Q5_1 pay m * sum x, from the lane's own x. kernels/quant_matmul.py
// gemv_lane_table states the index arithmetic below and gemv_emulated the
// sums, and the CPU tests hold both.
//
// What bounds it on an H100: the weight bytes (4.5-8.5 bits a weight at 3.35
// TB/s: Q4_0 5.96e12 weights/s), and close behind, instruction issue (128
// lanes an SM a clock: about 4 instructions a weight leaves 8.4e12/s) and
// the bytes a warp keeps in flight. The loop is csrc/gemv.cuh's: a Q4 / Q5
// lane owns one block's 16 code bytes a step (two runs of 16: the low and
// the high nibbles), a Q8_0 lane half a block's 32, so a warp's load moves
// 512 distinct code bytes; the next LEGACY_DEPTH - 1 steps' bytes are in
// flight while this step's are used (a 32-element block is a short step: a
// deeper ring than the K-quants' keeps enough bytes in flight); codes are
// masked four at a time and decoded by PRMT into 2^23 + q and one FADD, the
// high nibble of Q4_0 / Q4_1 in place (2^19 + q); Q5's fifth bits are spread
// from qh into bit 4 of four code bytes at once (one multiply); no I2F;
// weight bytes skip L1 and x comes through it; no shared memory, and 4-warp
// blocks spread even O = 4096 over all 132 SMs.

#include <cuda_fp16.h>

#include "gemv.cuh"

namespace {

using gq::half_f32;
using gq::ldw;
using gq::ldw16;
using gq::word;
using Planes = gq::GemvPlanes;

enum : int { Q4_0 = 2, Q4_1 = 3, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8 };  // ggml.h type ids
constexpr int LEGACY_DEPTH = 4;  // steps of row bytes in flight or in use a warp

// ------------------------------------------------------------ format traits
// (csrc/gemv.cuh states what a trait holds)

struct WholeBlock {};  // a Q4 / Q5 lane takes all 16 code bytes of its block

template <int F>
struct Nibbles {  // Q4_0, Q4_1, Q5_0, Q5_1: run 0 the low nibbles (elements 0-15), run 1 the high
  static constexpr bool MIN = F == Q4_1 || F == Q5_1, HIGH = F == Q5_0 || F == Q5_1;
  static constexpr int QK = 32, LPS = 1, QB = 16, RUNS = 2, OFF = MIN ? 0 : HIGH ? 16 : 8;
  static constexpr bool CORR = MIN;
  // Q4's high nibble stays in place (bits 4-7: SH 2); Q5's is shifted down to
  // meet its fifth bit
  template <int U> static constexpr int SH = (U == 1 && !HIGH) ? 2 : 0;
  using Lane = WholeBlock;
  struct Raw {
    uint4 q;
    uint32_t h;
    uint16_t d, m;
  };
  __device__ static Lane lane(int) { return Lane{}; }
  __device__ static void load(const Planes& P, size_t blk, const Lane&, int, Raw& r) {
    r.q = ldw16(P.qs + blk * QB);
    r.d = ldw(reinterpret_cast<const uint16_t*>(P.d) + blk);
    if (MIN) r.m = ldw(reinterpret_cast<const uint16_t*>(P.m) + blk);
    if (HIGH) r.h = ldw(reinterpret_cast<const uint32_t*>(P.qh) + blk);
  }
  __device__ static int xoff(const Lane&, int u) { return 16 * u; }
  template <int U>
  __device__ static uint32_t code4(const Raw& r, const Lane&, int w) {
    if (!HIGH) return word(r.q, w) & (U ? 0xF0F0F0F0u : 0x0F0F0F0Fu);
    // the word's fifth bits, qh bits 16 U + 4 w + b (b = 0-3), to bit 8 b + 4:
    // n * 0x02040810 is n << 4 | n << 11 | n << 18 | n << 25, no two terms overlap
    const uint32_t n = (r.h >> (16 * U + 4 * w)) & 0xFu;
    return ((word(r.q, w) >> (4 * U)) & 0x0F0F0F0Fu) | ((n * 0x02040810u) & 0x10101010u);
  }
  __device__ static float scale(const Raw& r, const Lane&, int) { return half_f32(r.d); }
  __device__ static float corr(const Raw& r, const Lane&, int) { return -half_f32(r.m); }
};

struct HalfBlock {
  int p;  // which 16 of the block's 32 bytes (elements 16 p + i)
};

struct Q8 {  // Q8_0: two lanes a block, 16 signed bytes each
  static constexpr int QK = 32, LPS = 2, QB = 32, RUNS = 1, OFF = 128;
  static constexpr bool CORR = false;
  template <int U> static constexpr int SH = 0;
  using Lane = HalfBlock;
  struct Raw {
    uint4 q;
    uint16_t d;
  };
  __device__ static Lane lane(int p) { return Lane{p}; }
  __device__ static void load(const Planes& P, size_t blk, const Lane&, int p, Raw& r) {
    r.q = ldw16(P.qs + blk * QB + 16 * p);
    r.d = ldw(reinterpret_cast<const uint16_t*>(P.d) + blk);
  }
  __device__ static int xoff(const Lane& L, int) { return 16 * L.p; }
  template <int U>
  __device__ static uint32_t code4(const Raw& r, const Lane&, int w) {
    return word(r.q, w) ^ 0x80808080u;  // each signed byte s becomes s + 128
  }
  __device__ static float scale(const Raw& r, const Lane&, int) { return half_f32(r.d); }
  __device__ static float corr(const Raw&, const Lane&, int) { return 0.f; }
};

template <int F> struct Fmt : Nibbles<F> {};
template <> struct Fmt<Q8_0> : Q8 {};

template <int F, int R, int D, typename TX, typename TY>
__global__ void __launch_bounds__(gq::GEMV_WARPS * 32, gq::GEMV_MIN_BLOCKS)
quant_gemv_legacy(const TX* __restrict__ x, const Planes p, TY* __restrict__ y, int O) {
  gq::gemv_rows<Fmt<F>, R, D>(x, p, y, O);
}

template <int F, typename TX, typename TY>
cudaError_t launch(const void* x, const Planes& p, void* y, int O, int rows, cudaStream_t st) {
  const unsigned blocks = gq::gemv_blocks(O, rows), threads = gq::GEMV_WARPS * 32;
  const TX* xt = static_cast<const TX*>(x);
  TY* yt = static_cast<TY*>(y);
  if (rows == 1)
    quant_gemv_legacy<F, 1, LEGACY_DEPTH, TX, TY><<<blocks, threads, 0, st>>>(xt, p, yt, O);
  else
    quant_gemv_legacy<F, 2, LEGACY_DEPTH, TX, TY><<<blocks, threads, 0, st>>>(xt, p, yt, O);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t dispatch(int gtype, const void* x, const Planes& p, void* y, int O, int rows,
                     cudaStream_t st) {
  switch (gtype) {
    case Q4_0: return launch<Q4_0, TX, TY>(x, p, y, O, rows, st);
    case Q4_1: return launch<Q4_1, TX, TY>(x, p, y, O, rows, st);
    case Q5_0: return launch<Q5_0, TX, TY>(x, p, y, O, rows, st);
    case Q5_1: return launch<Q5_1, TX, TY>(x, p, y, O, rows, st);
    case Q8_0: return launch<Q8_0, TX, TY>(x, p, y, O, rows, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (1, O) = x (1, K) @ W^T for a legacy W (`gtype` Q4_0, Q4_1, Q5_0, Q5_1,
// Q8_0), the plane pointers in gq_quant_gemv_kq's order (qs, qh, d, m; sc and
// scm unused; null where the format has none), all 16-byte aligned; x bf16 or
// f32, y f32 or bf16; K whole 32-element blocks; `rows` W rows a warp walks
// (1 or 2).
extern "C" int gq_quant_gemv_legacy(int gtype, const void* x, int x_bf16, const void* qs,
                                    const void* qh, const void* d, const void* m, const void*,
                                    const void*, void* y, int y_bf16, int K, int O, int rows,
                                    void* stream) {
  const bool known = gtype == Q4_0 || gtype == Q4_1 || gtype == Q5_0 || gtype == Q5_1 ||
                     gtype == Q8_0;
  if (!known || O < 1 || K < 32 || K % 32 != 0 || (rows != 1 && rows != 2))
    return cudaErrorInvalidValue;
  const bool high = gtype == Q5_0 || gtype == Q5_1, min = gtype == Q4_1 || gtype == Q5_1;
  if (!qs || !d || (high && !qh) || (min && !m)) return cudaErrorInvalidValue;
  const Planes p{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                 static_cast<const __half*>(d), static_cast<const __half*>(m), nullptr, nullptr,
                 K / 32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return y_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(gtype, x, p, y, O, rows, st)
                  : dispatch<__nv_bfloat16, float>(gtype, x, p, y, O, rows, st);
  return y_bf16 ? dispatch<float, __nv_bfloat16>(gtype, x, p, y, O, rows, st)
                : dispatch<float, float>(gtype, x, p, y, O, rows, st);
}
