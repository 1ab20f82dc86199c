// Fused dequant x matmul for S > 1 rows of f32 x on the tensor cores, held
// at f32 accuracy: y (S, O) = x (S, K) @ W^T from the planes of a
// ggml-format weight, all ten formats (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K,
// Q3_K, Q4_K, Q5_K, Q6_K), y in f32 or bf16.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/quant_matmul.py `_kern` with
// w_dtype = float32 (launched by fused_matmul_2d for f32 x). It keeps that
// kernel's correction form, with w = s_g q - c_g in each scale group g,
//     y[s,o] = sum_g s_g P_g[s,o] - c_g xg[s,g],   P_g = sum_{j in g} q_j x[s,j],
// fed by the group sums xg of group_sums_kernel (group_sums.cu) or the
// caller.
//
// What bounds it on an H100: operations. On the CUDA cores (the SIMT tile
// this kernel replaced) 2 S O K f32 FMAs at 67 TFLOP/s. Here:
//  * The codes are small integers (0..63, or -128..127 for Q8_0), exact in
//    bf16. x is cut into three bf16 terms, x0 = the top 8 significant bits
//    of x (truncated), x1 = the top 8 of x - x0, x2 = x - x0 - x1, which sum
//    to x exactly (for |x| >= 2^-110; below, within 2^-133), and never
//    overflow. Each product q * xi has at most 16 significant bits, exact in
//    f32, so P_g is three bf16 products into one f32 accumulator
//    (`mma.sync.m16n8k16`, the small terms first): f32 accuracy at
//    3 x 2 S O K operations on the bf16 tensor cores (989 TFLOP/s).
//  * Every group's partial is scaled before it joins the sum, in f32 on the
//    registers: acc = fma(s, P, acc); acc = fma(-c, xg, acc) after each
//    32-group (each 16-group for Q2_K, Q3_K and Q6_K, which are one k16
//    step each). `mma.sync` hands P over in registers at once; `wgmma` would
//    have to ping-pong two asynchronous accumulators, so `mma.sync` was
//    chosen.
//  * W as the A operand (16 W rows an m-tile), x as B (8 x rows an n-tile).
//    The W plane bytes are staged as the bf16 tile stages them
//    (quant_gemm_tc.cuh: one record per W row and 256-column unit, copied by
//    `cp.async` one unit ahead, two stages) and each thread cuts the raw
//    codes of its fragment positions out of them with the same format
//    traits; a code byte becomes its bf16 by one byte permute (0x43 above
//    it: 128 + q) and one bf16x2 FMA that takes 128 off (Q8_0's signed byte:
//    2^23 + (b ^ 0x80) as f32, less 2^23 + 128, packed by one cvt).
//  * x is staged as f32, 64 columns a slab by 16-byte `cp.async` into a ring
//    of three stages, copies two slabs ahead; rows are 72 floats apart so
//    that the 8-byte fragment loads of a half warp hit 32 different banks.
//    The slab's group sums are staged beside it (4-byte `cp.async`), so the
//    epilogue reads them from shared memory.
//    Each warp splits its own fragments of x into the three terms while it
//    loads them (x is read from shared memory by the two warps that share
//    its rows): no pre-pass and no bf16 copy of x in device memory.
//  * A block is 8 warps: 128 W rows x NT x rows (NT = 32, 64 or 128), a warp
//    64 W rows (4 m-tiles) x NT / 4 x rows; the A fragments of a group are
//    decoded once per warp and feed NT / 32 n-tiles, three products each.
//    A group's products run as 4 independent chains (one an m-tile) issued
//    side by side: with two warps a scheduler, one chain at a time left the
//    tensor cores waiting on each product's latency (1.48 ms at Falcon-7B
//    wqkvu, S = 512, on an H100: 18 cycles a product and scheduler).
//  * Rows of x past S and columns past K are zero-filled, rows of W past O
//    repeat row O - 1; both are skipped on stores. An odd K / 32 ends on a
//    half slab.
// Built per format and NT from two sources that compile side by side
// (quant_gemm_f32_legacy.cu, quant_gemm_f32_kq.cu).

#pragma once

#include "quant_gemm_tc.cuh"

namespace {

constexpr int XSTAGES = 3;    // x stages; copies run two slabs ahead
constexpr int XROW = BK + 8;  // floats between two staged x rows

// c += a b: bf16 in, f32 accumulate. Not volatile, so that the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b: the same product from a zero accumulator (no registers to clear)
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// bf16 pair (128 + q0, 128 + q1) -> (q0 - OFF, q1 - OFF), exact for
// |q - OFF| <= 128: one bf16x2 FMA with -(128 + OFF), whose bf16 bits are
// 0xC300 | OFF (OFF < 128)
template <int OFF = 0>
__device__ __forceinline__ uint32_t minus128(uint32_t v) {
  static_assert(OFF >= 0 && OFF < 128, "the offset sits in the constant's mantissa");
  constexpr uint32_t c = 0xC300u | OFF;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(c | c << 16));
  return r;
}

// One row's 32-group as exact bf16 codes less OFF (the rows kernel folds a
// format's offset there; Q8_0 takes none): f[j] packs slots 2j and 2j + 1
// (slot e of lane t is element 2t + (e & 1) + 8 (e >> 1) of the group)
template <int F, int OFF = 0>
__device__ __forceinline__ void code_pairs(const Raw& r, int gl, int t, uint32_t (&f)[4]) {
  static_assert(F != Q8_0 || OFF == 0, "Q8_0's codes are its signed bytes");
  uint32_t w[2];
  Fmt<F>::codes(r, gl, t, w);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (F == Q8_0) {
      const uint32_t u = w[j] ^ 0x80808080u;  // b + 128
      f[2 * j] = pack_bf16(two23_plus<0>(u) - 8388736.f, two23_plus<1>(u) - 8388736.f);
      f[2 * j + 1] = pack_bf16(two23_plus<2>(u) - 8388736.f, two23_plus<3>(u) - 8388736.f);
    } else {
      f[2 * j] = minus128<OFF>(__byte_perm(w[j], 0x43434343u, 0x4140));
      f[2 * j + 1] = minus128<OFF>(__byte_perm(w[j], 0x43434343u, 0x4342));
    }
  }
}

// (a, b) -> h[i] = (a_i, b_i) as bf16 pairs, a = a_0 + a_1 + a_2 exactly: each
// term is the top 16 bits of what the ones before it left (the remainders
// are exact f32 differences)
__device__ __forceinline__ void split3(float a, float b, uint32_t (&h)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
    h[i] = __byte_perm(ua, ub, 0x7632);
    if (i < 2) {
      a -= __uint_as_float(ua & 0xFFFF0000u);
      b -= __uint_as_float(ub & 0xFFFF0000u);
    }
  }
}

template <int F, int NT>
__global__ void __launch_bounds__(THREADS, 1)
quant_gemm_f32(const float* __restrict__ x, const Planes p, const float* __restrict__ xg,
               void* __restrict__ y, int y_f32, int S, int K, int O) {
  using Q = Fmt<F>;
  constexpr bool CORR = F != Q8_0;
  constexpr int NSEG = 32 / Q::SUB;  // scale groups in a 32-group
  constexpr int MT = 4;              // m-tiles (16 W rows) of a warp
  constexpr int NW = NT / 4;         // x rows of a warp
  constexpr int NTILE = NW / 8;      // its n-tiles
  constexpr int XSTAGE = NT * XROW;  // floats
  constexpr int RS = RecordStride<F>::value;
  constexpr int WSTAGE_BYTES = WStager<F>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t smem0 = (smem_base + 127u) & ~127u;  // x stages, then W stages
  const float* xsm = reinterpret_cast<const float*>(smem_raw + (smem0 - smem_base));
  uint8_t* wsm = smem_raw + (smem0 - smem_base) + XSTAGES * XSTAGE * 4;
  const uint32_t wsm0 = smem0 + XSTAGES * XSTAGE * 4;
  // then the group sums of the staged x rows: 4 floats a row and slab
  const float* xgsm = reinterpret_cast<const float*>(wsm + WSTAGES * WSTAGE_BYTES);
  const uint32_t xgsm0 = wsm0 + WSTAGES * WSTAGE_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int o_base = blockIdx.x * BM, s0 = blockIdx.y * NT;
  const int ng = p.ng, nslab = (ng + 1) / 2;

  // x slab -> stage slab % XSTAGES, 16 chunks of 16 bytes a row
  auto copy_x = [&](int slab) {
    if (slab >= nslab) return;
    const uint32_t base = smem0 + (slab % XSTAGES) * XSTAGE * 4;
#pragma unroll
    for (int it = 0; it < NT * 16 / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = idx >> 4, c = idx & 15;
      const int col = slab * BK + c * 4;
      const bool ok = s0 + r < S && col < K;
      cp_async16(base + (r * XROW + c * 4) * 4, ok ? x + (size_t)(s0 + r) * K + col : x,
                 ok ? 16 : 0);
    }
    if constexpr (CORR) {  // the slab's group sums, 2 NSEG a row, beside it
      constexpr int PER = 2 * NSEG;
      const int row_len = ng * NSEG;
      const uint32_t gbase = xgsm0 + (slab % XSTAGES) * NT * 16;
#pragma unroll
      for (int it = 0; it < (NT * PER + THREADS - 1) / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int r = idx / PER, j = idx % PER, col = slab * PER + j;
        const bool ok = s0 + r < S && col < row_len;
        if (idx < NT * PER)
          cp_async<4>(gbase + (r * 4 + j) * 4, ok ? xg + (size_t)(s0 + r) * row_len + col : xg,
                      ok ? 4 : 0);
      }
    }
  };
  WStager<F> wst{p, wsm0, wsm, o_base, O, tid};
  static_assert(WSTAGES == 2, "a group's records lie in the stage of its unit's parity");

  float acc[MT][NTILE][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  copy_x(0);
  wst.copy(0);
  cp_async_commit();
  copy_x(1);
  cp_async_commit();
  wst.load_scalars(0);
  wst.store_scalars(0);

  for (int slab = 0; slab < nslab; ++slab) {
    cp_async_wait<1>();  // this thread's copies of `slab` (and of its unit) have landed
    __syncthreads();     // everyone's have; everyone is done with slab - 1
    copy_x(slab + 2);    // into the stage slab - 1 used
    const int u = slab >> 2;
    if ((slab & 3) == 0) {  // the next unit: its stage was last read in unit u - 1
      wst.copy(u + 1);
      wst.load_scalars(u + 1);
    }
    cp_async_commit();
    if ((slab & 3) == 1) wst.store_scalars(u + 1);
    const float* xs = xsm + (slab % XSTAGES) * XSTAGE;
    const float* xgs = xgsm + (slab % XSTAGES) * NT * 4;

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gi = 2 * slab + hf;
      if (gi >= ng) break;
      const int gl = gi & 7;
      // the warp's W rows wm * 64 + 16 mt + g (and + 8): A fragments, scales
      const uint8_t* rec = wsm + ((gi >> 3) & 1) * WSTAGE_BYTES + (wm * 64 + g) * RS;
      uint32_t fa[MT][2][4];  // [m-tile][k step][register]
      float sc[MT][2][NSEG], cr[MT][2][NSEG];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        Raw ra, rb;
        Q::load(rec + mt * 16 * RS, gl, t, ra);
        Q::load(rec + (mt * 16 + 8) * RS, gl, t, rb);
        uint32_t pa[4], pb[4];
        code_pairs<F>(ra, gl, t, pa);
        code_pairs<F>(rb, gl, t, pb);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          fa[mt][ks][0] = pa[2 * ks];
          fa[mt][ks][1] = pb[2 * ks];
          fa[mt][ks][2] = pa[2 * ks + 1];
          fa[mt][ks][3] = pb[2 * ks + 1];
        }
#pragma unroll
        for (int k = 0; k < NSEG; ++k) {
          sc[mt][0][k] = ra.s[k];
          sc[mt][1][k] = rb.s[k];
          cr[mt][0][k] = ra.c[k];
          cr[mt][1][k] = rb.c[k];
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt) {
        const int xr = wn * NW + nt * 8;  // the n-tile's first x row in the block
        // B fragments: x row xr + g at columns 2t, 2t+1 | 2t+8, 2t+9 (k step 0)
        // and 16 more (k step 1), each as three bf16 terms
        const float* xp = xs + (xr + g) * XROW + hf * 32 + 2 * t;
        uint32_t b[3][2][2];  // [term][k step][register]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(xp + 8 * i);
          uint32_t h[3];
          split3(v.x, v.y, h);
#pragma unroll
          for (int term = 0; term < 3; ++term) b[term][i >> 1][i & 1] = h[term];
        }
        float xgv[NSEG][2];  // group sums of the thread's output columns 2t, 2t+1
#pragma unroll
        for (int k = 0; k < NSEG; ++k)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            xgv[k][c] = CORR ? xgs[(xr + 2 * t + c) * 4 + hf * NSEG + k] : 0.f;
        // each scale group's partial of the MT m-tiles: MT independent chains
        // of products, issued side by side so that one's latency hides
        // behind the others'
#pragma unroll
        for (int k = 0; k < NSEG; ++k) {
          float P[MT][4];
#pragma unroll
          for (int ks = k; ks < (NSEG == 1 ? 2 : k + 1); ++ks)
#pragma unroll
            for (int term = 2; term >= 0; --term)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                if (ks == k && term == 2)
                  mma_bf16_first(P[mt], fa[mt][ks], b[term][ks][0], b[term][ks][1]);
                else
                  mma_bf16(P[mt], fa[mt][ks], b[term][ks][0], b[term][ks][1]);
              }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float a = fmaf(sc[mt][c >> 1][k], P[mt][c], acc[mt][nt][c]);
              if (CORR) a = fmaf(-cr[mt][c >> 1][k], xgv[k][c & 1], a);
              acc[mt][nt][c] = a;
            }
        }
      }
    }
  }

  // acc[mt][nt][c]: x row s0 + wn NW + 8 nt + 2t + (c & 1), W row o_base + 64 wm + 16 mt + g + 8 (c >> 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = s0 + wn * NW + 8 * nt + 2 * t + (c & 1);
        const int o = o_base + wm * 64 + 16 * mt + g + 8 * (c >> 1);
        if (s < S && o < O) store_y(y, y_f32 != 0, (size_t)s * O + o, acc[mt][nt][c]);
      }
}

template <int F, int NT>
cudaError_t launch_f32_nt(const void* x, const Planes& p, const void* xg, void* y, int y_f32,
                          int S, int K, int O, cudaStream_t st) {
  constexpr int SMEM =
      XSTAGES * NT * (XROW + 4) * 4 + WSTAGES * BM * RecordStride<F>::value + 128;
  static size_t granted[gq::MAX_DEVICES] = {};
  cudaError_t e = gq::grant_smem(quant_gemm_f32<F, NT>, SMEM, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((O + BM - 1) / BM, (S + NT - 1) / NT);
  quant_gemm_f32<F, NT><<<grid, THREADS, SMEM, st>>>(static_cast<const float*>(x), p,
                                                     static_cast<const float*>(xg), y, y_f32, S,
                                                     K, O);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_f32(int nt, const void* x, const Planes& p, const void* xg, void* y, int y_f32,
                       int S, int K, int O, cudaStream_t st) {
  if (F != Q8_0 && xg == nullptr) return cudaErrorInvalidValue;
  switch (nt) {
    case 32: return launch_f32_nt<F, 32>(x, p, xg, y, y_f32, S, K, O, st);
    case 64: return launch_f32_nt<F, 64>(x, p, xg, y, y_f32, S, K, O, st);
    case 128: return launch_f32_nt<F, 128>(x, p, xg, y, y_f32, S, K, O, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
