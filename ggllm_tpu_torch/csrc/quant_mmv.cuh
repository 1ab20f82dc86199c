// Fused dequant x matmul for 2 <= S <= 16 rows of bf16 x (B decode rows of
// continuous batching): y (S, O) = x (S, K) @ W^T from the planes of a
// ggml-format weight, all ten formats (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K,
// Q3_K, Q4_K, Q5_K, Q6_K), y in bf16 or f32, every weight decoded once for
// all rows.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/quant_matmul.py `_kern`
// (launched by fused_matmul_2d, which takes any S with bs = min(S, 256)) in
// the regime of B decode rows; one row runs the GEMVs (gemv.cuh), more than
// 16 bf16 rows the `wgmma` tile (quant_gemm_tc.cuh), f32 rows the f32 tile.
//
// What bounds it on an H100: the weight bytes. At S <= 16 they are the same
// as at S = 1, and x and y are about 0.1 % of them (Falcon-7B Q4_0 w_od:
// 0.0174 ms at 3.35 TB/s), so the design has to keep the weight stream at
// the GEMV's rate while it does S times the GEMV's multiply work. On the
// CUDA cores that work would take more issue slots than the bytes leave; the
// tensor cores take it:
//  * W is the A operand of `mma.sync.m16n8k16` (bf16 in, f32 accumulate), x
//    the B operand: 16 W rows an m-tile, 8 x rows an n-tile (S <= 8 one,
//    9-16 two). Fragments of x rows past S are zero and their y is never
//    stored. Each output element sums over k alone, so a row's y does not
//    depend on the other rows.
//  * Exact codes, exact products. A code byte becomes its bf16 by the f32
//    tile's byte permute and one bf16x2 FMA (quant_gemm_f32.cuh code_pairs),
//    which also takes the format's folded offset off (Q4_0 8, Q5_0 16, Q3_K
//    4, Q6_K 32, as the GEMV folds them: the code less it is a small integer,
//    exact in bf16; Q8_0 is its signed byte). x is one bf16 term, so every
//    product q x has at most 16 significant bits and is exact in f32.
//  * One scale group a partial: P_g starts from a zero accumulator and joins
//    the sum in f32 on the registers in group order, acc = fma(s_g, P_g, acc),
//    then acc = fma(-c_g, xg_g, acc) for the formats that pay a correction
//    (Q4_1, Q5_1, Q2_K, Q4_K, Q5_K). The group sums xg come from the x the
//    block has loaded, as one more product of x's fragment with an all-ones
//    A fragment (no group_sums launch).
//  * The weight stream: the tiles' records (quant_gemm_tc.cuh WStager: a unit
//    of 256 columns of each of the block's W rows, code, high-bit and
//    sub-scale bytes by 16-, 8- and 4-byte `cp.async`), and the fragment
//    decode of quant_gemm_tc.cuh's format traits, RSTAGES units deep, copies
//    RSTAGES - 1 units ahead, which with two blocks an SM keeps about 25 KB
//    an SM in flight (3.35 TB/s times a microsecond over 132 SMs). The fp16
//    scales go by 4-byte `cp.async` too where a row's start allows it (the
//    legacy formats at an even count of 32-groups: every model's); else
//    (2-byte pieces: the K-quants' d and dmin, odd legacy counts) they are
//    asked of L2 with the unit's copies (prefetch), loaded into registers
//    two units ahead (two register sets) and stored into the records a unit
//    ahead, so no unit waits on a load from device memory. x goes the same
//    way as the records, a unit's 256 columns of the S rows a stage, rows
//    RXROW bytes apart so that a warp's fragment loads hit 32 banks. Every
//    weight byte is read once, x once a block.
//  * Enough SMs at few output rows, deterministically. A block is RWARPS = 8
//    warps over RMT = 4 m-tiles (64 W rows: a unit's copies and x's
//    fragments serve them all), and K is split among its warps: warp w
//    takes the 32-group w of every unit it stages, in order, so each unit's
//    records feed all the warps. Where the row blocks are few (Falcon-7B's
//    w_od: 71 for 132 SMs) a cluster of CL = 2 blocks shares them, block r
//    staging the units r, r + 2, ... (kernels/quant_matmul.py rows_cluster).
//    The warps' partial sums meet in shared memory in a fixed order (warp 0
//    + ... + warp 7), then the cluster's through distributed shared memory
//    (block 0 + block 1). No atomics: y is the same on every run, and a
//    row's y depends on O alone, not on the batch. (Narrower blocks, or 16
//    warps a block over unit pairs, were slower on an H100: PERF.md.)
//  * No integer-to-float conversion anywhere (codes by byte permutes, scales
//    by the 2^23 trick): chip_smoke.py checks every instantiation's SASS
//    (tools/sass_report.py parse_rows_sass).
// kernels/quant_matmul.py rows_emulated restates the arithmetic. Built per
// format, n-tiles (1, 2) and cluster size (1, 2) from two sources that
// compile side by side (quant_mmv_legacy.cu, quant_mmv_kq.cu).

#pragma once

#include <cooperative_groups.h>

#include "quant_gemm_f32.cuh"

namespace {

constexpr int RWARPS = 8;               // warps a block: the K split (a unit's 32-group each)
constexpr int RTHREADS = RWARPS * 32;
constexpr int RXROW = 256 * 2 + 16;     // bytes between two staged x rows
constexpr uint32_t ONES = 0x3F803F80u;  // the bf16 pair (1, 1)

// the offset folded into a format's codes (no correction term for these)
template <int F> struct RowsOffset { static constexpr int value = 0; };
template <> struct RowsOffset<Q4_0> { static constexpr int value = 8; };
template <> struct RowsOffset<Q5_0> { static constexpr int value = 16; };
template <> struct RowsOffset<Q3_K> { static constexpr int value = 4; };
template <> struct RowsOffset<Q6_K> { static constexpr int value = 32; };

constexpr int RMT = 4;      // m-tiles (16 W rows) a block
constexpr int RSTAGES = 4;  // W and x stages; copies run RSTAGES - 1 units ahead

template <int F, int NT, int CL>
__global__ void __launch_bounds__(RTHREADS, 2)
quant_mmv_rows(const __nv_bfloat16* __restrict__ x, const Planes p, void* __restrict__ y,
               int y_f32, int S, int K, int O) {
  using Q = Fmt<F>;
  constexpr int MT = RMT;
  using WS = WStager<F, 16 * MT, RTHREADS, RSTAGES>;
  constexpr int OFF = RowsOffset<F>::value;
  constexpr bool CORR = F == Q4_1 || F == Q5_1 || F == Q2_K || F == Q4_K || F == Q5_K;
  constexpr int NSEG = 32 / Q::SUB;  // scale groups in a 32-group
  constexpr int RS = WS::RS;
  constexpr int XSTAGE = 8 * NT * RXROW;  // bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t smem0 = (smem_base + 127u) & ~127u;  // x stages, then W stages
  uint8_t* xsm = smem_raw + (smem0 - smem_base);
  uint8_t* wsm = xsm + RSTAGES * XSTAGE;
  const uint32_t wsm0 = smem0 + RSTAGES * XSTAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a cluster of CL blocks shares the block's W rows, block `rank` taking the
  // units rank, rank + CL, ...: local unit i is unit i CL + rank of the row
  const int rank = CL == 1 ? 0 : (int)cooperative_groups::this_cluster().block_rank();
  const int o_base = blockIdx.x / CL * 16 * MT;
  const int ng = p.ng, nunit = (ng + 7) >> 3;
  const int nlocal = (nunit - rank + CL - 1) / CL;

  // The copies are spread over all the warps, so that no warp reaches the
  // unit's barrier late: x's chunks 4 warp ... 4 warp + 3 of rows lane / 4
  // (and + 8) go by this warp; the records' chunk (row, c) by the thread
  // `stager`, whose warp takes rows warp, warp + 8, ... and whose lanes
  // 8 j ... 8 j + 7 the chunks of one row (a permutation of the threads).
  const int stager = (((lane >> 3) * RWARPS + warp) << 3) | (lane & 7);

  // unit u of the S rows of x -> stage `slot` % RSTAGES, 32 chunks of 16
  // bytes a row; columns past K become zeros, rows past S are not copied
  auto copy_x = [&](int u, int slot) {
    const uint32_t base = smem0 + (slot % RSTAGES) * XSTAGE;
#pragma unroll
    for (int it = 0; it < NT; ++it) {
      const int r = 8 * it + (lane >> 2), c = 4 * warp + (lane & 3);
      const int col = u * 256 + c * 8;
      if (r < S) {
        const bool ok = col < K;
        cp_async16(base + r * RXROW + c * 16, ok ? x + (size_t)r * K + col : x, ok ? 16 : 0);
      }
    }
  };
  // the records' stager; its scalars (fp16 scales) of even units, and of odd ones
  WS wst{p, wsm0, wsm, o_base, O, stager}, wodd{p, wsm0, wsm, o_base, O, stager};

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  // the scales by cp.async with the rest of the unit, or through registers
  bool async_scalars = false;
  if constexpr (WS::N16 == 8) async_scalars = (ng & 1) == 0;
  auto copy_unit = [&](int i) {  // local unit i into stage i % RSTAGES
    if (i >= nlocal) return;
    const int u = i * CL + rank;
    copy_x(u, i);
    wst.copy(u, i);
    if constexpr (WS::N16 == 8) {
      if (async_scalars) {
        wst.copy_scalars(u, i);
        return;
      }
    }
    wst.prefetch_scalars(u);
  };
#pragma unroll
  for (int i = 0; i + 1 < RSTAGES; ++i) {
    copy_unit(i);
    cp_async_commit();
  }
  // the scales of local unit i (none past the last: load_scalars gives zeros)
  auto scales_of = [&](int i) { return i < nlocal ? i * CL + rank : nunit; };
  if (!async_scalars) {
    wst.load_scalars(scales_of(0));
    wst.store_scalars(0);
    wodd.load_scalars(scales_of(1));
  }

  // local unit i: its copies landed, the copies of local unit i + RSTAGES - 1
  // started, the scalars of local unit i + 2 loaded into `ahead` and those of
  // i + 1 (loaded a unit ago) stored from `next`
  auto unit = [&](int i, WS& next, WS& ahead) {
    cp_async_wait<RSTAGES - 2>();  // this thread's copies of unit i have landed
    __syncthreads();               // everyone's have; everyone is done with unit i - 1
    copy_unit(i + RSTAGES - 1);    // into the stage unit i - 1 used
    cp_async_commit();
    if (!async_scalars) ahead.load_scalars(scales_of(i + 2));
    const int u = i * CL + rank;
    const int gi = 8 * u + warp;
    if (gi < ng) {
      // B fragments of the warp's 32-group: x row 8 nt + g at columns 2t, 2t+1
      // | 2t+8, 2t+9 (k step 0) and 16 more (k step 1)
      const uint8_t* xs = xsm + (i % RSTAGES) * XSTAGE + warp * 64 + 4 * t;
      uint32_t b[NT][2][2];  // [n-tile][k step][register]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + g;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            b[nt][ks][j] =
                r < S ? *reinterpret_cast<const uint32_t*>(xs + r * RXROW + 32 * ks + 16 * j) : 0u;
      }
      // the group sums of the thread's output columns, x rows 8 nt + 2t and
      // + 1: the all-ones A fragment times x's
      float xg[NT][NSEG][2];
      if constexpr (CORR) {
        const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int k = 0; k < NSEG; ++k) {
            float P1[4];
#pragma unroll
            for (int ks = k; ks < (NSEG == 1 ? 2 : k + 1); ++ks) {
              if (ks == k)
                mma_bf16_first(P1, ones, b[nt][ks][0], b[nt][ks][1]);
              else
                mma_bf16(P1, ones, b[nt][ks][0], b[nt][ks][1]);
            }
            xg[nt][k][0] = P1[0];
            xg[nt][k][1] = P1[1];
          }
      }
      // the block's W rows 16 mt + g (and + 8), the warp's 32-group of the unit
      const uint8_t* rec = wsm + (i % RSTAGES) * WS::STAGE_BYTES + g * RS;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        Raw ra, rb;
        Q::load(rec + mt * 16 * RS, warp, t, ra);
        Q::load(rec + (mt * 16 + 8) * RS, warp, t, rb);
        uint32_t pa[4], pb[4];
        code_pairs<F, OFF>(ra, warp, t, pa);
        code_pairs<F, OFF>(rb, warp, t, pb);
        const uint32_t fa[2][4] = {{pa[0], pb[0], pa[1], pb[1]}, {pa[2], pb[2], pa[3], pb[3]}};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int k = 0; k < NSEG; ++k) {
            float P[4];
#pragma unroll
            for (int ks = k; ks < (NSEG == 1 ? 2 : k + 1); ++ks) {
              if (ks == k)
                mma_bf16_first(P, fa[ks], b[nt][ks][0], b[nt][ks][1]);
              else
                mma_bf16(P, fa[ks], b[nt][ks][0], b[nt][ks][1]);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const Raw& r = c < 2 ? ra : rb;
              float a = fmaf(r.s[k], P[c], acc[mt][nt][c]);
              if constexpr (CORR) a = fmaf(-r.c[k], xg[nt][k][c & 1], a);
              acc[mt][nt][c] = a;
            }
          }
      }
    }
    if (!async_scalars) next.store_scalars(i + 1);
  };
  for (int i = 0; i < nlocal; i += 2) {
    unit(i, wodd, wst);  // local unit i + 1 is odd, i + 2 even
    if (i + 1 < nlocal) unit(i + 1, wst, wodd);
  }

  // the warps' partial sums, in shared memory (the stages are free once every
  // copy has landed and every warp is past its last pair), summed in warp order
  constexpr int PER = MT * NT * 4;  // partial sums a thread
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(xsm);  // [warp][PER][lane]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((warp * MT + mt) * NT + nt) * 128 + c * 32 + lane] = acc[mt][nt][c];
  __syncthreads();
  constexpr int ITS = (PER * 32 + RTHREADS - 1) / RTHREADS;
  float v[ITS];  // the block's sum of (m-tile, n-tile, register, lane) e = tid + it RTHREADS
#pragma unroll
  for (int it = 0; it < ITS; ++it) {
    const int e = tid + it * RTHREADS;
    v[it] = 0.f;
    if (PER * 32 % RTHREADS == 0 || e < PER * 32) {
      v[it] = red[e];
#pragma unroll
      for (int w = 1; w < RWARPS; ++w) v[it] += red[w * PER * 32 + e];
    }
  }
  if constexpr (CL == 2) {  // rank 1's sums join rank 0's through distributed shared memory
    auto cluster = cooperative_groups::this_cluster();
    __syncthreads();  // red is read: it takes the sums
    if (rank == 1) {
#pragma unroll
      for (int it = 0; it < ITS; ++it) red[tid + it * RTHREADS] = v[it];
    }
    cluster.sync();
    if (rank == 0) {
      const float* other = cluster.map_shared_rank(red, 1);
#pragma unroll
      for (int it = 0; it < ITS; ++it) {
        const int e = tid + it * RTHREADS;
        if (PER * 32 % RTHREADS == 0 || e < PER * 32) v[it] += other[e];
      }
    }
    cluster.sync();  // rank 1's shared memory outlives rank 0's reads
  }
  if (rank == 0) {
#pragma unroll
    for (int it = 0; it < ITS; ++it) {
      const int e = tid + it * RTHREADS;
      if (PER * 32 % RTHREADS == 0 || e < PER * 32) {
        const int ln = e & 31, c = (e >> 5) & 3, nt = (e >> 7) % NT, mt = (e >> 7) / NT;
        // register c of lane ln: x row 8 nt + 2 (ln & 3) + (c & 1), W row 16 mt + ln / 4 + 8 (c >> 1)
        const int s = 8 * nt + 2 * (ln & 3) + (c & 1);
        const int o = o_base + 16 * mt + (ln >> 2) + 8 * (c >> 1);
        if (s < S && o < O) store_y(y, y_f32 != 0, (size_t)s * O + o, v[it]);
      }
    }
  }
}

template <int F, int NT, int CL>
cudaError_t launch_rows_nt(const void* x, const Planes& p, void* y, int y_f32, int S, int K, int O,
                           cudaStream_t st) {
  constexpr int STAGES_BYTES = RSTAGES * (8 * NT * RXROW + 16 * RMT * RecordStride<F>::value);
  constexpr int RED_BYTES = RWARPS * RMT * NT * 128 * 4;
  constexpr int SMEM = (STAGES_BYTES > RED_BYTES ? STAGES_BYTES : RED_BYTES) + 128;
  static size_t granted[gq::MAX_DEVICES] = {};
  cudaError_t e = gq::grant_smem(quant_mmv_rows<F, NT, CL>, SMEM, granted);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((O + 16 * RMT - 1) / (16 * RMT)));
  cfg.blockDim = dim3(RTHREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, quant_mmv_rows<F, NT, CL>, static_cast<const __nv_bfloat16*>(x),
                         p, y, y_f32, S, K, O);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// cl: blocks of a cluster that split K (1, 2)
template <int F>
cudaError_t launch_rows(int cl, const void* x, const Planes& p, void* y, int y_f32, int S, int K,
                        int O, cudaStream_t st) {
  const bool two = S > 8;
  switch (cl) {
    case 1: return two ? launch_rows_nt<F, 2, 1>(x, p, y, y_f32, S, K, O, st)
                       : launch_rows_nt<F, 1, 1>(x, p, y, y_f32, S, K, O, st);
    case 2: return two ? launch_rows_nt<F, 2, 2>(x, p, y, y_f32, S, K, O, st)
                       : launch_rows_nt<F, 1, 2>(x, p, y, y_f32, S, K, O, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
