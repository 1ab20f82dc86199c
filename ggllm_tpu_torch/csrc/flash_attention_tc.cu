// Causal MQA/GQA prefill attention for bf16 q/k/v on the tensor cores, with
// an f32 online softmax.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_attention.py `_kern`
// (launched by flash_mqa) for bf16 at D = 32, 64 and 128; flash_attention_f32.cu
// takes f32.
// Semantics as there: key t is visible to query i of batch row b iff
// t <= n_past[b] + i; masked scores are -1e30 (not -inf); out = acc /
// max(l, 1e-30) in bf16.
//
// What bounds it on an H100: operations (4 D per visible (query, key) pair
// and head); K/V are small and stay in L2. The design:
//  * Both products run as `mma.sync.m16n8k16` (bf16 in, f32 out) with
//    `ldmatrix` feeding the fragments (`.trans` for V): S = Q K^T with K's
//    (t, D) rows as the column-major B operand, then P rounded to bf16 in
//    registers (the score accumulators are the A fragments of the second
//    product) times V. A warp owns 16 query rows: its row maxima and sums
//    need only the 4 lanes that share a row.
//  * A block is 4 warps = 64 query rows that share ONE K/V head. The rows of
//    a K/V head are its (position, head) pairs ordered position-major, row
//    r = position * G + head, so a block spans few positions (1-2 at
//    Falcon-7B's G = 71, 4 at Falcon-40B's G = 16, 64 at G = 1): the key
//    loop ends at the block's last visible key, tiles wholly below every
//    row's diagonal skip the mask, and with G == 1 the layout is the usual
//    64 positions of one head. The K/V tile of 64 keys (128 at D = 32)
//    feeds all 64 rows.
//  * K and V tiles are staged as bf16 (half of the f32 staging of
//    flash_attention_f32.cu) by 16-byte `cp.async`, double-buffered, in an XOR
//    swizzle (smem_off) so that every ldmatrix phase reads its 8 rows from 8
//    different 16-byte bank groups of a 128-byte line. At D = 32 a row is
//    half a line (36 KB of shared memory a block).
//  * Blocks with the most keys (the last positions) start first.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BR = 64;  // query rows per block (16 per warp)
// keys per staged tile: 128 at D = 32, where half as many loop trips took
// 15-22 % less device time than 64-key tiles on an H100 at the small models'
// and the training demo's layouts (tools/time_kernels.py mqa32)
template <int D>
constexpr int KEYS = D == 32 ? 128 : 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

using gq::cp_async16;
using gq::cp_async_commit;
using gq::cp_async_wait;
using gq::ldsm4;
using gq::ldsm4_trans;
using gq::mma16816;
using gq::pack_bf16;

// Byte offset of 16-byte chunk c of row `row` in a staged tile of rows of D
// bf16 (Q, K and V alike; every stage and ldmatrix address goes through
// it). D >= 64: chunk c of row r at chunk c ^ (r & 7) of its row, which stays
// in the row's 128-byte line. D = 32 (4 chunks a row, two rows a line): at
// chunk c ^ ((r >> 1) & 3) of its row, so that the 8 rows of an ldmatrix
// phase (aligned to 8, one chunk) land on 8 distinct slots of a line.
// Restated in kernels/flash_attention.py tc_smem_offset.
template <int D>
__device__ __forceinline__ uint32_t smem_off(int row, int c) {
  const int x = D >= 64 ? (row & 7) : ((row >> 1) & 3);
  return (uint32_t)(row * D * 2 + ((c ^ x) << 4));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mqa_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    const int* __restrict__ n_past_vec, int n_past_scalar, int S, int H, int Tn,
                    int KV, long long kv_bstride, long long kv_tstride) {
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int ROWB = D * 2;   // bytes per row
  constexpr int BT = KEYS<D>;
  constexpr int TILE = BT * ROWB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 127u) & ~127u;
  const uint32_t ks = qs + BR * ROWB;  // two K tiles, then two V tiles
  const uint32_t vs = ks + 2 * TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int rb = gridDim.x - 1 - blockIdx.x;  // the longest key loops first
  const int G = H / KV;
  const int nrows = S * G, r0 = rb * BR;
  const int n_past = n_past_vec ? n_past_vec[b] : n_past_scalar;
  const int p_lo = r0 / G, p_hi = min(r0 + BR - 1, nrows - 1) / G;
  const int t_end = min(Tn, n_past + p_hi + 1);  // keys any row of the block sees
  const int t_full = n_past + p_lo + 1;          // keys every row of the block sees
  const int ntiles = (t_end + BT - 1) / BT;

  // row r of the K/V head -> element offset of its q / out row
  auto row_off = [&](int r) {
    r = min(r, nrows - 1);
    return (((size_t)b * S + r / G) * H + kvh * G + r % G) * D;
  };
  const __nv_bfloat16* kb = k + (size_t)b * kv_bstride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * kv_bstride + (size_t)kvh * D;

  auto load_tile = [&](int tile, int buf) {
#pragma unroll
    for (int it = 0; it < BT * CH / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int key = idx / CH, c = idx % CH;
      const int t = tile * BT + key;
      const bool ok = t < t_end;  // keys past the block's last are zeros
      const size_t off = (size_t)(ok ? t : 0) * kv_tstride + c * 8;
      const uint32_t dst = buf * TILE + smem_off<D>(key, c);
      cp_async16(ks + dst, kb + off, ok ? 16 : 0);
      cp_async16(vs + dst, vb + off, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int it = 0; it < BR * CH / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx / CH, c = idx % CH;
    cp_async16(qs + smem_off<D>(r, c), q + row_off(r0 + r) + c * 8, 16);
  }
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // last key each of the thread's two rows (g4 and g4 + 8 of the warp's 16) sees
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lim[i] = n_past + min(r0 + warp * 16 + g4 + 8 * i, nrows - 1) / G;
  const float sl2 = 1.4426950408889634f / sqrtf((float)D);  // scale * log2(e)

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int row = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int c = kk * 2 + (lane >> 4);
        ldsm4(qs + smem_off<D>(row, c), qf[kk]);
      }
    }
    const uint32_t kt = ks + buf * TILE, vt = vs + buf * TILE;

    float s[BT / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < BT / 8; ++n8) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n8][c] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < D / 32; ++k2) {
        uint32_t bf[4];
        const int row = n8 * 8 + (lane & 7);
        const int c = k2 * 4 + (lane >> 3);
        ldsm4(kt + smem_off<D>(row, c), bf);
        mma16816(s[n8], qf[2 * k2], bf[0], bf[1]);
        mma16816(s[n8], qf[2 * k2 + 1], bf[2], bf[3]);
      }
    }

    const int t0 = tile * BT;
    if (t0 + BT > t_full || t0 + BT > Tn) {  // the tile crosses a row's diagonal
#pragma unroll
      for (int n8 = 0; n8 < BT / 8; ++n8)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = t0 + n8 * 8 + 2 * t4 + (c & 1);
          if (t > lim[c >> 1] || t >= Tn) s[n8][c] = NEG_INF;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n8 = 0; n8 < BT / 8; ++n8) mx = fmaxf(mx, fmaxf(s[n8][2 * i], s[n8][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f((m[i] - mx) * sl2);
      m[i] = mx;
      const float ms = mx * sl2;
      float sum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < BT / 8; ++n8) {
        s[n8][2 * i] = exp2f(fmaf(s[n8][2 * i], sl2, -ms));
        s[n8][2 * i + 1] = exp2f(fmaf(s[n8][2 * i + 1], sl2, -ms));
        sum += s[n8][2 * i] + s[n8][2 * i + 1];
      }
      l[i] = l[i] * alpha + sum;  // this lane's columns; lanes are summed at the end
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n16 = 0; n16 < D / 16; ++n16) {
        uint32_t bf[4];
        const int row = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int c = n16 * 2 + (lane >> 4);
        ldsm4_trans(vt + smem_off<D>(row, c), bf);
        mma16816(o[2 * n16], a, bf[0], bf[1]);
        mma16816(o[2 * n16 + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the tile is free before the next iteration's copies land in it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = r0 + warp * 16 + g4 + 8 * i;
    if (r >= nrows) continue;
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    __nv_bfloat16* op = out + row_off(r) + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j) = pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int* npv, int np,
                   int B, int S, int H, int Tn, int KV, long long bstride, long long tstride,
                   cudaStream_t st) {
  constexpr int BT = KEYS<D>;
  constexpr int SMEM = (BR + 4 * BT) * D * 2 + 128;
  static size_t granted[gq::MAX_DEVICES] = {};
  cudaError_t e = gq::grant_smem(flash_mqa_tc_kernel<D>, SMEM, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((S * (H / KV) + BR - 1) / BR, KV, B);
  flash_mqa_tc_kernel<D><<<grid, THREADS, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), npv, np, S, H, Tn, KV,
      bstride, tstride);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B, S, H, D) and out contiguous, D in {32, 64, 128}; k/v (B, T, KV, D)
// bf16, 16-byte aligned, with the given batch and time strides (in elements,
// multiples of 16 bytes) and contiguous heads. n_past_vec (B,) int32 on the
// device, or null to use n_past for every row.
extern "C" int gq_flash_mqa_tc(const void* q, const void* k, const void* v, void* out,
                               const void* n_past_vec, int n_past, int B, int S, int H, int Tn,
                               int KV, int D, long long kv_bstride, long long kv_tstride,
                               void* stream) {
  if (B < 1 || S < 1 || KV < 1 || Tn < 1 || H % KV != 0 || KV > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* npv = static_cast<const int*>(n_past_vec);
  if (D == 32)
    return launch<32>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride, kv_tstride, st);
  if (D == 64)
    return launch<64>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride, kv_tstride, st);
  if (D == 128)
    return launch<128>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride, kv_tstride, st);
  return cudaErrorInvalidValue;
}
