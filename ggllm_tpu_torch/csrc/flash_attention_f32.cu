// Causal MQA/GQA prefill attention for f32 q/k/v on the tensor cores, held at
// f32 accuracy, with an f32 online softmax.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_attention.py `_kern`
// (launched by flash_mqa) for f32 inputs. Semantics as there: key t is
// visible to query i of batch row b iff t <= n_past[b] + i; masked scores
// are -1e30 (not -inf); out = acc / max(l, 1e-30).
//
// What bounds it on an H100: operations, 4 D per visible (query, key) pair
// and head. In f32 on the CUDA cores (the kernels this one replaced) that is
// 67 TFLOP/s. Here both products run on the tensor cores as split TF32:
//  * every operand a is cut into a_hi = tf32(a) and a_lo = tf32(a - a_hi)
//    (cvt.rna: round to nearest, ties away from zero), and a product is the
//    sum of three `mma.sync.m16n8k8.tf32` products, lo x hi and hi x lo
//    first, then hi x hi, into one f32 accumulator: S = Q K^T, then the f32
//    online softmax, then P (split after it) times V. What the dropped
//    lo x lo term and the remainders leave is about 2^-21 of each product:
//    f32 level, at 3 x 4 D operations a pair at 495 TFLOP/s.
//  * The block plan of the bf16 kernel (flash_attention_tc.cu): a block is
//    4 warps = 64 (position, head) rows of ONE K/V head, position-major (row
//    r = position * G + head), a warp 16 of them; the key loop ends at the
//    block's last visible key, tiles wholly below every row's diagonal skip
//    the mask, and blocks with the most keys start first.
//  * K and V tiles of BT keys (64; 32 at D = 128, whose f32 tiles are twice
//    as wide) are staged as f32 by 16-byte `cp.async`, double-buffered, and
//    the block's 64 q rows once; rows D + 4 floats apart, so that the
//    fragment loads of a warp (8 rows x 4 dimensions for q and K, 4 key
//    pairs x 8 dimensions for V) hit 32 different banks. Each warp splits
//    the fragments it loads. q stays in shared memory, not in registers:
//    held there it took 255 registers and spilled at D = 128.
//  * The three products of a k step run as independent chains side by
//    side (all 8-key tiles of the step for S; 4 dimension tiles at a time
//    for P V), so that one product's latency hides behind the others'.
//  * The P.V product takes its keys in the order the score accumulators
//    hold them (lane t holds keys 2t and 2t + 1 of an 8-key step, which the
//    A fragment of m16n8k8 puts at k = t and t + 4), so P goes from the
//    first product to the second without a shuffle; V's B fragment reads
//    the same keys.
// D = 32, 64 and 128.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BR = 64;  // query rows per block (16 per warp)
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

using gq::cp_async16;
using gq::cp_async_commit;
using gq::cp_async_wait;
using gq::mma_tf32;
using gq::split_tf32;

template <int D>
struct Tile {
  static constexpr int BT = D > 64 ? 32 : 64;  // keys per staged tile
  static constexpr int ROW = D + 4;            // floats between two staged rows
  static constexpr int SMEM = (BR + 4 * BT) * ROW * 4;  // q, two K tiles, two V tiles
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mqa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     const int* __restrict__ n_past_vec, int n_past_scalar, int S, int H, int Tn,
                     int KV, long long kv_bstride, long long kv_tstride) {
  constexpr int BT = Tile<D>::BT, ROW = Tile<D>::ROW, TILE = BT * ROW;
  constexpr int CH = D / 4;  // 16-byte chunks a key
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // the block's q rows, two K tiles, two V tiles
  float* ks = smem + BR * ROW;
  float* vs = ks + 2 * TILE;
  const uint32_t qs_s = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t ks_s = (uint32_t)__cvta_generic_to_shared(ks);
  const uint32_t vs_s = (uint32_t)__cvta_generic_to_shared(vs);

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
  const float* kb = k + (size_t)b * kv_bstride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * kv_bstride + (size_t)kvh * D;

  auto load_tile = [&](int tile, int buf) {
#pragma unroll
    for (int it = 0; it < BT * CH / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int key = idx / CH, c = idx % CH;
      const int t = tile * BT + key;
      const bool ok = t < t_end;  // keys past the block's last are zeros
      const size_t off = (size_t)(ok ? t : 0) * kv_tstride + c * 4;
      const uint32_t dst = (buf * TILE + key * ROW + c * 4) * 4;
      cp_async16(ks_s + dst, kb + off, ok ? 16 : 0);
      cp_async16(vs_s + dst, vb + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int it = 0; it < BR * CH / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx / CH, c = idx % CH;
    cp_async16(qs_s + (r * ROW + c * 4) * 4, q + row_off(r0 + r) + c * 4, 16);
  }
  load_tile(0, 0);
  cp_async_commit();

  // the thread's rows: g4 and g4 + 8 of the warp's 16
  const int ra = r0 + warp * 16 + g4;
  const float* qw = qs + (warp * 16 + g4) * ROW + t4;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  int lim[2];  // the last key each of the thread's two rows sees
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = n_past + min(ra + 8 * i, nrows - 1) / G;
  const float sl2 = 1.4426950408889634f / sqrtf((float)D);  // scale * log2(e)

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + buf * TILE;
    const float* vt = vs + buf * TILE;

    // S = Q K^T: key n8 * 8 + g4 at dims 8kk + t4 and + 4 is K's B fragment
    float s[BT / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < BT / 8; ++n8)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n8][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      // q's A fragment: (row, dim) = (g4, 8kk+t4), (g4+8, ..), (g4, 8kk+t4+4), (g4+8, ..)
      uint32_t qh[4], ql[4];
      split_tf32(qw[8 * kk], qh[0], ql[0]);
      split_tf32(qw[8 * kk + 8 * ROW], qh[1], ql[1]);
      split_tf32(qw[8 * kk + 4], qh[2], ql[2]);
      split_tf32(qw[8 * kk + 8 * ROW + 4], qh[3], ql[3]);
      uint32_t kh[BT / 8][2], kl[BT / 8][2];
#pragma unroll
      for (int n8 = 0; n8 < BT / 8; ++n8) {
        const float* kp = kt + (n8 * 8 + g4) * ROW + kk * 8 + t4;
        split_tf32(kp[0], kh[n8][0], kl[n8][0]);
        split_tf32(kp[4], kh[n8][1], kl[n8][1]);
      }
#pragma unroll
      for (int n8 = 0; n8 < BT / 8; ++n8) mma_tf32(s[n8], ql, kh[n8][0], kh[n8][1]);
#pragma unroll
      for (int n8 = 0; n8 < BT / 8; ++n8) mma_tf32(s[n8], qh, kl[n8][0], kl[n8][1]);
#pragma unroll
      for (int n8 = 0; n8 < BT / 8; ++n8) mma_tf32(s[n8], qh, kh[n8][0], kh[n8][1]);
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

    // O += P V over 8-key steps j: lane t4's keys 2t4, 2t4 + 1 at k = t4, t4 + 4
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int n0 = 0; n0 < D / 8; n0 += 4) {  // 4 dimension tiles side by side
        uint32_t vh[4][2], vl[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* vp = vt + (j * 8 + 2 * t4) * ROW + (n0 + i) * 8 + g4;
          split_tf32(vp[0], vh[i][0], vl[i][0]);
          split_tf32(vp[ROW], vh[i][1], vl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], pl, vh[i][0], vh[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], ph, vl[i][0], vl[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], ph, vh[i][0], vh[i][1]);
      }
    }
    __syncthreads();  // the tile is free before the next iteration's copies land in it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = ra + 8 * i;
    if (r >= nrows) continue;
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    float* op = out + row_off(r) + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(op + 8 * j) = make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int* npv, int np,
                   int B, int S, int H, int Tn, int KV, long long bstride, long long tstride,
                   cudaStream_t st) {
  static size_t granted[gq::MAX_DEVICES] = {};
  cudaError_t e = gq::grant_smem(flash_mqa_f32_kernel<D>, Tile<D>::SMEM, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((S * (H / KV) + BR - 1) / BR, KV, B);
  flash_mqa_f32_kernel<D><<<grid, THREADS, Tile<D>::SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), npv, np, S, H, Tn, KV, bstride, tstride);
  return cudaGetLastError();
}

}  // namespace

// f32 q (B, S, H, D) and out contiguous, D in {32, 64, 128}; k/v (B, T, KV, D)
// f32, 16-byte aligned, with the given batch and time strides (in elements,
// multiples of 16 bytes) and contiguous heads. n_past_vec (B,) int32 on the
// device, or null to use n_past for every row.
extern "C" int gq_flash_mqa_f32(const void* q, const void* k, const void* v, void* out,
                                const void* n_past_vec, int n_past, int B, int S, int H, int Tn,
                                int KV, int D, long long kv_bstride, long long kv_tstride,
                                void* stream) {
  if (B < 1 || S < 1 || KV < 1 || Tn < 1 || H % KV != 0 || KV > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* npv = static_cast<const int*>(n_past_vec);
  switch (D) {
    case 32: return launch<32>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride, kv_tstride, st);
    case 64: return launch<64>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride, kv_tstride, st);
    case 128:
      return launch<128>(q, k, v, out, npv, n_past, B, S, H, Tn, KV, kv_bstride, kv_tstride, st);
    default: return cudaErrorInvalidValue;
  }
}
