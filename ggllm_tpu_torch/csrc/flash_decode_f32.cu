// One-token decode attention for grouped query heads on the tensor cores,
// held at f32 accuracy: f32 q on an f32 or a bf16 cache or on the int8 cache
// (codes with one f32 scale per cached (position, head)) at head_dim 32, 64
// or 128, and bf16 q on a bf16 or an int8 cache at head_dim 32.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_decode.py `_kern`
// (launched by cache_partials, wrapped by flash_decode), dense and with
// quant=True, for f32 queries: the f32 route, and an f32 cache under bf16
// compute (`--memory-f32`), whose queries the wrapper casts to the cache's
// dtype. flash_decode_tc.cu keeps bf16 queries at head_dim 64 / 128 and
// flash_decode.cu G == 1.
//
// What bounds it on an H100: the valid K/V prefix of one K/V head read by
// few blocks (Falcon-7B, KV = 1, D = 64: 512 bytes a position in f32, 136 as
// codes and two scales), plus the launch and the merge. The work is two small
// matrix products per K/V head, S = Q K^T and O = P V, so the design is
// flash_decode_tc.cu's block structure with flash_attention_f32.cu's
// arithmetic:
//  * The rows of a block are the G query heads of one K/V head padded to a
//    multiple of 16 (Falcon-7B: 71 -> 80, Falcon-40B: 16): one m16 tile per
//    warp. With one or two row tiles (G <= 32) the block has four or two
//    warps per row tile, each taking its share of every key tile, and they
//    merge their (acc, m, l) through shared memory.
//  * Both products run as split TF32 on mma.sync.m16n8k8: an operand a is
//    cut into a_hi = tf32(a) and a_lo = tf32(a - a_hi) (cvt.rna), and a
//    product is lo x hi and hi x lo first, then hi x hi, into one f32
//    accumulator, with the f32 online softmax in between; the dropped
//    lo x lo and the remainders leave about 2^-21 of each product. An operand
//    exact in TF32 has no lo term, and its products are dropped (EXACT_Q,
//    EXACT_KV): int8 codes (|code| <= 127) and bf16 values. So an int8 cache
//    with f32 q costs two products each (q_lo k + q_hi k, p_lo v + p_hi v).
//    K's int8 scale multiplies the score column and V's scale P before P is
//    split, as the TPU kernel folds them, so the scales stay out of both
//    products.
//  * q, K and V are staged in their own types by 16-byte cp.async, in rows
//    16 bytes longer than the data (f32: D + 4 floats), so that the fragment
//    loads of a warp (8 rows x 4 dimensions for q and K, 4 key pairs x 8
//    dimensions for V) hit 32 different banks; fragments are converted to
//    f32 and split as they are loaded. K/V tiles of BT keys (64; 32 at
//    D = 128, whose f32 rows are twice as wide) are double-buffered. q stays
//    in shared memory, not in registers (there the prefill kernel spilled at
//    D = 128).
//  * The time axis is cut into decode_plan's splits (kernels/flash_decode.py:
//    enough blocks to fill the SMs, at least 32 keys a split, no more splits
//    than the merge reads back cheaply; an f32 key costs 2 D 4 bytes, an int8
//    one 2 D + 8) and finished inside the launch as in flash_decode.cu:
//    partials to a reused workspace, a ticket per (row, K/V head), the last
//    block merges the splits and the [current; pending] append block and
//    writes the output. One launch a call; a device vector of lengths is read
//    on the device.

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gq::cp_async16;
using gq::cp_async4;
using gq::cp_async_commit;
using gq::cp_async_wait;
using gq::Finish;
using gq::mma_tf32;
using gq::NEG_INF;
using gq::split_tf32;

constexpr int MAX_THREADS = 256;  // 8 row tiles of 16 (G <= 128)

// keys per staged tile
__host__ __device__ constexpr int tile_keys(int D) { return D > 64 ? 32 : 64; }
// warps per row tile: all the block's keys split between them
__host__ __device__ constexpr int warps_per_tile(int MT) { return MT == 1 ? 4 : MT == 2 ? 2 : 1; }
// bytes between two staged rows of D elements of `size` bytes
__host__ __device__ constexpr int row_bytes(int D, int size) { return D * size + 16; }

// Byte offsets of a block's shared memory from its 128-byte aligned base:
// q (GP rows), two K tiles, two V tiles, and for int8 two tiles of K scales
// and two of V scales.
struct F32Layout {
  uint32_t q, k, v, sk, sv, end;
};
__host__ __device__ inline F32Layout f32_layout(int D, int qsize, int ksize, bool quant, int GP) {
  const uint32_t tile = tile_keys(D) * row_bytes(D, ksize), sc = quant ? 2 * tile_keys(D) * 4 : 0;
  F32Layout o;
  o.q = 0;
  o.k = GP * row_bytes(D, qsize);
  o.v = o.k + 2 * tile;
  o.sk = o.v + 2 * tile;
  o.sv = o.sk + sc;
  o.end = o.sv + sc;
  return o;
}

// element i of a staged row, as f32
__device__ __forceinline__ float elem(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float elem(const bf16* p, int i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float elem(const int8_t* p, int i) { return (float)p[i]; }

// the TF32 terms of v; a value exact in TF32 is its own hi
template <bool EXACT>
__device__ __forceinline__ void terms(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(v);
    lo = 0;
  } else {
    split_tf32(v, hi, lo);
  }
}

// T: the cache's element (f32, bf16, or int8 codes with `scales`); TQ: q's.
// Grid (n_split, KV, B), 32 * MT * KW threads (MT = ceil(G / 16) row tiles,
// KW warps each). Block (s, kvh, b) takes cache positions [s * chunk,
// (s + 1) * chunk) below row b's valid length; partial slot (b, kvh, s) of
// R = 16 * MT rows.
template <typename T, typename TQ, int D, int KW>
__global__ void __launch_bounds__(MAX_THREADS)
decode_f32_kernel(const T* __restrict__ cache, const float* __restrict__ scales, int layer,
                  const TQ* __restrict__ q, Finish<TQ> f, int B, int Tn, int KV, int G) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr bool EXACT_Q = sizeof(TQ) == 2;   // bf16 q
  constexpr bool EXACT_KV = sizeof(T) < 4;    // bf16 values or int8 codes
  constexpr int BT = tile_keys(D);
  constexpr int KPW = BT / KW;  // keys per warp and tile
  constexpr int NB = KPW / 8;   // 8-key steps per warp and tile
  constexpr int QROW = row_bytes(D, sizeof(TQ)), KROW = row_bytes(D, sizeof(T));
  constexpr int CQ = D * sizeof(TQ) / 16, CK = D * sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int XW = D / 2 + 4;  // floats a lane leaves for the cross-warp merge: o, m[2], l[2]
  static_assert(NB >= 1 && D % 32 == 0, "tile and head_dim");
  extern __shared__ uint8_t smem_raw[];
  __shared__ int flag;
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (s0 + 127u) & ~127u;
  uint8_t* gbase = smem_raw + (base - s0);  // generic pointer to the same bytes
  const int MT = (G + 15) / 16, GP = 16 * MT;
  const F32Layout lay = f32_layout(D, sizeof(TQ), sizeof(T), QUANT, GP);
  const int nt = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int mt = warp / KW, kw = warp % KW;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const size_t bk = (size_t)b * KV + kvh;
  const int valid = gq::row_valid(f, b, Tn);
  const int k0 = split * f.chunk, k1 = min(valid, k0 + f.chunk);
  const float sl2 = 1.4426950408889634f / sqrtf((float)D);  // scale * log2(e)

  if (k1 > k0) {
    const size_t row = (size_t)KV * D;  // elements per cached position
    const size_t kbase = (((size_t)layer * 2) * B + b) * Tn * row + (size_t)kvh * D;
    const size_t vbase = kbase + (size_t)B * Tn * row;
    const size_t sbase = (((size_t)layer * 2) * B + b) * Tn * KV + kvh;
    const size_t svoff = (size_t)B * Tn * KV;
    const int ntiles = (k1 - k0 + BT - 1) / BT;

    for (int i = tid; i < GP * CQ; i += nt) {  // q rows; the padding rows are zeros
      const int r = i / CQ, c = i % CQ;
      cp_async16(base + lay.q + r * QROW + c * 16,
                 q + (bk * G + min(r, G - 1)) * D + c * (16 / sizeof(TQ)), r < G ? 16 : 0);
    }
    auto load_tile = [&](int tile, int buf) {
      const int tb = k0 + tile * BT;
      for (int i = tid; i < BT * CK; i += nt) {
        const int key = i / CK, c = i % CK, t = tb + key;
        const bool ok = t < k1;  // keys past the split's last are zeros
        const size_t off = (size_t)(ok ? t : k0) * row + c * (16 / sizeof(T));
        const uint32_t dst = (buf * BT + key) * KROW + c * 16;
        cp_async16(base + lay.k + dst, cache + kbase + off, ok ? 16 : 0);
        cp_async16(base + lay.v + dst, cache + vbase + off, ok ? 16 : 0);
      }
      if constexpr (QUANT) {
        for (int key = tid; key < BT; key += nt) {
          const int t = tb + key;
          const bool ok = t < k1;
          const size_t off = sbase + (size_t)(ok ? t : k0) * KV;
          cp_async4(base + lay.sk + (buf * BT + key) * 4, scales + off, ok ? 4 : 0);
          cp_async4(base + lay.sv + (buf * BT + key) * 4, scales + off + svoff, ok ? 4 : 0);
        }
      }
    };
    load_tile(0, 0);
    cp_async_commit();  // q and the first tile

    // the thread's q rows: g4 and g4 + 8 of the warp's row tile
    const TQ* qa = reinterpret_cast<const TQ*>(gbase + lay.q + (mt * 16 + g4) * QROW);
    const TQ* qb = reinterpret_cast<const TQ*>(gbase + lay.q + (mt * 16 + g4 + 8) * QROW);
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int tile = 0; tile < ntiles; ++tile) {
      const int buf = tile & 1;
      // into the buffer the previous tile freed at the end of its iteration
      if (tile + 1 < ntiles) load_tile(tile + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group (and q) has landed
      __syncthreads();
      const uint8_t* kt = gbase + lay.k + (buf * BT + kw * KPW) * KROW;  // the warp's keys
      const uint8_t* vt = gbase + lay.v + (buf * BT + kw * KPW) * KROW;
      const float* ksc = reinterpret_cast<const float*>(gbase + lay.sk) + buf * BT + kw * KPW;
      const float* vsc = reinterpret_cast<const float*>(gbase + lay.sv) + buf * BT + kw * KPW;
      const int tw = k0 + tile * BT + kw * KPW;  // the warp's first key of the tile

      // S = Q K^T: q's A fragment (rows g4, g4 + 8; dimensions 8 kk + t4 and
      // + 4), key n8 * 8 + g4's B fragment (the same dimensions)
      float s[NB][4];
#pragma unroll
      for (int n8 = 0; n8 < NB; ++n8)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n8][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int d = 8 * kk + t4;
        uint32_t qh[4], ql[4];
        terms<EXACT_Q>(elem(qa, d), qh[0], ql[0]);
        terms<EXACT_Q>(elem(qb, d), qh[1], ql[1]);
        terms<EXACT_Q>(elem(qa, d + 4), qh[2], ql[2]);
        terms<EXACT_Q>(elem(qb, d + 4), qh[3], ql[3]);
        uint32_t kh[NB][2], kl[NB][2];
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) {
          const T* kp = reinterpret_cast<const T*>(kt + (n8 * 8 + g4) * KROW);
          terms<EXACT_KV>(elem(kp, d), kh[n8][0], kl[n8][0]);
          terms<EXACT_KV>(elem(kp, d + 4), kh[n8][1], kl[n8][1]);
        }
        if constexpr (!EXACT_Q) {
#pragma unroll
          for (int n8 = 0; n8 < NB; ++n8) mma_tf32(s[n8], ql, kh[n8][0], kh[n8][1]);
        }
        if constexpr (!EXACT_KV) {
#pragma unroll
          for (int n8 = 0; n8 < NB; ++n8) mma_tf32(s[n8], qh, kl[n8][0], kl[n8][1]);
        }
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) mma_tf32(s[n8], qh, kh[n8][0], kh[n8][1]);
      }
#pragma unroll
      for (int n8 = 0; n8 < NB; ++n8)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kl = n8 * 8 + 2 * t4 + (c & 1);
          const float v = QUANT ? s[n8][c] * ksc[kl] : s[n8][c];
          s[n8][c] = tw + kl < k1 ? v : NEG_INF;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) mx = fmaxf(mx, fmaxf(s[n8][2 * i], s[n8][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f((m[i] - mx) * sl2);
        m[i] = mx;
        const float ms = mx * sl2;
        float sum = 0.f;
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = n8 * 8 + 2 * t4 + e;
            // a key past the split is 0 even while every key seen is (m -1e30)
            const float p = tw + kl < k1 ? exp2f(fmaf(s[n8][2 * i + e], sl2, -ms)) : 0.f;
            sum += p;
            s[n8][2 * i + e] = QUANT ? p * vsc[kl] : p;  // V's scale on P's column
          }
        l[i] = l[i] * alpha + sum;  // this lane's columns; the quad is summed at the end
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[j][2 * i] *= alpha;
          o[j][2 * i + 1] *= alpha;
        }
      }

      // O += P V over the warp's 8-key steps j: lane t4 holds keys 2 t4 and
      // 2 t4 + 1 of a step in its score accumulators, which the A fragment
      // of m16n8k8 takes at k = t4 and t4 + 4; V's B fragment reads the same
      // keys at dimension g4 of each 8-wide tile
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const T* va = reinterpret_cast<const T*>(vt + (j * 8 + 2 * t4) * KROW);
        const T* vb = reinterpret_cast<const T*>(vt + (j * 8 + 2 * t4 + 1) * KROW);
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += 4) {  // 4 dimension tiles side by side
          uint32_t vh[4][2], vl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            terms<EXACT_KV>(elem(va, (n0 + i) * 8 + g4), vh[i][0], vl[i][0]);
            terms<EXACT_KV>(elem(vb, (n0 + i) * 8 + g4), vh[i][1], vl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], pl, vh[i][0], vh[i][1]);
          if constexpr (!EXACT_KV) {
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], ph, vl[i][0], vl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], ph, vh[i][0], vh[i][1]);
        }
      }
      __syncthreads();  // the tiles are free before the next copies land in them
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    if constexpr (KW > 1) {  // the row tile's warps merge into its first (kw == 0)
      float* mine = reinterpret_cast<float*>(gbase) + (size_t)warp * XW * 32 + lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) mine[(j * 4 + c) * 32] = o[j][c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mine[(D / 2 + i) * 32] = m[i];
        mine[(D / 2 + 2 + i) * 32] = l[i];
      }
      __syncthreads();
      if (kw == 0)
#pragma unroll
        for (int w = 1; w < KW; ++w) {
          const float* th = mine + (size_t)w * XW * 32;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float mo = th[(D / 2 + i) * 32], M = fmaxf(m[i], mo);
            const float wa = exp2f((m[i] - M) * sl2), wb = exp2f((mo - M) * sl2);
            l[i] = l[i] * wa + th[(D / 2 + 2 + i) * 32] * wb;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                o[j][2 * i + e] = o[j][2 * i + e] * wa + th[(j * 4 + 2 * i + e) * 32] * wb;
            m[i] = M;
          }
        }
    }
    if (kw == 0) {  // the split's partial: m in the scaled units of the merge
      const size_t slot = bk * f.ws + split;
      float* pa = f.part_acc + slot * GP * D;
      float* pm = f.part_ml + slot * GP * 2;
      const float scale = 1.0f / sqrtf((float)D);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + g4 + 8 * i;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(pa + (size_t)r * D + 8 * j + 2 * t4) =
              make_float2(o[j][2 * i], o[j][2 * i + 1]);
        if (t4 == 0) {
          pm[2 * r] = m[i] * scale;
          pm[2 * r + 1] = l[i];
        }
      }
    }
  }
  gq::finish(f, q, b, kvh, B, KV, G, D, GP, valid, &flag, reinterpret_cast<float*>(gbase));
}

template <typename T, typename TQ, int D, int KW>
cudaError_t launch(const void* cache, const void* scales, int layer, const void* q,
                   const Finish<TQ>& f, int B, int Tn, int KV, int G, cudaStream_t st) {
  static size_t granted[gq::MAX_DEVICES] = {};
  const int MT = (G + 15) / 16;
  // the larger of the tiles, the cross-warp merge and the split merge's
  // scratch, plus the alignment slack
  size_t smem = f32_layout(D, sizeof(TQ), sizeof(T), sizeof(T) == 1, 16 * MT).end;
  if (KW > 1) smem = std::max(smem, (size_t)MT * KW * (D / 2 + 4) * 32 * 4);
  smem = std::max(smem, gq::merge_floats(G, f.ws, f.n_app) * 4) + 128;
  cudaError_t e = gq::grant_smem(decode_f32_kernel<T, TQ, D, KW>, smem, granted);
  if (e != cudaSuccess) return e;
  dim3 grid(f.n_split, KV, B);
  decode_f32_kernel<T, TQ, D, KW><<<grid, 32 * MT * KW, smem, st>>>(
      static_cast<const T*>(cache), static_cast<const float*>(scales), layer,
      static_cast<const TQ*>(q), f, B, Tn, KV, G);
  return cudaGetLastError();
}

template <typename T, typename TQ, int D>
cudaError_t dispatch_kw(const void* cache, const void* scales, int layer, const void* q,
                        const Finish<TQ>& f, int B, int Tn, int KV, int G, cudaStream_t st) {
  switch (warps_per_tile((G + 15) / 16)) {
    case 4: return launch<T, TQ, D, 4>(cache, scales, layer, q, f, B, Tn, KV, G, st);
    case 2: return launch<T, TQ, D, 2>(cache, scales, layer, q, f, B, Tn, KV, G, st);
    default: return launch<T, TQ, D, 1>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  }
}

// f32 q at head_dim 32, 64 and 128; bf16 q at 32
template <typename T, typename TQ>
cudaError_t dispatch(int D, const void* cache, const void* scales, int layer, const void* q,
                     const Finish<TQ>& f, int B, int Tn, int KV, int G, cudaStream_t st) {
  if (D == 32) return dispatch_kw<T, TQ, 32>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  if constexpr (sizeof(TQ) == 4) {
    if (D == 64) return dispatch_kw<T, TQ, 64>(cache, scales, layer, q, f, B, Tn, KV, G, st);
    if (D == 128) return dispatch_kw<T, TQ, 128>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The whole decode attention of one layer in one launch, grouped query heads
// at f32 accuracy on the tensor cores. The arguments are gq_decode's
// (flash_decode.cu): cache_kind 0 (f32) with f32 q, 1 (bf16) with f32 q, or
// bf16 q at D = 32, or 2 (int8 codes with f32 scales) with f32 q, or bf16 q
// at D = 32;
// D 32, 64 or 128 and G in 1..128; any split length `chunk` >= 1; q 16-byte
// aligned.
extern "C" int gq_decode_f32(const void* cache, int cache_kind, const void* scales, int layer,
                             const void* q, int q_bf16, const void* valid_vec, int valid,
                             const void* app, int n_app, int app_valid, void* out, void* acc,
                             void* m, void* l, void* part_acc, void* part_ml, void* counters,
                             int L, int B, int Tn, int KV, int G, int D, int n_split, int chunk,
                             int ws, void* stream) {
  if (layer < 0 || layer >= L || B < 1 || KV < 1 || G < 1 || G > 128 || n_split < 1 ||
      n_split > ws || chunk < 1 || (D != 32 && D != 64 && D != 128) || (q_bf16 && D != 32) ||
      (cache_kind == 0 && q_bf16) || cache_kind < 0 ||
      cache_kind > 2 || (cache_kind == 2) != (scales != nullptr) ||
      reinterpret_cast<uintptr_t>(q) % 16 || n_app < 0 || app_valid < 0 || app_valid > n_app ||
      (n_app > 0) != (app != nullptr) || (n_app > 0 && app_valid < 1) ||
      (out == nullptr) == (acc == nullptr) || (acc == nullptr) != (m == nullptr) ||
      (m == nullptr) != (l == nullptr) || B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GQ_FIN(TQ)                                                                          \
  gq::make_finish<TQ>(valid_vec, valid, app, n_app, app_valid, out, acc, m, l, part_acc,    \
                      part_ml, counters, n_split, chunk, ws)
  if (cache_kind == 0)
    return dispatch<float, float>(D, cache, scales, layer, q, GQ_FIN(float), B, Tn, KV, G, st);
  if (cache_kind == 1 && q_bf16)
    return dispatch<bf16, bf16>(D, cache, scales, layer, q, GQ_FIN(bf16), B, Tn, KV, G, st);
  if (cache_kind == 1)  // bf16 K/V are exact in TF32: EXACT_KV drops their lo terms
    return dispatch<bf16, float>(D, cache, scales, layer, q, GQ_FIN(float), B, Tn, KV, G, st);
  if (q_bf16)
    return dispatch<int8_t, bf16>(D, cache, scales, layer, q, GQ_FIN(bf16), B, Tn, KV, G, st);
  return dispatch<int8_t, float>(D, cache, scales, layer, q, GQ_FIN(float), B, Tn, KV, G, st);
#undef GQ_FIN
}
