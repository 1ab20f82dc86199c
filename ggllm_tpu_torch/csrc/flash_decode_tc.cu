// One-token decode attention for grouped query heads on the tensor cores:
// bf16 q on a bf16 cache or on the int8 cache (codes with one f32 scale per
// cached (position, head)), head_dim 64 or 128.
//
// Replaces the Pallas kernel ggllm_tpu/kernels/flash_decode.py `_kern`
// (launched by cache_partials, wrapped by flash_decode), dense and with
// quant=True, for bf16 queries; flash_decode.cu keeps f32 queries and
// head_dim 32 (partials_kernel) and G == 1 (decode_mha_kernel).
//
// What bounds it on an H100: the valid K/V prefix of one K/V head (Falcon-7B,
// KV = 1, D = 64: 256 bytes a position in bf16, 136 as codes and two scales)
// read by few blocks, plus the launch. The work is two small matrix products
// per K/V head, S = Q K^T ((G x D) (D x T)) and O = P V ((G x T) (T x D)), so
// the design is flash_attention_tc.cu's at one query position:
//  * The rows of a block are the G query heads of one K/V head padded to a
//    multiple of 16 (Falcon-7B: 71 -> 80, Falcon-40B: 16): one m16 tile per
//    warp. Both products run as mma.sync.m16n8k16 (bf16 in, f32 out) fed by
//    ldmatrix (.trans for V) from the shared helpers of mma.cuh; P is rounded
//    to bf16 in registers. With one or two row tiles (G <= 32) the block has
//    four or two warps per row tile, each taking its share of every key tile,
//    and they merge their (acc, m, l) through shared memory.
//  * K/V tiles of 64 keys are staged by 16-byte cp.async, four tiles in
//    flight (a block holds few keys, so its time is the latency of its loads:
//    a split of up to 256 keys is requested at once), in the XOR swizzle
//    (chunk c of row r at c ^ (r & 7)) that ldmatrix reads without bank
//    conflicts. The int8 cache stages its codes (and, by 4-byte cp.async,
//    the scales) four tiles deep and converts each to bf16 in shared
//    memory, which is exact for |code| <= 127; K's scale multiplies the score
//    column and V's scales P's column before P is rounded, so the scales stay
//    out of both products.
//  * The time axis is cut into decode_plan's splits (kernels/flash_decode.py:
//    enough blocks to fill the SMs, at least 32 keys a split, no more splits
//    than the merge reads back cheaply) and finished inside the launch as in
//    flash_decode.cu: partials to a reused workspace, a ticket per (row, K/V
//    head), the last block merges the splits and the [current; pending]
//    append block and writes the output. One launch a call; a device vector
//    of lengths is read on the device.

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
using gq::ldsm4;
using gq::ldsm4_trans;
using gq::mma16816;
using gq::NEG_INF;
using gq::pack_bf16;

constexpr int BT = 64;            // keys per staged tile
constexpr int STAGES = 4;         // tiles in flight: a split of <= 256 keys is read at once
constexpr int MAX_THREADS = 256;  // 8 row tiles of 16 (G <= 128)

// Byte offsets of a block's shared memory from its 128-byte aligned base:
// Q (GP rows), the bf16 K and V tiles (STAGES each; one each for int8, which
// converts into them), and for int8 the raw codes and scales, STAGES each.
struct TcLayout {
  uint32_t q, k, v, rk, rv, sk, sv, end;
};
__host__ __device__ inline TcLayout tc_layout(int D, bool quant, int GP) {
  const uint32_t tile = BT * D * 2, nbuf = quant ? 1 : STAGES;
  const uint32_t raw = quant ? STAGES * BT * D : 0, sc = quant ? STAGES * BT * 4 : 0;
  TcLayout o;
  o.q = 0;
  o.k = GP * D * 2;
  o.v = o.k + nbuf * tile;
  o.rk = o.v + nbuf * tile;
  o.rv = o.rk + raw;
  o.sk = o.rv + raw;
  o.sv = o.sk + sc;
  o.end = o.sv + sc;
  return o;
}

// warps per row tile: all the block's keys split between them
__host__ __device__ constexpr int warps_per_tile(int MT) { return MT == 1 ? 4 : MT == 2 ? 2 : 1; }

// 8 int8 codes -> 8 bf16 (exact)
__device__ __forceinline__ uint4 codes_to_bf16(uint2 c) {
  const unsigned w[2] = {c.x, c.y};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned x = w[i / 2];
    const int s = 16 * (i % 2);
    r[i] = pack_bf16((float)((int)(x << (24 - s)) >> 24), (float)((int)(x << (16 - s)) >> 24));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Grid (n_split, KV, B), 32 * MT * KW threads (MT = ceil(G / 16) row tiles,
// KW warps each). Block (s, kvh, b) takes cache positions [s * chunk,
// (s + 1) * chunk) below row b's valid length; partial slot (b, kvh, s) of
// R = 16 * MT rows.
template <int D, int KW, bool QUANT>
__global__ void __launch_bounds__(MAX_THREADS)
decode_tc_kernel(const void* __restrict__ cache, const float* __restrict__ scales, int layer,
                 const bf16* __restrict__ q, Finish<bf16> f, int B, int Tn, int KV, int G) {
  constexpr int CH = D / 8;     // 16-byte chunks per bf16 row
  constexpr int ROWB = D * 2;   // bytes per bf16 row
  constexpr int TILE = BT * ROWB;
  constexpr int KPW = BT / KW;  // keys per warp and tile
  constexpr int NB = KPW / 8;   // n8 score tiles per warp
  constexpr int XW = D / 2 + 4; // floats a lane leaves for the cross-warp merge: o, m[2], l[2]
  extern __shared__ uint8_t smem_raw[];
  __shared__ int flag;
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (s0 + 127u) & ~127u;
  uint8_t* gbase = smem_raw + (base - s0);  // generic pointer to the same bytes
  const int MT = (G + 15) / 16, GP = 16 * MT;
  const TcLayout lay = tc_layout(D, QUANT, GP);
  const uint32_t qs = base + lay.q, ks = base + lay.k, vs = base + lay.v;
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

    for (int i = tid; i < GP * CH; i += nt) {  // Q rows; the padding rows are zeros
      const int r = i / CH, c = i % CH;
      cp_async16(qs + r * ROWB + ((c ^ (r & 7)) << 4), q + (bk * G + min(r, G - 1)) * D + c * 8,
                 r < G ? 16 : 0);
    }
    auto load_tile = [&](int tile, int buf) {
      const int tb = k0 + tile * BT;
      if constexpr (QUANT) {
        constexpr int CQ = D / 16;  // 16-byte chunks per row of codes
        const int8_t* codes = static_cast<const int8_t*>(cache);
        for (int i = tid; i < BT * CQ; i += nt) {
          const int key = i / CQ, c = i % CQ, t = tb + key;
          const bool ok = t < k1;  // keys past the split's last are zeros
          const size_t off = (size_t)(ok ? t : k0) * row + c * 16;
          const uint32_t dst = buf * (BT * D) + key * D + c * 16;
          cp_async16(base + lay.rk + dst, codes + kbase + off, ok ? 16 : 0);
          cp_async16(base + lay.rv + dst, codes + vbase + off, ok ? 16 : 0);
        }
        for (int key = tid; key < BT; key += nt) {
          const int t = tb + key;
          const bool ok = t < k1;
          const size_t off = sbase + (size_t)(ok ? t : k0) * KV;
          cp_async4(base + lay.sk + (buf * BT + key) * 4, scales + off, ok ? 4 : 0);
          cp_async4(base + lay.sv + (buf * BT + key) * 4, scales + off + svoff, ok ? 4 : 0);
        }
      } else {
        const bf16* kv = static_cast<const bf16*>(cache);
        for (int i = tid; i < BT * CH; i += nt) {
          const int key = i / CH, c = i % CH, t = tb + key;
          const bool ok = t < k1;
          const size_t off = (size_t)(ok ? t : k0) * row + c * 8;
          const uint32_t dst = buf * TILE + key * ROWB + ((c ^ (key & 7)) << 4);
          cp_async16(ks + dst, kv + kbase + off, ok ? 16 : 0);
          cp_async16(vs + dst, kv + vbase + off, ok ? 16 : 0);
        }
      }
    };
    for (int t = 0; t < STAGES - 1; ++t) {  // one commit group per tile, empty past the last
      if (t < ntiles) load_tile(t, t);
      cp_async_commit();
    }

    uint32_t qf[D / 16][4];
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int tile = 0; tile < ntiles; ++tile) {
      const int buf = tile % STAGES;
      // into the buffer the previous tile freed at the end of its iteration
      if (tile + STAGES - 1 < ntiles) load_tile(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // this tile's group has landed
      __syncthreads();
      if constexpr (QUANT) {  // this tile's codes -> the bf16 tiles
        for (int i = tid; i < BT * CH; i += nt) {
          const int key = i / CH, c = i % CH;
          const uint32_t src = buf * (BT * D) + key * D + c * 8;
          const uint32_t dst = key * ROWB + ((c ^ (key & 7)) << 4);
          *reinterpret_cast<uint4*>(gbase + lay.k + dst) =
              codes_to_bf16(*reinterpret_cast<const uint2*>(gbase + lay.rk + src));
          *reinterpret_cast<uint4*>(gbase + lay.v + dst) =
              codes_to_bf16(*reinterpret_cast<const uint2*>(gbase + lay.rv + src));
        }
        __syncthreads();
      }
      if (tile == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int r = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int c = kk * 2 + (lane >> 4);
          ldsm4(qs + r * ROWB + ((c ^ (r & 7)) << 4), qf[kk]);
        }
      }
      const uint32_t kt = ks + (QUANT ? 0 : buf * TILE), vt = vs + (QUANT ? 0 : buf * TILE);
      const float* ksc = reinterpret_cast<const float*>(gbase + lay.sk) + buf * BT + kw * KPW;
      const float* vsc = reinterpret_cast<const float*>(gbase + lay.sv) + buf * BT + kw * KPW;
      const int tw = k0 + tile * BT + kw * KPW;  // the warp's first key of the tile

      float s[NB][4];
#pragma unroll
      for (int n8 = 0; n8 < NB; ++n8) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n8][c] = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < D / 32; ++k2) {
          uint32_t bf[4];
          const int r = kw * KPW + n8 * 8 + (lane & 7);
          const int c = k2 * 4 + (lane >> 3);
          ldsm4(kt + r * ROWB + ((c ^ (r & 7)) << 4), bf);
          mma16816(s[n8], qf[2 * k2], bf[0], bf[1]);
          mma16816(s[n8], qf[2 * k2 + 1], bf[2], bf[3]);
        }
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
#pragma unroll
      for (int kk = 0; kk < KPW / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n16 = 0; n16 < D / 16; ++n16) {
          uint32_t bf[4];
          const int r = kw * KPW + kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int c = n16 * 2 + (lane >> 4);
          ldsm4_trans(vt + r * ROWB + ((c ^ (r & 7)) << 4), bf);
          mma16816(o[2 * n16], a, bf[0], bf[1]);
          mma16816(o[2 * n16 + 1], a, bf[2], bf[3]);
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

// The dynamic shared memory a launch needs: the larger of the tiles, the
// cross-warp merge and the split merge's scratch, plus the alignment slack
size_t tc_smem(int D, bool quant, int G, int ws, int n_app) {
  const int MT = (G + 15) / 16, KW = warps_per_tile(MT);
  size_t need = tc_layout(D, quant, 16 * MT).end;
  if (KW > 1) need = std::max(need, (size_t)MT * KW * (D / 2 + 4) * 32 * 4);
  need = std::max(need, gq::merge_floats(G, ws, n_app) * 4);
  return need + 128;
}

template <int D, int KW, bool QUANT>
cudaError_t launch(const void* cache, const void* scales, int layer, const void* q,
                   const Finish<bf16>& f, int B, int Tn, int KV, int G, cudaStream_t st) {
  static size_t granted[gq::MAX_DEVICES] = {};
  const size_t smem = tc_smem(D, QUANT, G, f.ws, f.n_app);
  cudaError_t e = gq::grant_smem(decode_tc_kernel<D, KW, QUANT>, smem, granted);
  if (e != cudaSuccess) return e;
  const int MT = (G + 15) / 16;
  dim3 grid(f.n_split, KV, B);
  decode_tc_kernel<D, KW, QUANT><<<grid, 32 * MT * KW, smem, st>>>(
      cache, static_cast<const float*>(scales), layer, static_cast<const bf16*>(q), f, B, Tn, KV,
      G);
  return cudaGetLastError();
}

template <int D, bool QUANT>
cudaError_t dispatch_kw(const void* cache, const void* scales, int layer, const void* q,
                        const Finish<bf16>& f, int B, int Tn, int KV, int G, cudaStream_t st) {
  switch (warps_per_tile((G + 15) / 16)) {
    case 4: return launch<D, 4, QUANT>(cache, scales, layer, q, f, B, Tn, KV, G, st);
    case 2: return launch<D, 2, QUANT>(cache, scales, layer, q, f, B, Tn, KV, G, st);
    default: return launch<D, 1, QUANT>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  }
}

}  // namespace

// The whole decode attention of one layer in one launch, grouped query heads
// on the tensor cores. The arguments are gq_decode's (flash_decode.cu) with
// q bf16 (q_bf16 = 1), cache_kind 1 (bf16) or 2 (int8 codes with f32 scales),
// D 64 or 128 and G in 1..128; any split length `chunk` >= 1.
extern "C" int gq_decode_tc(const void* cache, int cache_kind, const void* scales, int layer,
                            const void* q, int q_bf16, const void* valid_vec, int valid,
                            const void* app, int n_app, int app_valid, void* out, void* acc,
                            void* m, void* l, void* part_acc, void* part_ml, void* counters, int L,
                            int B, int Tn, int KV, int G, int D, int n_split, int chunk, int ws,
                            void* stream) {
  if (layer < 0 || layer >= L || B < 1 || KV < 1 || G < 1 || G > 128 || n_split < 1 ||
      n_split > ws || chunk < 1 || (D != 64 && D != 128) || !q_bf16 ||
      (cache_kind != 1 && cache_kind != 2) || (cache_kind == 2) != (scales != nullptr) ||
      n_app < 0 || app_valid < 0 || app_valid > n_app || (n_app > 0) != (app != nullptr) ||
      (n_app > 0 && app_valid < 1) || (out == nullptr) == (acc == nullptr) ||
      (acc == nullptr) != (m == nullptr) || (m == nullptr) != (l == nullptr) || B > 65535 ||
      KV > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Finish<bf16> f = gq::make_finish<bf16>(valid_vec, valid, app, n_app, app_valid, out, acc,
                                               m, l, part_acc, part_ml, counters, n_split, chunk,
                                               ws);
  const bool quant = cache_kind == 2;
  if (D == 64)
    return quant ? dispatch_kw<64, true>(cache, scales, layer, q, f, B, Tn, KV, G, st)
                 : dispatch_kw<64, false>(cache, scales, layer, q, f, B, Tn, KV, G, st);
  return quant ? dispatch_kw<128, true>(cache, scales, layer, q, f, B, Tn, KV, G, st)
               : dispatch_kw<128, false>(cache, scales, layer, q, f, B, Tn, KV, G, st);
}
