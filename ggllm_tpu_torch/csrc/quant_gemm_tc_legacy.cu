// The tensor-core quant-matmul tile (quant_gemm_tc.cuh) built for the legacy
// formats Q4_0, Q4_1, Q5_0, Q5_1 and Q8_0, and its C entry point; the K-quant
// formats are built in quant_gemm_tc_kq.cu, so the two compile side by side.

#include "quant_gemm_tc.cuh"

// defined in quant_gemm_tc_kq.cu
int gq_quant_matmul_tc_kq(int gtype, const void* x, const void* qs, const void* qh, const void* d,
                          const void* m, const void* sc, const void* scm, void* y, int y_f32,
                          int S, int K, int O, int nt, cudaStream_t st);

// y (S, O) bf16 or f32 = x (S, K) bf16 @ W^T on the tensor cores, S > 1; x and
// the planes 16-byte aligned (null for planes the format lacks; qs holds
// Q6_K's ql, qh Q3_K's hmask, m holds dmin, sc Q2_K's scb). nt: the x rows per
// block, 16, 64, 128 or 256 (kernels/quant_matmul.py tc_rows chooses it).
extern "C" int gq_quant_matmul_tc(int gtype, const void* x, const void* qs, const void* qh,
                                  const void* d, const void* m, const void* sc, const void* scm,
                                  void* y, int y_f32, int S, int K, int O, int nt, void* stream) {
  const bool kq = gtype >= Q2_K && gtype <= Q6_K;
  if (S < 1 || O < 1 || K < 32 || K % (kq ? 256 : 32) != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kq) return gq_quant_matmul_tc_kq(gtype, x, qs, qh, d, m, sc, scm, y, y_f32, S, K, O, nt, st);
  const Planes p{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                 static_cast<const __half*>(d), static_cast<const __half*>(m),
                 static_cast<const int8_t*>(sc), static_cast<const int8_t*>(scm), K / 32};
  switch (gtype) {
    case Q4_0: return launch_fmt<Q4_0>(nt, x, p, y, y_f32, S, K, O, st);
    case Q4_1: return launch_fmt<Q4_1>(nt, x, p, y, y_f32, S, K, O, st);
    case Q5_0: return launch_fmt<Q5_0>(nt, x, p, y, y_f32, S, K, O, st);
    case Q5_1: return launch_fmt<Q5_1>(nt, x, p, y, y_f32, S, K, O, st);
    case Q8_0: return launch_fmt<Q8_0>(nt, x, p, y, y_f32, S, K, O, st);
    default: return cudaErrorInvalidValue;
  }
}
