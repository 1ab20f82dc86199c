// The tensor-core quant-matmul tile (quant_gemm_tc.cuh) built for the K-quant
// formats Q2_K, Q3_K, Q4_K, Q5_K and Q6_K; called by gq_quant_matmul_tc
// (quant_gemm_tc_legacy.cu), which has checked the sizes.

#include "quant_gemm_tc.cuh"

int gq_quant_matmul_tc_kq(int gtype, const void* x, const void* qs, const void* qh, const void* d,
                          const void* m, const void* sc, const void* scm, void* y, int y_f32,
                          int S, int K, int O, int nt, cudaStream_t st) {
  const Planes p{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                 static_cast<const __half*>(d), static_cast<const __half*>(m),
                 static_cast<const int8_t*>(sc), static_cast<const int8_t*>(scm), K / 32};
  switch (gtype) {
    case Q2_K: return launch_fmt<Q2_K>(nt, x, p, y, y_f32, S, K, O, st);
    case Q3_K: return launch_fmt<Q3_K>(nt, x, p, y, y_f32, S, K, O, st);
    case Q4_K: return launch_fmt<Q4_K>(nt, x, p, y, y_f32, S, K, O, st);
    case Q5_K: return launch_fmt<Q5_K>(nt, x, p, y, y_f32, S, K, O, st);
    case Q6_K: return launch_fmt<Q6_K>(nt, x, p, y, y_f32, S, K, O, st);
    default: return cudaErrorInvalidValue;
  }
}
