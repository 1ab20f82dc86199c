// The rows kernel of 2-16 bf16 rows (quant_mmv.cuh) built for the legacy
// formats Q4_0, Q4_1, Q5_0, Q5_1 and Q8_0, and its C entry point; the K-quant
// formats are built in quant_mmv_kq.cu, so the two compile side by side.

#include "quant_mmv.cuh"

// defined in quant_mmv_kq.cu
int gq_quant_matmul_rows_kq(int gtype, const void* x, const void* qs, const void* qh,
                            const void* d, const void* m, const void* sc, const void* scm,
                            void* y, int y_f32, int S, int K, int O, int cl,
                            cudaStream_t st);

// y (S, O) bf16 or f32 = x (S, K) bf16 @ W^T on the tensor cores, 2 <= S <= 16;
// x and the planes 16-byte aligned (null for planes the format lacks; qs
// holds Q6_K's ql, qh Q3_K's hmask, m holds dmin, sc Q2_K's scb). cl: the
// blocks of a cluster that split K, 1 or 2 (kernels/quant_matmul.py
// rows_cluster chooses it).
extern "C" int gq_quant_matmul_rows(int gtype, const void* x, const void* qs, const void* qh,
                                    const void* d, const void* m, const void* sc,
                                    const void* scm, void* y, int y_f32, int S, int K, int O,
                                    int cl, void* stream) {
  const bool kq = gtype >= Q2_K && gtype <= Q6_K;
  if (S < 2 || S > 16 || O < 1 || K < 32 || K % (kq ? 256 : 32) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kq)
    return gq_quant_matmul_rows_kq(gtype, x, qs, qh, d, m, sc, scm, y, y_f32, S, K, O, cl, st);
  const Planes p{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                 static_cast<const __half*>(d), static_cast<const __half*>(m),
                 static_cast<const int8_t*>(sc), static_cast<const int8_t*>(scm), K / 32};
  switch (gtype) {
    case Q4_0: return launch_rows<Q4_0>(cl, x, p, y, y_f32, S, K, O, st);
    case Q4_1: return launch_rows<Q4_1>(cl, x, p, y, y_f32, S, K, O, st);
    case Q5_0: return launch_rows<Q5_0>(cl, x, p, y, y_f32, S, K, O, st);
    case Q5_1: return launch_rows<Q5_1>(cl, x, p, y, y_f32, S, K, O, st);
    case Q8_0: return launch_rows<Q8_0>(cl, x, p, y, y_f32, S, K, O, st);
    default: return cudaErrorInvalidValue;
  }
}
