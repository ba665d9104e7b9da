// Kernel 28: the window combine S = sum_k 2^(c k) W_k of K window sums, in
// one launch.
//
// Replaces the log-depth combine of montgomery_tpu/msm/pippenger.py
// (combine_windows, :508-540), which ran one "proj_dbl{k}_rcb" /
// "proj_dbln_rcb" Pallas kernel (montgomery_tpu/curves/projective.py:258,
// :273) and one "proj_add_rcb" (:156) per level: log2(K) levels of
// c K / 2, c K / 4, ... doublings on a few lanes, chosen on the TPU because
// a dispatch there cost more than the work.
//
// Bound on this card: latency. The main path combines one point; its work is
// microseconds of multiplies on one SM, but every doubling waits on the one
// before. Design: Horner order, acc = W_{K-1}; for k = K-2 .. 0:
// acc = 2^c acc + W_k, which is (K - 1) c doublings and K - 1 adds (the
// halving levels cost 195 doublings at c = 13, K = 10 (padded to 16);
// Horner 117), with the point in shared memory from the first window to the
// store: nothing goes to device memory between steps. One block of 6 warps
// carries one combine (projective.cuh's coop_dbl and coop_add: each stage's
// products on separate warps, each product on a whole warp), so a doubling
// is 3 dependent warp products and an add 3. Each W_k comes into shared
// memory by warps 4 and 5, which idle through the doublings before its add.
// A W_k may be the identity (0 : 1 : 0): the formulas are complete.
// Both levels of cooperation are reached (across a stage's products, and
// within each product). On an H100 80GB HBM3 at 700 W (chip_smoke.py): 115
// registers, no spill; a doubling 3.1 us on one lane (the one-thread body
// 32.2 us); K = 10, c = 13 in 0.41 ms, 1.5x its chain of 378 dependent warp
// products (0.71 us each).
#include "projective.cuh"

template <int NL>
__global__ void __launch_bounds__(32 * COOP_ADD_WARPS)
proj_combine_rcb_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                        const int32_t* __restrict__ WX, const int32_t* __restrict__ WY,
                        const int32_t* __restrict__ WZ, int K, int c, Fe<NL> b3, Fe<NL> mu,
                        FieldParams<NL> F, int N) {
  __shared__ CoopPoint<NL> S;
  size_t i = blockIdx.x, st = (size_t)N * K;  // window k of lane i at i K + k
  coop_init(S, F, mu, b3);
  coop_load_point<NL>(S.X, S.Y, S.Z, WX, WY, WZ, st, i * K + K - 1, threadIdx.x, blockDim.x);
  __syncthreads();
  int loader = threadIdx.x - 32 * COOP_DBL_WARPS;  // warps 4 and 5
  for (int k = K - 2; k >= 0; k--) {
    coop_load_point<NL>(S.X2, S.Y2, S.Z2, WX, WY, WZ, st, i * K + k, loader,
                        32 * (COOP_ADD_WARPS - COOP_DBL_WARPS));
    for (int r = 0; r < c; r++) coop_dbl(S, F);
    coop_add(S, F);
  }
  coop_store_point(X3, Y3, Z3, N, i, S);
}

template <int NL>
static int launch(void* X3, void* Y3, void* Z3, const void* WX, const void* WY, const void* WZ, int K, int c,
                  const uint32_t* b3, const uint32_t* mu, const uint32_t* field, int N, void* stream) {
  if (N > 0 && K > 0 && c > 0)
    proj_combine_rcb_kernel<NL><<<N, 32 * COOP_ADD_WARPS, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (const int32_t*)WX, (const int32_t*)WY, (const int32_t*)WZ, K,
        c, fe_from<NL>(b3), fe_from<NL>(mu), field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_proj_combine_rcb(void* X3, void* Y3, void* Z3, const void* WX, const void* WY,
                                    const void* WZ, int K, int c, const uint32_t* b3, const uint32_t* mu,
                                    const uint32_t* field, int N, void* stream) {
  return launch<12>(X3, Y3, Z3, WX, WY, WZ, K, c, b3, mu, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_proj_combine_rcb_n13(void* X3, void* Y3, void* Z3, const void* WX, const void* WY,
                                        const void* WZ, int K, int c, const uint32_t* b3, const uint32_t* mu,
                                        const uint32_t* field, int N, void* stream) {
  return launch<13>(X3, Y3, Z3, WX, WY, WZ, K, c, b3, mu, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_proj_combine_rcb_n9(void* X3, void* Y3, void* Z3, const void* WX, const void* WY,
                                       const void* WZ, int K, int c, const uint32_t* b3, const uint32_t* mu,
                                       const uint32_t* field, int N, void* stream) {
  return launch<9>(X3, Y3, Z3, WX, WY, WZ, K, c, b3, mu, field, N, stream);
}
#endif
