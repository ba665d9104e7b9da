// Kernel 3: k complete projective doublings for a = 0 (Renes-Costello-Batina
// 2015/1060, Alg. 9: 8 products and 1 product by 3b each), k given at run
// time.
//
// Replaces three Pallas kernels of montgomery_tpu/curves/projective.py:
// "proj_dbl_rcb" (double_rcb / _dbl_rcb_formula, :196-223, k = 1),
// "proj_dbln_rcb" (k in a plane) and "proj_dbl{k}_rcb" (static k) of
// double_n (:225-276). One binary serves every k.
//
// Two bodies, chosen by the wrapper from the lane count:
// - wide (one thread a lane): bound by integer multiply throughput, 9
//   products a doubling on madc.cuh's carry chains (projective.cuh's
//   rcb_dbl); the point stays in registers across all k doublings, so a
//   launch reads and writes one point per lane whatever k is. On an H100
//   the carry-chain product took the k = 92 launch of the cofactor stage
//   at 2^20 lanes from 67.9 to 38.5 ms at 12 limbs (0.75 of the multiply
//   bound of 7 products and 2 squares a doubling) and from 111.4 to 50.3
//   ms at 13 (chip_smoke.py, in turns with the CIOS body it
//   replaced). Four threads a lane, one product
//   each of the formula's stages 4 | 1 | 4, read 0.56-0.60 of that bound:
//   stage 2's one product costs a warp the issue slots of four.
// - few (one block of 4 warps a lane, below the wrapper's lane threshold):
//   bound by latency, since a few lanes cannot fill the card and each
//   doubling waits on the one before. projective.cuh's coop_dbl runs each
//   stage's products on separate warps and each product on a whole warp
//   (coop.cuh), so a doubling is 3 dependent warp products; the point stays
//   in shared memory across all k doublings.
// Both give the same values bit for bit (fe_mul_cc and coop_mul equal
// fe_mul).
#include "projective.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
proj_dbl_rcb_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                    const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                    const int32_t* __restrict__ Z1, int k, Fe<NL> b3, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x[NL], y[NL], z[NL];
  fe_load(x, X1, N, i);
  fe_load(y, Y1, N, i);
  fe_load(z, Z1, N, i);
  for (int r = 0; r < k; r++) rcb_dbl(x, y, z, b3, F);
  fe_store(X3, N, i, x);
  fe_store(Y3, N, i, y);
  fe_store(Z3, N, i, z);
}

template <int NL>
__global__ void __launch_bounds__(32 * COOP_DBL_WARPS)
proj_dbl_rcb_few_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                        const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                        const int32_t* __restrict__ Z1, int k, Fe<NL> b3, Fe<NL> mu, FieldParams<NL> F,
                        int N) {
  __shared__ CoopPoint<NL> S;
  int i = blockIdx.x;
  coop_init(S, F, mu, b3);
  coop_load_point<NL>(S.X, S.Y, S.Z, X1, Y1, Z1, N, i, threadIdx.x, blockDim.x);
  __syncthreads();
  for (int r = 0; r < k; r++) coop_dbl(S, F);
  coop_store_point(X3, Y3, Z3, N, i, S);
}

template <int NL>
static int launch(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1, int k,
                  const uint32_t* b3, const uint32_t* mu, const uint32_t* field, int N, int few,
                  void* stream) {
  if (N > 0 && few)
    proj_dbl_rcb_few_kernel<NL><<<N, 32 * COOP_DBL_WARPS, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (const int32_t*)X1, (const int32_t*)Y1, (const int32_t*)Z1, k,
        fe_from<NL>(b3), fe_from<NL>(mu), field_from<NL>(field), N);
  else if (N > 0)
    proj_dbl_rcb_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (const int32_t*)X1, (const int32_t*)Y1, (const int32_t*)Z1, k,
        fe_from<NL>(b3), field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_proj_dbl_rcb(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1,
                                int k, const uint32_t* b3, const uint32_t* mu, const uint32_t* field, int N,
                                int few, void* stream) {
  return launch<12>(X3, Y3, Z3, X1, Y1, Z1, k, b3, mu, field, N, few, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_proj_dbl_rcb_n13(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1,
                                    const void* Z1, int k, const uint32_t* b3, const uint32_t* mu,
                                    const uint32_t* field, int N, int few, void* stream) {
  return launch<13>(X3, Y3, Z3, X1, Y1, Z1, k, b3, mu, field, N, few, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_proj_dbl_rcb_n9(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1,
                                   const void* Z1, int k, const uint32_t* b3, const uint32_t* mu,
                                   const uint32_t* field, int N, int few, void* stream) {
  return launch<9>(X3, Y3, Z3, X1, Y1, Z1, k, b3, mu, field, N, few, stream);
}
#endif
