// Kernel 3: k complete projective doublings for a = 0 (Renes-Costello-Batina
// 2015/1060, Alg. 9: 8 products and 1 product by 3b each), k given at run
// time.
//
// Replaces three Pallas kernels of montgomery_tpu/curves/projective.py:
// "proj_dbl_rcb" (double_rcb / _dbl_rcb_formula, :196-223, k = 1),
// "proj_dbln_rcb" (k in a plane) and "proj_dbl{k}_rcb" (static k) of
// double_n (:225-276). One binary serves every k of the window combine.
//
// Bound on this card: 9 CIOS products per doubling, so integer multiply
// throughput; the point stays in registers across all k doublings, so a
// launch reads and writes one point per lane whatever k is. Design: one
// thread per lane, a run-time loop over the doubling body.
#include "field.cuh"

template <int NL>
__device__ __forceinline__ void rcb_dbl(uint32_t (&X)[NL], uint32_t (&Y)[NL], uint32_t (&Z)[NL],
                                        const Fe<NL>& b3, const FieldParams<NL>& F) {
  uint32_t YY[NL], ZZ[NL], YZ[NL], XY[NL], Z3d[NL], t2[NL], u[NL], v[NL];
  fe_mul(YY, Y, Y, F);
  fe_mul(ZZ, Z, Z, F);
  fe_mul(YZ, Y, Z, F);
  fe_mul(XY, X, Y, F);
  fe_add(Z3d, YY, YY, F);
  fe_add(Z3d, Z3d, Z3d, F);   // 4 Y^2, reduced
  fe_add_lazy(Z3d, Z3d, Z3d);  // 8 Y^2 < 4p
  fe_mul(t2, ZZ, b3.v, F);     // 3b Z^2
  fe_add_lazy(u, YY, t2);      // Y3t < 4p
  fe_add(v, t2, t2, F);
  fe_add(v, v, t2, F);         // 9b Z^2 reduced
  fe_sub_lazy(YY, YY, v, F);   // t0m = Y^2 - 9b Z^2 + 4p < 6p
  fe_mul(X, t2, Z3d, F);       // X3a
  fe_mul(Z, YZ, Z3d, F);       // Z3
  fe_mul(v, YY, u, F);         // Y3a
  fe_add(Y, X, v, F);          // Y3 = X3a + Y3a
  fe_mul(v, YY, XY, F);        // X3b
  fe_add(X, v, v, F);          // X3 = 2 X3b
}

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

extern "C" int msm_proj_dbl_rcb(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1,
                                int k, const uint32_t* b3, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    proj_dbl_rcb_kernel<12><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (const int32_t*)X1, (const int32_t*)Y1, (const int32_t*)Z1, k,
        fe_from<12>(b3), field_from<12>(field), N);
  return (int)cudaGetLastError();
}
