// Kernel 2: complete projective addition for a = 0 (Renes-Costello-Batina
// 2015/1060, Alg. 7): 12 products and 2 products by the constant 3b.
//
// Replaces the Pallas kernel "proj_add_rcb" of
// montgomery_tpu/curves/projective.py (ProjectiveOps._add_rcb and
// _add_rcb_formula, :153-194). Valid for every input pair of the odd-order
// subgroup, P == Q, P == -Q and the zero point (Z == 0) included.
//
// Bound on this card: 14 CIOS products per lane (about 4,000 32-bit
// multiplies), and register pressure: the six input points hold 6 x 12 words
// before the first product. Design: one thread per lane; the formula
// (rcb_add, projective.cuh, shared with the window combine) is ordered so
// that inputs die as early as possible (the three cross sums are formed
// before the inputs are dropped), and the lazy sums stay below 6p so no
// reduction runs between products, exactly as in the JAX formula.
#include "projective.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
proj_add_rcb_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                    const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                    const int32_t* __restrict__ Z1, const int32_t* __restrict__ X2,
                    const int32_t* __restrict__ Y2, const int32_t* __restrict__ Z2, Fe<NL> b3,
                    FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], z1[NL], x2[NL], y2[NL], z2[NL], x3[NL], y3[NL], z3[NL];
  fe_load(x1, X1, N, i);
  fe_load(y1, Y1, N, i);
  fe_load(z1, Z1, N, i);
  fe_load(x2, X2, N, i);
  fe_load(y2, Y2, N, i);
  fe_load(z2, Z2, N, i);
  rcb_add(x3, y3, z3, x1, y1, z1, x2, y2, z2, b3, F);
  fe_store(X3, N, i, x3);
  fe_store(Y3, N, i, y3);
  fe_store(Z3, N, i, z3);
}

extern "C" int msm_proj_add_rcb(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1,
                                const void* X2, const void* Y2, const void* Z2, const uint32_t* b3,
                                const uint32_t* field, int N, void* stream) {
  if (N > 0)
    proj_add_rcb_kernel<12><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (const int32_t*)X1, (const int32_t*)Y1, (const int32_t*)Z1,
        (const int32_t*)X2, (const int32_t*)Y2, (const int32_t*)Z2, fe_from<12>(b3), field_from<12>(field), N);
  return (int)cudaGetLastError();
}
