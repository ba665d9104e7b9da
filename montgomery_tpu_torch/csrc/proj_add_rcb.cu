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
// before the first product. Design: one thread per lane; the formula is
// ordered so that inputs die as early as possible (the three cross sums are
// formed before the inputs are dropped), and the lazy sums stay below 6p so
// no reduction runs between products, exactly as in the JAX formula.
#include "field.cuh"

template <int NL>
__device__ __forceinline__ void rcb_add(uint32_t (&X3)[NL], uint32_t (&Y3)[NL], uint32_t (&Z3)[NL],
                                        const uint32_t (&X1)[NL], const uint32_t (&Y1)[NL],
                                        const uint32_t (&Z1)[NL], const uint32_t (&X2)[NL],
                                        const uint32_t (&Y2)[NL], const uint32_t (&Z2)[NL], const Fe<NL>& b3,
                                        const FieldParams<NL>& F) {
  uint32_t t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], t5[NL], u[NL], v[NL];
  fe_mul(t0, X1, X2, F);
  fe_mul(t1, Y1, Y2, F);
  fe_mul(t2, Z1, Z2, F);
  fe_add_lazy(u, X1, Y1);
  fe_add_lazy(v, X2, Y2);
  fe_mul(t3, u, v, F);  // m0
  fe_add_lazy(u, Y1, Z1);
  fe_add_lazy(v, Y2, Z2);
  fe_mul(t4, u, v, F);  // m1
  fe_add_lazy(u, X1, Z1);
  fe_add_lazy(v, X2, Z2);
  fe_mul(t5, u, v, F);  // m2
  fe_add_lazy(u, t0, t1);
  fe_sub_lazy(t3, t3, u, F);  // X1Y2 + X2Y1 (+4p)
  fe_add_lazy(u, t1, t2);
  fe_sub_lazy(t4, t4, u, F);  // Y1Z2 + Y2Z1 (+4p)
  fe_add_lazy(u, t0, t2);
  fe_sub_lazy(t5, t5, u, F);  // X1Z2 + X2Z1 (+4p)
  uint32_t t2b[NL], Y3b[NL];
  fe_mul(t2b, t2, b3.v, F);   // 3b Z1Z2
  fe_mul(Y3b, t5, b3.v, F);   // 3b (X1Z2 + X2Z1)
  fe_add_lazy(u, t0, t0);
  fe_add_lazy(t0, u, t0);     // 3 X1X2
  fe_add_lazy(t2, t1, t2b);   // Z3s = Y1Y2 + 3b Z1Z2
  fe_sub_lazy(t1, t1, t2b, F);  // t1m = Y1Y2 - 3b Z1Z2 (+4p)
  // Xa = t3 t1m, Xb = t4 Y3b, Ya = t1m Z3s, Yb = Y3b t0_3, Za = Z3s t4, Zb = t0_3 t3
  fe_mul(u, t3, t1, F);
  fe_mul(v, t4, Y3b, F);
  fe_sub(X3, u, v, F);
  fe_mul(u, t1, t2, F);
  fe_mul(v, Y3b, t0, F);
  fe_add(Y3, u, v, F);
  fe_mul(u, t2, t4, F);
  fe_mul(v, t0, t3, F);
  fe_add(Z3, u, v, F);
}

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
