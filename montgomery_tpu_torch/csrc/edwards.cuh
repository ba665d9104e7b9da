// The unified twisted Edwards add (a = -1) in extended coordinates.
//
// Replaces the formula that montgomery_tpu/curves/edwards.py inlines into
// its Pallas kernels "ed_add" and "ed_add_packed": _add_formula (:96-114),
// add-2008-hwcd-3 (Hisil-Wong-Carter-Dawson 2008, "strongly unified": valid
// for P == Q and for the identity (0 : 1 : 1 : 0), so it is also the
// doubling). With k = 2d in Montgomery form:
//   A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2), ZZ = Z1 Z2,
//   C = (k T1) T2, D = 2 ZZ, E = B - A, F = D - C, G = D + C, H = B + A,
//   (X3 : Y3 : Z3 : T3) = (E F : G H : F G : E H).
// 8 products and 1 product by the constant k. ed_add.cu (planar planes, and
// k-fold doubling) and ed_add_packed.cu (packed rows) call it per lane.
//
// Bounds (inputs in [0, 2p), every product's result in [0, 2p)): the sums
// stay lazy as in the JAX formula. Y - X + 4p < 6p, Y + X < 4p, so A < 2p is
// the product of two factors below 6p; D = 2 ZZ < 4p, E = B - A + 4p < 6p,
// F = D - C + 4p < 8p, G = D + C < 6p, H = B + A < 4p (each subtrahend is
// below 4p, as fe_sub_lazy needs). The largest product operands are
// E F < 48 p^2 and F G < 48 p^2, below R p whenever R > 48p; FieldOps
// requires R > 64p (at NL = 9, R = 2^288 and R / p is about 2^35). So no
// reduction runs between products.
#pragma once
#include "field.cuh"

// (X3, Y3, Z3, T3) = P1 + P2; the outputs may alias the inputs (every input
// is read before the first output is written)
template <int NL>
__device__ __forceinline__ void ed_add(uint32_t (&X3)[NL], uint32_t (&Y3)[NL], uint32_t (&Z3)[NL],
                                       uint32_t (&T3)[NL], const uint32_t (&X1)[NL], const uint32_t (&Y1)[NL],
                                       const uint32_t (&Z1)[NL], const uint32_t (&T1)[NL],
                                       const uint32_t (&X2)[NL], const uint32_t (&Y2)[NL],
                                       const uint32_t (&Z2)[NL], const uint32_t (&T2)[NL], const Fe<NL>& k,
                                       const FieldParams<NL>& F) {
  uint32_t A[NL], B[NL], C[NL], ZZ[NL], u[NL], v[NL];
  fe_sub_lazy(u, Y1, X1, F);
  fe_sub_lazy(v, Y2, X2, F);
  fe_mul(A, u, v, F);
  fe_add_lazy(u, Y1, X1);
  fe_add_lazy(v, Y2, X2);
  fe_mul(B, u, v, F);
  fe_mul(ZZ, Z1, Z2, F);
  fe_mul(u, T1, k.v, F);
  fe_mul(C, u, T2, F);
  uint32_t D[NL], E[NL], Fd[NL], G[NL], H[NL];
  fe_add_lazy(D, ZZ, ZZ);
  fe_sub_lazy(E, B, A, F);
  fe_sub_lazy(Fd, D, C, F);
  fe_add_lazy(G, D, C);
  fe_add_lazy(H, B, A);
  fe_mul(X3, E, Fd, F);
  fe_mul(Y3, G, H, F);
  fe_mul(Z3, Fd, G, F);
  fe_mul(T3, E, H, F);
}
