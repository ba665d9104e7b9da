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
// 8 products and 1 product by the constant k. ed_add.cu's wide bodies
// (planar planes, and k-fold doubling) and ed_add_packed.cu (packed rows)
// call it per lane on madc.cuh's carry-chain fe_mul_cc (the template
// argument Mul; field.cuh's CIOS fe_mul agrees with it bit for bit).
//
// Bounds (inputs in [0, 2p), every product's result in [0, 2p)): the sums
// stay lazy as in the JAX formula. Y - X + 4p < 6p, Y + X < 4p, so A < 2p is
// the product of two factors below 6p; D = 2 ZZ < 4p, E = B - A + 4p < 6p,
// F = D - C + 4p < 8p, G = D + C < 6p, H = B + A < 4p (each subtrahend is
// below 4p, as fe_sub_lazy needs). The largest product operands are
// E F < 48 p^2 and F G < 48 p^2, below R p whenever R > 48p; FieldOps
// requires R > 64p (at NL = 9, R = 2^288 and R / p is about 2^35). So no
// reduction runs between products.
//
// coop_ed_add is the same add on one point in shared memory, carried by a
// block (the window combine, ed_combine.cu): its products fall into three
// dependent stages, {A, B, ZZ, k T1} | {C} | {X3, Y3, Z3, T3}; warp w computes
// the stage's product w with coop.cuh's warp product, and the lazy sums
// between stages run on lane 0 of the warp that needs them. The same field
// operations on the same values (coop_mul equals fe_mul bit for bit), so
// ed_add, coop_ed_add and the plain version agree bit for bit.
#pragma once
#include "coop.cuh"
#include "madc.cuh"

// (X3, Y3, Z3, T3) = P1 + P2 on the product Mul; the outputs may alias the
// inputs (every input is read before the first output is written)
template <int NL, class Mul = CarryChainMul>
__device__ __forceinline__ void ed_add(uint32_t (&X3)[NL], uint32_t (&Y3)[NL], uint32_t (&Z3)[NL],
                                       uint32_t (&T3)[NL], const uint32_t (&X1)[NL], const uint32_t (&Y1)[NL],
                                       const uint32_t (&Z1)[NL], const uint32_t (&T1)[NL],
                                       const uint32_t (&X2)[NL], const uint32_t (&Y2)[NL],
                                       const uint32_t (&Z2)[NL], const uint32_t (&T2)[NL], const Fe<NL>& k,
                                       const FieldParams<NL>& F) {
  uint32_t A[NL], B[NL], C[NL], ZZ[NL], u[NL], v[NL];
  fe_sub_lazy(u, Y1, X1, F);
  fe_sub_lazy(v, Y2, X2, F);
  Mul::mul(A, u, v, F);
  fe_add_lazy(u, Y1, X1);
  fe_add_lazy(v, Y2, X2);
  Mul::mul(B, u, v, F);
  Mul::mul(ZZ, Z1, Z2, F);
  Mul::mul(u, T1, k.v, F);
  Mul::mul(C, u, T2, F);
  uint32_t D[NL], E[NL], Fd[NL], G[NL], H[NL];
  fe_add_lazy(D, ZZ, ZZ);
  fe_sub_lazy(E, B, A, F);
  fe_sub_lazy(Fd, D, C, F);
  fe_add_lazy(G, D, C);
  fe_add_lazy(H, B, A);
  Mul::mul(X3, E, Fd, F);
  Mul::mul(Y3, G, H, F);
  Mul::mul(Z3, Fd, G, F);
  Mul::mul(T3, E, H, F);
}

// ---------------------------------------------------------- cooperative form

// warps of a block that carries a point with coop_ed_add
#define COOP_ED_WARPS 4

// the shared-memory state of one point carried by a block: the point, an
// addend, the constants and the formula's intermediates
template <int NL>
struct CoopEdPoint {
  uint32_t X[NL], Y[NL], Z[NL], T[NL];      // the point
  uint32_t X2[NL], Y2[NL], Z2[NL], T2[NL];  // an addend
  uint32_t k[NL];                           // k = 2d (Montgomery form)
  uint32_t s[13][NL];                       // intermediates
  CoopConsts<NL> C;
};

// (X, Y, Z, T) <- (X, Y, Z, T) + (X2, Y2, Z2, T2), ed_add's order of
// operations; the addend may be the point itself (a doubling) or the
// addend slots. Every thread of the block calls it (warps 0-3 work, any
// others only meet the barriers).
template <int NL>
__device__ __forceinline__ void coop_ed_add(CoopEdPoint<NL>& S, const uint32_t* X2, const uint32_t* Y2,
                                            const uint32_t* Z2, const uint32_t* T2, const FieldParams<NL>& F) {
  int warp = threadIdx.x >> 5, lane = warp_lane();
  uint32_t *A = S.s[0], *B = S.s[1], *ZZ = S.s[2], *kT = S.s[3], *C = S.s[4];
  uint32_t *E = S.s[5], *Fd = S.s[6], *G = S.s[7], *H = S.s[8];
  uint32_t *fa = S.s[9 + 2 * (warp & 1)], *fb = S.s[10 + 2 * (warp & 1)];  // warps 0, 1: their factors
  // stage 1: A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2), ZZ = Z1 Z2, k T1
  if (warp < 2) {
    if (lane == 0) {
      uint32_t a[NL], b[NL], r[NL];
      sm_get(a, S.Y);
      sm_get(b, S.X);
      if (warp == 0) fe_sub_lazy(r, a, b, F);  // < 6p
      else fe_add_lazy(r, a, b);               // < 4p
      sm_put(fa, r);
      sm_get(a, Y2);
      sm_get(b, X2);
      if (warp == 0) fe_sub_lazy(r, a, b, F);
      else fe_add_lazy(r, a, b);
      sm_put(fb, r);
    }
    __syncwarp();
    coop_mul(warp == 0 ? A : B, fa, fb, S.C);
  } else if (warp == 2) {
    coop_mul(ZZ, S.Z, Z2, S.C);
  } else if (warp == 3) {
    coop_mul(kT, S.T, S.k, S.C);
  }
  __syncthreads();
  // stage 2: C = (k T1) T2, then D = 2 ZZ, F = D - C, G = D + C; beside it
  // E = B - A and H = B + A
  if (warp == 0) {
    coop_mul(C, kT, T2, S.C);
    __syncwarp();
    if (lane == 0) {
      uint32_t a[NL], c[NL], d[NL], r[NL];
      sm_get(a, ZZ);
      sm_get(c, C);
      fe_add_lazy(d, a, a);       // D < 4p
      fe_sub_lazy(r, d, c, F);    // F < 8p
      sm_put(Fd, r);
      fe_add_lazy(r, d, c);       // G < 6p
      sm_put(G, r);
    }
  } else if (warp == 1 && lane == 0) {
    uint32_t a[NL], b[NL], r[NL];
    sm_get(a, A);
    sm_get(b, B);
    fe_sub_lazy(r, b, a, F);      // E < 6p
    sm_put(E, r);
    fe_add_lazy(r, b, a);         // H < 4p
    sm_put(H, r);
  }
  __syncthreads();
  // stage 3: X3 = E F, Y3 = G H, Z3 = F G, T3 = E H
  if (warp == 0) coop_mul(S.X, E, Fd, S.C);
  else if (warp == 1) coop_mul(S.Y, G, H, S.C);
  else if (warp == 2) coop_mul(S.Z, Fd, G, S.C);
  else if (warp == 3) coop_mul(S.T, E, H, S.C);
  __syncthreads();
}
