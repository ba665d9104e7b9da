// Complete projective addition and doubling for a = 0 (Renes-Costello-Batina
// 2015/1060, Alg. 7 and Alg. 9):
//
// - rcb_dbl: one point in one thread's registers, its products on
//   madc.cuh's carry chains (wide launches, one lane a thread:
//   proj_dbl_rcb.cu; the wide add spreads a lane over six threads in
//   proj_add_rcb.cu itself);
// - coop_add, coop_dbl: one point in shared memory, carried by a block
//   (few-lane launches and the window combine: proj_add_rcb.cu,
//   proj_dbl_rcb.cu, proj_combine_rcb.cu). A formula's products fall into
//   dependent stages, Alg. 9's 9 into 4 | 1 | 4 and Alg. 7's 14 into
//   6 | 2 | 6; warp w computes
//   the stage's product w with coop.cuh's warp product, and the additions
//   between stages run on lane 0 of the warp that needs them. So a doubling's
//   critical path is 3 warp products instead of 9 one-thread products.
//
// Both forms run the same field operations in the same order on the same
// values (fe_mul_cc and coop_mul equal fe_mul bit for bit), so they agree
// with each other and with the plain versions bit for bit. The lazy sums
// stay below 8p, as in the JAX formulas (_add_rcb_formula, _dbl_rcb_formula of
// montgomery_tpu/curves/projective.py).
#pragma once
#include "coop.cuh"
#include "madc.cuh"

// (X, Y, Z) <- 2 (X, Y, Z) on the product Mul (madc.cuh)
template <int NL, class Mul = CarryChainMul>
__device__ __forceinline__ void rcb_dbl(uint32_t (&X)[NL], uint32_t (&Y)[NL], uint32_t (&Z)[NL],
                                        const Fe<NL>& b3, const FieldParams<NL>& F) {
  uint32_t YY[NL], ZZ[NL], YZ[NL], XY[NL], Z3d[NL], t2[NL], u[NL], v[NL];
  Mul::mul(YY, Y, Y, F);
  Mul::mul(ZZ, Z, Z, F);
  Mul::mul(YZ, Y, Z, F);
  Mul::mul(XY, X, Y, F);
  fe_add(Z3d, YY, YY, F);
  fe_add(Z3d, Z3d, Z3d, F);   // 4 Y^2, reduced
  fe_add_lazy(Z3d, Z3d, Z3d);  // 8 Y^2 < 4p
  Mul::mul(t2, ZZ, b3.v, F);  // 3b Z^2
  fe_add_lazy(u, YY, t2);     // Y3t < 4p
  fe_add(v, t2, t2, F);
  fe_add(v, v, t2, F);        // 9b Z^2 reduced
  fe_sub_lazy(YY, YY, v, F);  // t0m = Y^2 - 9b Z^2 + 4p < 6p
  Mul::mul(X, t2, Z3d, F);    // X3a
  Mul::mul(Z, YZ, Z3d, F);    // Z3
  Mul::mul(v, YY, u, F);      // Y3a
  fe_add(Y, X, v, F);         // Y3 = X3a + Y3a
  Mul::mul(v, YY, XY, F);     // X3b
  fe_add(X, v, v, F);         // X3 = 2 X3b
}

// ---------------------------------------------------------- cooperative form

// warps of a block that carries points with coop_dbl (4) and coop_add (6)
#define COOP_DBL_WARPS 4
#define COOP_ADD_WARPS 6

// the shared-memory state of one point carried by a block: the point, an
// addend, the constants and the formulas' intermediates (one NL-word slot
// each)
template <int NL>
struct CoopPoint {
  uint32_t X[NL], Y[NL], Z[NL];     // the point
  uint32_t X2[NL], Y2[NL], Z2[NL];  // coop_add's second operand
  uint32_t b3[NL];
  uint32_t s[20][NL];               // intermediates
  CoopConsts<NL> C;
};

// (X, Y, Z) <- 2 (X, Y, Z), as rcb_dbl; every thread of the block calls it
// (warps 0-3 work, the others only meet the barriers)
template <int NL>
__device__ __forceinline__ void coop_dbl(CoopPoint<NL>& S, const FieldParams<NL>& F) {
  int warp = threadIdx.x >> 5, lane = warp_lane();
  uint32_t *YY = S.s[0], *ZZ = S.s[1], *YZ = S.s[2], *XY = S.s[3], *t2 = S.s[4], *Z3d = S.s[5];
  uint32_t *u = S.s[6], *t0m = S.s[7], *X3a = S.s[8], *Y3a = S.s[9], *X3b = S.s[10];
  // stage 1: Y^2, Z^2, Y Z, X Y
  if (warp == 0) coop_mul(YY, S.Y, S.Y, S.C);
  else if (warp == 1) coop_mul(ZZ, S.Z, S.Z, S.C);
  else if (warp == 2) coop_mul(YZ, S.Y, S.Z, S.C);
  else if (warp == 3) coop_mul(XY, S.X, S.Y, S.C);
  __syncthreads();
  // stage 2: t2 = 3b Z^2, then Y3t and t0m; beside it Z3d = 8 Y^2
  if (warp == 0) {
    coop_mul(t2, ZZ, S.b3, S.C);
    __syncwarp();
    if (lane == 0) {
      uint32_t a[NL], b[NL], v[NL], r[NL];
      sm_get(a, YY);
      sm_get(b, t2);
      fe_add_lazy(r, a, b);  // Y3t < 4p
      sm_put(u, r);
      fe_add(v, b, b, F);
      fe_add(v, v, b, F);    // 9b Z^2 reduced
      fe_sub_lazy(r, a, v, F);  // t0m < 6p
      sm_put(t0m, r);
    }
  } else if (warp == 1 && lane == 0) {
    uint32_t a[NL], r[NL];
    sm_get(a, YY);
    fe_add(r, a, a, F);
    fe_add(r, r, r, F);
    fe_add_lazy(r, r, r);  // 8 Y^2 < 4p
    sm_put(Z3d, r);
  }
  __syncthreads();
  // stage 3: X3a = t2 Z3d, Z3 = YZ Z3d, Y3a = t0m Y3t, X3b = t0m XY
  if (warp == 0) coop_mul(X3a, t2, Z3d, S.C);
  else if (warp == 1) coop_mul(S.Z, YZ, Z3d, S.C);
  else if (warp == 2) coop_mul(Y3a, t0m, u, S.C);
  else if (warp == 3) coop_mul(X3b, t0m, XY, S.C);
  __syncthreads();
  if (lane == 0 && warp < 2) {
    uint32_t a[NL], b[NL], r[NL];
    if (warp == 0) {
      sm_get(a, X3a);
      sm_get(b, Y3a);
      fe_add(r, a, b, F);  // Y3
      sm_put(S.Y, r);
    } else {
      sm_get(a, X3b);
      fe_add(r, a, a, F);  // X3
      sm_put(S.X, r);
    }
  }
  __syncthreads();
}

// (X, Y, Z) <- (X, Y, Z) + (X2, Y2, Z2), the order of operations of
// proj_add_rcb.cu's six-threads-a-lane body; every thread of the block
// calls it (warps 0-5 work)
template <int NL>
__device__ __forceinline__ void coop_add(CoopPoint<NL>& S, const FieldParams<NL>& F) {
  int warp = threadIdx.x >> 5, lane = warp_lane();
  uint32_t *t0 = S.s[0], *t1 = S.s[1], *t2 = S.s[2], *m0 = S.s[3], *m1 = S.s[4], *m2 = S.s[5];
  uint32_t *sa = S.s[6 + 2 * (warp % 3)], *sb = S.s[7 + 2 * (warp % 3)];  // warps 3-5: their sums
  uint32_t *t3 = S.s[12], *t4 = S.s[13], *t5 = S.s[14], *t03 = S.s[15];
  uint32_t *t2b = S.s[16], *Y3b = S.s[17], *Z3s = S.s[18], *t1m = S.s[19];
  // products of stage C reuse the slots of stage A
  uint32_t *Xa = S.s[0], *Xb = S.s[1], *Ya = S.s[2], *Yb = S.s[3], *Za = S.s[4], *Zb = S.s[5];
  // stage A: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
  if (warp >= 3 && warp < 6) {
    if (lane == 0) {
      const uint32_t *p1 = warp == 4 ? S.Y : S.X, *q1 = warp == 3 ? S.Y : S.Z;
      const uint32_t *p2 = warp == 4 ? S.Y2 : S.X2, *q2 = warp == 3 ? S.Y2 : S.Z2;
      uint32_t a[NL], b[NL], r[NL];
      sm_get(a, p1);
      sm_get(b, q1);
      fe_add_lazy(r, a, b);
      sm_put(sa, r);
      sm_get(a, p2);
      sm_get(b, q2);
      fe_add_lazy(r, a, b);
      sm_put(sb, r);
    }
    __syncwarp();
    coop_mul(warp == 3 ? m0 : warp == 4 ? m1 : m2, sa, sb, S.C);
  } else if (warp == 0) coop_mul(t0, S.X, S.X2, S.C);
  else if (warp == 1) coop_mul(t1, S.Y, S.Y2, S.C);
  else if (warp == 2) coop_mul(t2, S.Z, S.Z2, S.C);
  __syncthreads();
  // the cross sums t3, t4, t5 (each + 4p) and 3 X1X2
  if (lane == 0 && warp < 4) {
    uint32_t a[NL], b[NL], r[NL];
    if (warp == 3) {
      sm_get(a, t0);
      fe_add_lazy(r, a, a);
      fe_add_lazy(r, r, a);
      sm_put(t03, r);
    } else {
      const uint32_t *pa = warp == 1 ? t1 : t0, *pb = warp == 0 ? t1 : t2;
      const uint32_t* pm = warp == 0 ? m0 : warp == 1 ? m1 : m2;
      sm_get(a, pa);
      sm_get(b, pb);
      fe_add_lazy(r, a, b);
      sm_get(a, pm);
      fe_sub_lazy(b, a, r, F);
      sm_put(warp == 0 ? t3 : warp == 1 ? t4 : t5, b);
    }
  }
  __syncthreads();
  // stage B: 3b Z1Z2 and 3b (X1Z2 + X2Z1); then Z3s and t1m
  if (warp == 0) {
    coop_mul(t2b, t2, S.b3, S.C);
    __syncwarp();
    if (lane == 0) {
      uint32_t a[NL], b[NL], r[NL];
      sm_get(a, t1);
      sm_get(b, t2b);
      fe_add_lazy(r, a, b);
      sm_put(Z3s, r);
      fe_sub_lazy(r, a, b, F);
      sm_put(t1m, r);
    }
  } else if (warp == 1) {
    coop_mul(Y3b, t5, S.b3, S.C);
  }
  __syncthreads();
  // stage C: the six products of X3, Y3, Z3
  if (warp == 0) coop_mul(Xa, t3, t1m, S.C);
  else if (warp == 1) coop_mul(Xb, t4, Y3b, S.C);
  else if (warp == 2) coop_mul(Ya, t1m, Z3s, S.C);
  else if (warp == 3) coop_mul(Yb, Y3b, t03, S.C);
  else if (warp == 4) coop_mul(Za, Z3s, t4, S.C);
  else if (warp == 5) coop_mul(Zb, t03, t3, S.C);
  __syncthreads();
  if (lane == 0 && warp < 3) {
    uint32_t a[NL], b[NL], r[NL];
    sm_get(a, warp == 0 ? Xa : warp == 1 ? Ya : Za);
    sm_get(b, warp == 0 ? Xb : warp == 1 ? Yb : Zb);
    if (warp == 0) fe_sub(r, a, b, F);
    else fe_add(r, a, b, F);
    sm_put(warp == 0 ? S.X : warp == 1 ? S.Y : S.Z, r);
  }
  __syncthreads();
}

// the block's shared constants: p and mu for the warp product, 3b
template <int NL>
__device__ __forceinline__ void coop_init(CoopPoint<NL>& S, const FieldParams<NL>& F, const Fe<NL>& mu,
                                          const Fe<NL>& b3) {
  coop_load_consts(S.C, F, mu);
  if (threadIdx.x == 0) sm_put(S.b3, b3.v);
}

// point i of (3 NL, stride) planes into (X, Y, Z) (or the addend slots) by
// the threads t = 0 .. nthreads - 1 of the caller's choosing; the caller's
// barrier publishes it
template <int NL>
__device__ __forceinline__ void coop_load_point(uint32_t* X, uint32_t* Y, uint32_t* Z, const int32_t* PX,
                                                const int32_t* PY, const int32_t* PZ, size_t stride,
                                                size_t i, int t, int nthreads) {
  for (int j = t; j >= 0 && j < 3 * NL; j += nthreads) {
    const int32_t* P = j < NL ? PX : j < 2 * NL ? PY : PZ;
    uint32_t* D = j < NL ? X : j < 2 * NL ? Y : Z;
    D[j % NL] = (uint32_t)P[(size_t)(j % NL) * stride + i];
  }
}

// (X, Y, Z) to point i of (3 NL, stride) planes, by the block's threads
template <int NL>
__device__ __forceinline__ void coop_store_point(int32_t* PX, int32_t* PY, int32_t* PZ, size_t stride,
                                                 size_t i, const CoopPoint<NL>& S) {
  for (int j = threadIdx.x; j < 3 * NL; j += blockDim.x) {
    int32_t* P = j < NL ? PX : j < 2 * NL ? PY : PZ;
    const uint32_t* D = j < NL ? S.X : j < 2 * NL ? S.Y : S.Z;
    P[(size_t)(j % NL) * stride + i] = (int32_t)D[j % NL];
  }
}
