// The complete affine add around a shared batch inversion, for
// y^2 = x^3 + a x + b.
//
// Replaces the formulas that montgomery_tpu/curves/affine.py inlines into its
// safe batched-affine kernels: _pre_inv_formula (:76-99), the edge-case
// triage before the inversion, and _post_inv_formula (:101-121), the chord or
// tangent completion after it, with _slope_numer_dbl (:67-74), 3 x^2 + a.
// The packed kernels (aff_pre_packed.cu, aff_post_packed.cu) and the planar
// ones (aff_pre.cu, aff_post.cu) call them per lane; aff_chord is the
// completion of the unsafe add, packed (aff_post_packed_u.cu) and planar
// (aff_post_unsafe.cu), _post_inv_unsafe_formula (:160-167). Templates over
// the limb count like field.cuh; the kernels instantiate them at the three
// Weierstrass fields' counts: 12 limbs (BLS12-377), 13 (BLS12-381), 9
// (Pallas). b enters only through 3b, a run-time argument of the projective
// kernels; the affine formulas do not use it. a enters only the tangent's
// numerator, through aff_triage's template flag WITH_A: false for the a = 0
// curves, whose instantiation leaves its argument unread and adds nothing.
//
// Flags of a lane: bit 1 is_dbl (both finite, x1 == x2, y1 == y2), bit 2
// cancel (both finite, x1 == x2, y1 != y2), bit 4 y1_zero. A lane whose
// denominator would be 0 or meaningless (cancel, a tangent at y = 0, any
// infinite operand) gets the Montgomery form of 1 instead, so that no lane
// brings a zero into the shared inversion.
//
// aff_chord runs on the product and square of its template argument Mul
// (madc.cuh): the carry-chain fe_mul_cc and fe_sqr_cc in the kernels
// (field.cuh's CIOS fe_mul and fe_sqr agree with them bit for bit). The
// safe adds' triage and completion stay on CIOS. Both products are exact
// only for a b < R p, so the chord's operands, each in [0, 2p):
//   - x1, y1, x2, y2 as loaded: every producer writes [0, 2p) (Montgomery
//     forms from pack_raw, mont_mul or mul_const; pack_glv's beta x, a
//     product; the adds' outputs, fe_sub results; the unreduced [p, 2p)
//     representatives that the checks feed); load_signed's y is fe_neg of a
//     [0, 2p) value, 2p - y reduced into [0, 2p) (0 stays 0);
//   - dinv, and the fused level's inv1: FieldOps.batch_inv and
//     batch_inv_parent return products (mont_mul, and the root's
//     divstep_inv_mont ends in a Montgomery product), in [0, 2p);
//   - the fused level's denom: aff_pre_packed_u's fe_sub, or the Montgomery
//     form of 1 (below p);
//   - every fe_sub result: x - y mod 2p, in [0, 2p) for x, y in [0, 2p);
//   - lambda, and the fused level's dinv: products of two [0, 2p) factors.
// So every product and square takes a b < 4 p^2, and R > 64p (field.cuh)
// puts that below R p / 16: no operand comes near R, and nothing is reduced
// before a product (tests/test_torch_madc.py composes the chord from the
// product's and the square's op-by-op models and asserts a b < R p at these
// ranges).
#pragma once
#include "madc.cuh"

#define AFF_DBL 1
#define AFF_CANCEL 2
#define AFF_Y1_ZERO 4

// x and the sign-applied y (y -> -y where neg) of column i of packed rows
// [x (NL) | y (NL) | inf (1)] with row stride s
template <int NL>
__device__ __forceinline__ void load_signed(uint32_t (&x)[NL], uint32_t (&y)[NL], const int32_t* P, int s,
                                            int i, bool neg, const FieldParams<NL>& F) {
  uint32_t t[NL];
  fe_load(x, P, s, i);
  fe_load(t, P + (size_t)NL * s, s, i);
  fe_neg(y, t, F);
  fe_select(y, neg, y, t);
}

// denominator (2 y1 for a doubling, x2 - x1 otherwise, 1 where poisoned),
// slope numerator (3 x1^2 + a for a doubling, y2 - y1 otherwise) and flags;
// ca is a in Montgomery form, read only where WITH_A
template <int NL, bool WITH_A = false>
__device__ __forceinline__ int aff_triage(uint32_t (&denom)[NL], uint32_t (&numer)[NL],
                                          const uint32_t (&x1)[NL], const uint32_t (&y1)[NL],
                                          const uint32_t (&x2)[NL], const uint32_t (&y2)[NL], bool inf1,
                                          bool inf2, const uint32_t (&one)[NL], const uint32_t (&ca)[NL],
                                          const FieldParams<NL>& F) {
  bool xeq = fe_is_equal(x1, x2, F), yeq = fe_is_equal(y1, y2, F);
  bool finite = !inf1 && !inf2;
  bool is_dbl = xeq && yeq && finite;
  bool cancel = xeq && !yeq && finite;
  bool y1_zero = fe_is_zero(y1, F);
  uint32_t a[NL], b[NL];
  fe_add(a, y1, y1, F);
  fe_sub(b, x2, x1, F);
  fe_select(denom, is_dbl, a, b);
  bool poisoned = cancel || (is_dbl && y1_zero) || !finite;
  fe_select(denom, poisoned, one, denom);
  // both numerators are computed on every lane, as the formula does
  uint32_t xx[NL];
  fe_sqr(xx, x1, F);
  fe_add(a, xx, xx, F);
  fe_add(a, a, xx, F);
  if constexpr (WITH_A) fe_add(a, a, ca, F);
  fe_sub(b, y2, y1, F);
  fe_select(numer, is_dbl, a, b);
  return (is_dbl ? AFF_DBL : 0) | (cancel ? AFF_CANCEL : 0) | (y1_zero ? AFF_Y1_ZERO : 0);
}

// lambda = numer dinv, x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1,
// then the edge cases: the sum is infinite on cancel, on a tangent at y = 0
// and when both operands are; one infinite operand passes the other through.
// Returns whether the sum is infinite.
template <int NL>
__device__ __forceinline__ bool aff_complete(uint32_t (&x3)[NL], uint32_t (&y3)[NL],
                                             const uint32_t (&x1)[NL], const uint32_t (&y1)[NL],
                                             const uint32_t (&x2)[NL], const uint32_t (&y2)[NL],
                                             const uint32_t (&dinv)[NL], const uint32_t (&numer)[NL], int flags,
                                             bool inf1, bool inf2, const FieldParams<NL>& F) {
  uint32_t lam[NL], t[NL];
  fe_mul(lam, numer, dinv, F);
  fe_sqr(t, lam, F);
  fe_sub(t, t, x1, F);
  fe_sub(x3, t, x2, F);
  fe_sub(t, x1, x3, F);
  fe_mul(t, lam, t, F);
  fe_sub(y3, t, y1, F);
  bool only1 = inf1 && !inf2, only2 = inf2 && !inf1;
  fe_select(x3, only1, x2, x3);
  fe_select(y3, only1, y2, y3);
  fe_select(x3, only2, x1, x3);
  fe_select(y3, only2, y1, y3);
  return (flags & AFF_CANCEL) || ((flags & AFF_DBL) && (flags & AFF_Y1_ZERO)) || (inf1 && inf2);
}

// the chord of the unsafe add (no edge cases): lambda = (y2 - y1) dinv,
// x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1; two products and a
// square on Mul (the square equal to the product lam lam bit for bit)
template <int NL, class Mul = CarryChainMul>
__device__ __forceinline__ void aff_chord(uint32_t (&x3)[NL], uint32_t (&y3)[NL], const uint32_t (&x1)[NL],
                                          const uint32_t (&y1)[NL], const uint32_t (&x2)[NL],
                                          const uint32_t (&y2)[NL], const uint32_t (&dinv)[NL],
                                          const FieldParams<NL>& F) {
  uint32_t lam[NL], t[NL];
  fe_sub(t, y2, y1, F);
  Mul::mul(lam, t, dinv, F);
  Mul::sqr(t, lam, F);
  fe_sub(t, t, x1, F);
  fe_sub(x3, t, x2, F);
  fe_sub(t, x1, x3, F);
  Mul::mul(y3, lam, t, F);
  fe_sub(y3, y3, y1, F);
}
