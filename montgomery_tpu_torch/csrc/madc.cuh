// The Montgomery product and square on PTX carry chains, for the
// one-thread-a-product kernels that are bound by the integer multiply pipe
// (proj_dbl_rcb.cu's wide body, ed_add_packed.cu, ed_add.cu, exp_ladder.cu,
// and the unsafe chord of aff_post_unsafe.cu and aff_post_packed_u.cu; the
// square fe_sqr_cc is at the end of this file).
//
// field.cuh's fe_mul adds each 64-bit product to the running word and its
// carry in C (`(uint64_t)t[j] + a[j] b[i] + c`), so every step waits on the
// carry of the step before, twice a row. Here the rows are PTX carry chains
// (mad.lo.cc / madc.lo.cc / madc.hi.cc / addc.cc, the 32-bit halves of each
// product added where they land), and, as in sppark's mont_t, the products
// of even words a_j (j = 0, 2, ...) and of odd words (j = 1, 3, ...) go
// into two accumulators: L, whose word k sits at position k (w^k, w = 2^32),
// and H, whose word k sits at position k + 1. The lo and hi halves of an
// even product fall on consecutive words of L, those of an odd product on
// consecutive words of H, so each chain is one unbroken run of adds and
// neither waits on the other. Per row i (b_i the row's word):
//   a-phase: H += odd products of a b_i, L += even products;
//   m = L[0] mu (H has no word at position 0);
//   p-phase: H += odd products of m p, L += even products; now L[0] = 0;
//   shift one word down: L takes H's words, H takes L's words 2.., and L's
//   word 1 (now at position 0) is added into L[0] at the start of the next
//   row, its carry taken by the next row's first chain.
// A carry out of the top of either accumulator lands in X, one word at
// position NL + 1, which the shift moves to H's top word. With an odd NL
// (9, 13) the hi half of the last even product lands at position NL, on
// H's top word. The rows end with H + (L >> one word).
//
// The result is fe_mul's bit for bit: both compute (a b + m p) / R for the
// unique m < R with a b + m p = 0 mod R, and neither ends with a
// subtraction, so it lies in [0, 2p) for a b < R p. No carry is dropped:
// between rows T = L + H w + X w^(NL+1) is CIOS's running value, below
// a + p <= R + p, and within a row below (a + p) w < 2 w^(NL+1); each part
// is at most T, so L fits NL words, H NL words and X one bit, and each
// chain's last add into X cannot carry (tests/test_torch_madc.py models the
// word order op by op and asserts it). The word count of a product is
// fe_mul's: 2 NL^2 32x32 products, each as its lo and hi half.
//
// Limb counts. The chains hold from NL = 2 up (tests/test_torch_madc.py runs
// the model at 2, 3, 9, 12 and 13 limbs; with an even NL the last odd
// product ends at position NL - 1 and H's top word takes only carries). At
// NL = 1 there is no odd word: H would hold no product, the even chain
// would open with madc on a carry nothing set, and the end reads L's word
// 1. So there fe_mul_cc and fe_sqr_cc run field.cuh's CIOS fe_mul and fe_sqr
// (`if constexpr`): one product and one quotient row, nothing for two chains
// to overlap, and the same words (both are (a b + m p) / R).
//
// Every op that reads or writes the carry flag is one `asm volatile`, so
// the compiler keeps them in program order; nothing between them touches
// the flag (plain C never does).
#pragma once
#include "field.cuh"

__device__ __forceinline__ uint32_t cc_mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t cc_mul_hi(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// lo(a b) + c, carry out
__device__ __forceinline__ uint32_t cc_mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// lo(a b) + c + carry, carry out
__device__ __forceinline__ uint32_t cc_madc_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// hi(a b) + c + carry, carry out
__device__ __forceinline__ uint32_t cc_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// hi(a b) + c, carry out
__device__ __forceinline__ uint32_t cc_mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// hi(a b) + c + carry, no carry out (the caller's bound says there is none)
__device__ __forceinline__ uint32_t cc_madc_hi_end(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// a + b, carry out
__device__ __forceinline__ uint32_t cc_add(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a + b + carry, carry out
__device__ __forceinline__ uint32_t cc_addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a + b + carry, no carry out (the caller's bound says there is none)
__device__ __forceinline__ uint32_t cc_addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// H += sum over odd j of v_j s w^(j-1); the carry out of H's top word goes
// into X. CARRY_IN: the chain's first add takes the carry flag (the fold of
// the shift), else it starts afresh.
template <int NL, bool CARRY_IN>
__device__ __forceinline__ void cc_odd_chain(uint32_t (&H)[NL], uint32_t& X, const uint32_t (&v)[NL],
                                             uint32_t s) {
#pragma unroll
  for (int j = 1; j < NL; j += 2) {
    H[j - 1] = (CARRY_IN || j > 1) ? cc_madc_lo(v[j], s, H[j - 1]) : cc_mad_lo(v[j], s, H[j - 1]);
    H[j] = cc_madc_hi(v[j], s, H[j]);
  }
  if (NL % 2) H[NL - 1] = cc_addc_cc(H[NL - 1], 0);  // the last odd product ends at position NL - 1
  X = cc_addc(X, 0);
}

// L += sum over even j of v_j s w^j; with an odd NL the last product's hi
// half lands on H's top word (position NL); the carry out goes into X
template <int NL>
__device__ __forceinline__ void cc_even_chain(uint32_t (&L)[NL], uint32_t (&H)[NL], uint32_t& X,
                                              const uint32_t (&v)[NL], uint32_t s) {
#pragma unroll
  for (int j = 0; j + 1 < NL; j += 2) {
    L[j] = j == 0 ? cc_mad_lo(v[j], s, L[j]) : cc_madc_lo(v[j], s, L[j]);
    L[j + 1] = cc_madc_hi(v[j], s, L[j + 1]);
  }
  if (NL % 2) {
    L[NL - 1] = cc_madc_lo(v[NL - 1], s, L[NL - 1]);
    H[NL - 1] = cc_madc_hi(v[NL - 1], s, H[NL - 1]);
  } else {
    H[NL - 1] = cc_addc_cc(H[NL - 1], 0);  // position NL
  }
  X = cc_addc(X, 0);
}

// Montgomery product a b / R mod p on carry chains, equal to fe_mul bit for
// bit: in [0, 2p) for a b < R p
template <int NL>
__device__ __forceinline__ void fe_mul_cc(uint32_t (&r)[NL], const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                          const FieldParams<NL>& F) {
  if constexpr (NL == 1) {
    fe_mul(r, a, b, F);  // one word: no odd product to chain (see above)
  } else {
    uint32_t L[NL], H[NL], X = 0;
    // row 0: the products alone
#pragma unroll
    for (int j = 0; j + 1 < NL; j += 2) {
      L[j] = cc_mul_lo(a[j], b[0]);
      L[j + 1] = cc_mul_hi(a[j], b[0]);
    }
#pragma unroll
    for (int j = 1; j < NL; j += 2) {
      H[j - 1] = cc_mul_lo(a[j], b[0]);
      H[j] = cc_mul_hi(a[j], b[0]);
    }
    if (NL % 2) {
      L[NL - 1] = cc_mul_lo(a[NL - 1], b[0]);
      H[NL - 1] = cc_mul_hi(a[NL - 1], b[0]);
    }
#pragma unroll
    for (int i = 0; i < NL; i++) {
      if (i > 0) {
        // shift one word down: L <- H; H <- L[2..], 0 at position NL - 1 and
        // X at NL; L's word 1 is folded into L[0], its carry into the chain
        uint32_t fold = L[1];
#pragma unroll
        for (int k = 0; k < NL; k++) {
          uint32_t h = H[k];
          H[k] = k + 2 < NL ? L[k + 2] : k == NL - 2 ? 0u : X;
          L[k] = h;
        }
        X = 0;
        L[0] = cc_add(L[0], fold);
        cc_odd_chain<NL, true>(H, X, a, b[i]);
        cc_even_chain(L, H, X, a, b[i]);
      }
      uint32_t m = L[0] * F.mu;
      cc_odd_chain<NL, false>(H, X, F.p, m);
      cc_even_chain(L, H, X, F.p, m);
    }
    // (L + H w) / w: L's word 0 is zero, X is zero
    r[0] = cc_add(H[0], L[1]);
#pragma unroll
    for (int k = 1; k < NL - 1; k++) r[k] = cc_addc_cc(H[k], L[k + 1]);
    r[NL - 1] = cc_addc(H[NL - 1], 0);
  }
}

// ------------------------------------------------------------------ square
//
// fe_sqr_cc: the Montgomery square on the same chains, equal to fe_sqr (and
// fe_mul(a, a)) bit for bit. SOS order: the whole square T = a^2 first,
// then the NL reduction rows.
//   cross products a_i a_j (i < j): row i's products with j - i odd go into
//   the accumulator O, those with j - i even into E, each at its absolute
//   position (lo half at i + j, hi at i + j + 1), so one row is two
//   unbroken chains, one a accumulator, as fe_mul_cc keeps its even and odd
//   words apart. Row 0 of each is plain products (its words do not
//   overlap); a later row's chain runs on through the words earlier rows
//   left (sqr_live) and ends in a fresh word that takes its carry;
//   D = O + E (one add chain), T = 2 D (funnel shifts: D < a^2 / 2), then
//   T += sum a_i^2 w^(2i), the diagonal, as one chain over all 2 NL words;
//   reduction: fe_mul_cc's rows without their a-phase, on its accumulators
//   L (word k at position k) and H (word k at k + 1) with L = T's low NL
//   words: each row adds m p (m = L[0] mu) and shifts one word down, and
//   the shift brings T's next high word in at position NL - 1 (the word
//   fe_mul_cc's shift clears); T's top word joins the last add.
// No carry is dropped: the cross sum is below a^2 / 2 < w^(2 NL) / 2, the
// square below w^(2 NL); before row i's m p the window is (T mod
// w^(NL + i) + sum_{k<i} m_k p w^k) / w^i < w^NL + p, and after it below
// w^NL + p + w p < w^(NL + 1), so X stays 0 and each chain's last add
// cannot carry (tests/test_torch_madc.py models the order op by op and
// asserts it). The result is (a^2 + m p) / R for the unique m < R, in
// [0, 2p) for a^2 < R p. Work: NL (NL - 1) / 2 cross products, NL squares
// and NL^2 reduction products (222 at NL = 12, against fe_mul_cc's 288).

// the top position of row i's chain in accumulator Q (1: j - i odd, 0:
// even), and the highest position that holds data once row i is done;
// template arguments, so that every word index is a constant and the
// accumulators stay in registers
__host__ __device__ constexpr int sqr_top(int NL, int Q, int i) {
  return i + ((NL - 1 - i) % 2 == Q ? NL - 1 : NL - 2) + 1;
}

__host__ __device__ constexpr int sqr_live(int NL, int Q, int i) {
  return i == 0 ? sqr_top(NL, Q, 0)
                : (sqr_top(NL, Q, i) > sqr_live(NL, Q, i - 1) ? sqr_top(NL, Q, i) : sqr_live(NL, Q, i - 1)) + 1;
}

// accumulator Q += a_i a_j w^(i + j) for j = I + 2 - Q, I + 4 - Q, ... < NL
template <int NL, int Q, int I>
__device__ __forceinline__ void cc_cross_row(uint32_t (&A)[2 * NL], const uint32_t (&a)[NL]) {
  constexpr int j0 = I + 2 - Q;
  if constexpr (j0 >= NL) {
    return;
  } else if constexpr (I == 0) {
#pragma unroll
    for (int j = j0; j < NL; j += 2) {
      A[j] = cc_mul_lo(a[0], a[j]);
      A[j + 1] = cc_mul_hi(a[0], a[j]);
    }
  } else {
    constexpr int top = sqr_top(NL, Q, I), live = sqr_live(NL, Q, I - 1);
#pragma unroll
    for (int j = j0; j < NL; j += 2) {
      A[I + j] = j == j0 ? cc_mad_lo(a[I], a[j], A[I + j]) : cc_madc_lo(a[I], a[j], A[I + j]);
      A[I + j + 1] = cc_madc_hi(a[I], a[j], A[I + j + 1]);
    }
#pragma unroll
    for (int k = top + 1; k <= live; k++) A[k] = cc_addc_cc(A[k], 0);
    A[(top > live ? top : live) + 1] = cc_addc(0, 0);
  }
}

// rows I, I + 1, ..., NL - 2 of both accumulators
template <int NL, int I>
__device__ __forceinline__ void cc_cross_rows(uint32_t (&O)[2 * NL], uint32_t (&E)[2 * NL], const uint32_t (&a)[NL]) {
  if constexpr (I < NL - 1) {
    cc_cross_row<NL, 1, I>(O, a);
    cc_cross_row<NL, 0, I>(E, a);
    cc_cross_rows<NL, I + 1>(O, E, a);
  }
}

// Montgomery square a^2 / R mod p on carry chains, equal to fe_sqr bit for
// bit: in [0, 2p) for a^2 < R p
template <int NL>
__device__ __forceinline__ void fe_sqr_cc(uint32_t (&r)[NL], const uint32_t (&a)[NL], const FieldParams<NL>& F) {
  if constexpr (NL == 1) {
    fe_sqr(r, a, F);  // one word: no cross product (see fe_mul_cc)
  } else {
    uint32_t O[2 * NL], E[2 * NL], T[2 * NL];
#pragma unroll
    for (int k = 0; k < 2 * NL; k++) O[k] = E[k] = 0;
    cc_cross_rows<NL, 0>(O, E, a);
    // D = O + E (E has no word below position 2), then T = 2 D
    uint32_t D[2 * NL];
    D[0] = 0;
    D[1] = O[1];
    D[2] = cc_add(O[2], E[2]);
#pragma unroll
    for (int k = 3; k < 2 * NL - 1; k++) D[k] = cc_addc_cc(O[k], E[k]);
    D[2 * NL - 1] = cc_addc(O[2 * NL - 1], E[2 * NL - 1]);
#pragma unroll
    for (int k = 2 * NL - 1; k > 0; k--) T[k] = __funnelshift_l(D[k - 1], D[k], 1);
    // the diagonal: T[0] is 0 before it
    T[0] = cc_mul_lo(a[0], a[0]);
    T[1] = cc_mad_hi(a[0], a[0], T[1]);
#pragma unroll
    for (int k = 1; k < NL; k++) {
      T[2 * k] = cc_madc_lo(a[k], a[k], T[2 * k]);
      T[2 * k + 1] = k < NL - 1 ? cc_madc_hi(a[k], a[k], T[2 * k + 1]) : cc_madc_hi_end(a[k], a[k], T[2 * k + 1]);
    }
    // the reduction rows
    uint32_t L[NL], H[NL], X = 0;
#pragma unroll
    for (int k = 0; k < NL; k++) {
      L[k] = T[k];
      H[k] = 0;
    }
#pragma unroll
    for (int i = 0; i < NL; i++) {
      uint32_t m;
      if (i > 0) {
        // fe_mul_cc's shift, with T's word NL + i - 1 coming in at position
        // NL - 1; L's word 1 is folded into L[0] (m is taken from the sum),
        // its carry into the odd chain
        uint32_t fold = L[1];
#pragma unroll
        for (int k = 0; k < NL; k++) {
          uint32_t h = H[k];
          H[k] = k + 2 < NL ? L[k + 2] : k == NL - 2 ? T[NL + i - 1] : X;
          L[k] = h;
        }
        X = 0;
        m = (L[0] + fold) * F.mu;
        L[0] = cc_add(L[0], fold);
        cc_odd_chain<NL, true>(H, X, F.p, m);
      } else {
        m = L[0] * F.mu;
        cc_odd_chain<NL, false>(H, X, F.p, m);
      }
      cc_even_chain(L, H, X, F.p, m);
    }
    // (L + H w) / w, and T's top word at position NL - 1
    r[0] = cc_add(H[0], L[1]);
#pragma unroll
    for (int k = 1; k < NL - 1; k++) r[k] = cc_addc_cc(H[k], L[k + 1]);
    r[NL - 1] = cc_addc(H[NL - 1], T[2 * NL - 1]);
  }
}

// the carry-chain product and square as a type, for a formula written once
// over its arithmetic (edwards.cuh's ed_add, projective.cuh's rcb_dbl,
// affine.cuh's aff_chord); they agree bit for bit with field.cuh's CIOS
// fe_mul and CIOS-row fe_sqr
struct CarryChainMul {
  template <int NL>
  __device__ static __forceinline__ void mul(uint32_t (&r)[NL], const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                             const FieldParams<NL>& F) {
    fe_mul_cc(r, a, b, F);
  }
  template <int NL>
  __device__ static __forceinline__ void sqr(uint32_t (&r)[NL], const uint32_t (&a)[NL], const FieldParams<NL>& F) {
    fe_sqr_cc(r, a, F);
  }
};
