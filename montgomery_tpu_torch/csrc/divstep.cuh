// Safegcd (Bernstein-Yang divsteps) on the H100's 32-bit integer pipe,
// shared by kernels divstep_inv (csrc/divstep_inv.cu, plain values, one
// thread a lane) and divstep_inv_mont (csrc/divstep_inv_mont.cu, Montgomery
// form, one warp a lane).
//
// Replaces the core both kernels were first ported on: 64-bit divsteps on
// words built from two limbs, the matrix and the limbs in int64
// (every select and add a pair of instructions with a carry between them,
// every product a multi-IMAD 64 x 64 product), and always the proven 37
// batches (25 at 253-255 bits). The layout follows libsecp256k1's modinv32.
//
// Numbers. The safegcd state (f, g) and the mod-p coefficients (d, e) are
// signed numbers of DS_L = ceil(32 NL / 30) limbs of 30 bits (13 limbs at
// NL = 12, 14 at NL = 13, 10 at NL = 9; 2, 3 and 4 at NL = 1, 2, 3) held in
// int32. A batch runs 30
// divsteps on the low 32-bit words of f and g (f mod 2^30 is limb 0 mod 2^30
// however the higher limbs are carried), with u, v, q, r in 32 bits
// (ds_divsteps, branch-free, in divstep_inv_mont's warps; ds_divsteps_var,
// libsecp256k1's variable-time form with the same result, in divstep_inv's
// threads: 0.49 against 0.55 us a batch in one thread, 331 against 382-395
// us a launch at 2^18, but 24.2 against 23.0 us a launch on the warps), and
// then applies the matrix to the full-width numbers: (f, g) <- (u f + v g,
// q f + r g) / 2^30 exactly, (d, e) <- (u d + v e + m p) / 2^30, m < 2^30
// chosen so that the low 30 bits vanish. Each product is (int64_t)a * b of
// two int32 (one IMAD.WIDE), each sum int64.
//
// Bounds (tests/test_torch_divstep.py checks each on the plain version,
// ops/divstep.py, which runs this same arithmetic):
//   - 30 divsteps give |u| + |v| <= 2^30 and |q| + |r| <= 2^30 (by
//     induction: a step maps the rows to (2u, 2v) or (2q, 2r), and (q, r)
//     to (q, r) or (q +- u, r +- v)); so |u|, |v|, |q|, |r| <= 2^30 < 2^31.
//   - The warp's carry scheme (ds_shift_warp) keeps every limb below the top
//     in [-2, 2^30 + 1] and limb 0 in [0, 2^30) between
//     batches; the one-thread kernel carries fully, limbs below the top in
//     [0, 2^30), inside the same range.
//   - A limb's sum |u a + v b| + m p_j <= 2^30 (2^30 + 1) + (2^30 - 1)^2
//     < 2^61: int64 holds it. Its high part s >> 30 lies in
//     [-(2^30 + 1), 2^31 - 1]; with the 30 low bits of the lane above it
//     lies in [-(2^30 + 1), 3 2^30 - 2], so the second carry round moves
//     -2 .. 2 and the limb lands in [-2, 2^30 + 1] again.
//   - |f|, |g| <= p at every batch (a divstep never raises max(|f|, |g|)),
//     and |d|, |e| <= 1 + b p after b batches (m p / 2^30 < p). The top limb
//     is within 2 of the value over 2^(30 (DS_L - 1)) (the limbs below sum to
//     less than 2^(30 (DS_L - 1)) + 2^(30 (DS_L - 1) - 29) in magnitude):
//     below 2^24 at every limb count, so int32 holds it.
//   - After at most n_batches = ceil(iterations(bits(p)) / 30) batches
//     (BY19 Thm 11.2: 37 for the 377- and 381-bit fields, 25 for the 253-
//     and 255-bit ones; 1, 4 and 7 for the 7-, 31- and 64-bit small,
//     babybear and goldilocks) g = 0 and f = +-1, so sign(f) d = x^-1 mod p lies
//     in (-38p, 38p); the end adds 2^6 p and subtracts 2^j p, j = 6..0, where
//     it fits (DS_SHIFTS; 2^7 p < 2^(30 DS_L - 1): 388 bits against 419 at
//     NL = 13, 71 against 119 at goldilocks, 14 against 59 at p = 101).
//
// The exit. Once g = 0 every later divstep takes the even branch: the
// matrix is diag(2^30, 1), m = 0, and f, d stay as they are. So the batch
// loop ends once g = 0 (a warp votes with __all_sync), capped at n_batches.
// The test is on the value: the warp's limbs can write 0 as a carry chain
// (2^30, 2^30 - 1, ..., -1), which a test of the limbs alone would miss for
// up to DS_L batches (ds_is_zero_warp resolves the chain). A missed zero
// would cost batches, never change the result.
#pragma once
#include "coop.cuh"

#define DS_BITS 30
#define DS_MASK ((1 << DS_BITS) - 1)
#define DS_SHIFTS 7

// 30-bit limbs that hold NL words of 32 bits
__host__ __device__ constexpr int ds_limbs(int NL) { return (32 * NL + DS_BITS - 1) / DS_BITS; }

template <int NL>
struct DivstepConst {  // layout of ops/divstep.py DivstepParams.kernel_words
  int32_t p[ds_limbs(NL)];                // p in 30-bit limbs
  int32_t pk[DS_SHIFTS][ds_limbs(NL)];    // 2^j p, j < DS_SHIFTS
  uint32_t r2[NL];                        // R^2 mod p in 32-bit words
  uint32_t pinv;                          // -p^-1 mod 2^30
  int32_t n_batches;
};

// the transition matrix of 30 divsteps: 2^30 (f', g') = (u f + v g, q f + r g)
struct DsMatrix {
  int32_t u, v, q, r;
};

// canonical 32-bit words (value < 2^(32 NL)) -> 30-bit limbs
template <int NL, int DS_L>
__device__ __forceinline__ void words_to_l30(int32_t (&out)[DS_L], const uint32_t (&w)[NL]) {
#pragma unroll
  for (int i = 0; i < DS_L; i++) {
    int bit = DS_BITS * i, k = bit / 32, s = bit % 32;
    uint64_t v = (uint64_t)w[k] >> s;
    if (k + 1 < NL) v |= (uint64_t)w[k + 1] << (32 - s);
    out[i] = (int32_t)(v & DS_MASK);
  }
}

// non-negative 30-bit limbs (value < 2^(32 NL)) -> 32-bit words
template <int NL, int DS_L>
__device__ __forceinline__ void l30_to_words(uint32_t (&w)[NL], const int64_t (&L)[DS_L]) {
#pragma unroll
  for (int k = 0; k < NL; k++) {
    int bit = 32 * k, i = bit / DS_BITS, s = bit % DS_BITS;
    uint64_t v = (uint64_t)L[i] >> s;
    if (i + 1 < DS_L) v |= (uint64_t)L[i + 1] << (DS_BITS - s);
    w[k] = (uint32_t)v;
  }
}

// signed limbs -> limbs below the top in [0, 2^30), the top limb signed
template <int DS_L>
__device__ __forceinline__ void ds_normalize(int64_t (&L)[DS_L]) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < DS_L - 1; i++) {
    int64_t v = L[i] + c;
    L[i] = v & DS_MASK;
    c = v >> DS_BITS;
  }
  L[DS_L - 1] += c;
}

// 30 divsteps on the low words of f (odd) and g; zeta = -delta. A divstep:
//   delta > 0 and g odd: (delta, f, g) <- (1 - delta, g, (g - f) / 2)
//   otherwise:           (delta, f, g) <- (1 + delta, f, (g + (g & 1) f) / 2)
// in libsecp256k1's branch-free form: negate f, u, v where delta > 0, add
// them to g, q, r where g is odd, then on a swap add the new g, q, r back to
// f, u, v (f + (g - f) = g). Words and matrix wrap mod 2^32; the matrix's
// entries end within +-2^30, so their int32 values are exact.
__device__ __forceinline__ int32_t ds_divsteps(int32_t zeta, uint32_t f, uint32_t g, DsMatrix& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int k = 0; k < DS_BITS; k++) {
    uint32_t m1 = (uint32_t)(zeta >> 31);  // delta > 0
    uint32_t m2 = 0u - (g & 1u);           // g odd
    uint32_t x = (f ^ m1) - m1, y = (u ^ m1) - m1, z = (v ^ m1) - m1;
    g += x & m2;
    q += y & m2;
    r += z & m2;
    m1 &= m2;  // the swap
    zeta = m1 ? ~zeta : zeta - 1;  // -(1 - delta) or -(1 + delta)
    f += g & m1;
    u += q & m1;
    v += r & m1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = {(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// The same 30 divsteps in variable time (libsecp256k1's divsteps_30_var),
// in divstep_inv's threads (the lanes of a warp diverge: the warp runs the
// most rounds of its lanes): a run of zeros of g is done at once (g
// halves, u and v double, delta grows), a swap (delta > 0, g odd) becomes
// (f, g) <- (g, -f) with delta negated, and then up to DS_VAR_BITS odd
// non-swap steps at once, g += w f with w = -g f^-1 mod 2^limit (f^-1 mod
// 2^6 = f (2 - f^2): f^2 = 1 mod 8 for f odd), limit <= 1 - delta so that
// delta stays <= 0 through them. The matrix and zeta equal ds_divsteps'.
// About 7.7 rounds of the loop a batch (at most 14, BLS12-377).
#define DS_VAR_BITS 6
__device__ __forceinline__ int32_t ds_divsteps_var(int32_t zeta, uint32_t f, uint32_t g, DsMatrix& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = DS_BITS;
  for (;;) {
    int zeros = __ffs(g | (0xFFFFFFFFu << i)) - 1;  // at most i
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    zeta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (zeta < 0) {  // delta > 0 and g odd
      uint32_t tmp = f;
      zeta = -zeta;
      f = g;
      g = 0u - tmp;
      tmp = u;
      u = q;
      q = 0u - tmp;
      tmp = v;
      v = r;
      r = 0u - tmp;
    }
    int limit = min(min(zeta + 1, i), DS_VAR_BITS);
    uint32_t w = (0u - g * (f * (2u - f * f))) & ((1u << limit) - 1u);
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t = {(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// the quotient digit m < 2^30 with s + m p = 0 mod 2^30, from s's low limb
// s0 (mod 2^32 suffices)
__device__ __forceinline__ int32_t ds_digit(uint32_t s0, uint32_t pinv) {
  return (int32_t)(((s0 & DS_MASK) * pinv) & DS_MASK);
}

// ---------------------------------------------- one thread a lane (divstep_inv)

// (f, g) <- (u f + v g, q f + r g) / 2^30, exact; full carries, limbs below
// the top in [0, 2^30)
template <int DS_L>
__device__ __forceinline__ void ds_update_fg(int32_t (&f)[DS_L], int32_t (&g)[DS_L], const DsMatrix& t) {
  int64_t cf = ((int64_t)t.u * f[0] + (int64_t)t.v * g[0]) >> DS_BITS;
  int64_t cg = ((int64_t)t.q * f[0] + (int64_t)t.r * g[0]) >> DS_BITS;
#pragma unroll
  for (int i = 1; i < DS_L; i++) {
    cf += (int64_t)t.u * f[i] + (int64_t)t.v * g[i];
    cg += (int64_t)t.q * f[i] + (int64_t)t.r * g[i];
    f[i - 1] = (int32_t)cf & DS_MASK;
    g[i - 1] = (int32_t)cg & DS_MASK;
    cf >>= DS_BITS;
    cg >>= DS_BITS;
  }
  f[DS_L - 1] = (int32_t)cf;
  g[DS_L - 1] = (int32_t)cg;
}

// (d, e) <- (u d + v e + md p, q d + r e + me p) / 2^30, full carries
template <int NL, int DS_L>
__device__ __forceinline__ void ds_update_de(int32_t (&d)[DS_L], int32_t (&e)[DS_L], const DsMatrix& t,
                                             const DivstepConst<NL>& C) {
  int64_t cd = (int64_t)t.u * d[0] + (int64_t)t.v * e[0];
  int64_t ce = (int64_t)t.q * d[0] + (int64_t)t.r * e[0];
  int32_t md = ds_digit((uint32_t)cd, C.pinv), me = ds_digit((uint32_t)ce, C.pinv);
  cd = (cd + (int64_t)md * C.p[0]) >> DS_BITS;
  ce = (ce + (int64_t)me * C.p[0]) >> DS_BITS;
#pragma unroll
  for (int i = 1; i < DS_L; i++) {
    cd += (int64_t)t.u * d[i] + (int64_t)t.v * e[i] + (int64_t)md * C.p[i];
    ce += (int64_t)t.q * d[i] + (int64_t)t.r * e[i] + (int64_t)me * C.p[i];
    d[i - 1] = (int32_t)cd & DS_MASK;
    e[i - 1] = (int32_t)ce & DS_MASK;
    cd >>= DS_BITS;
    ce >>= DS_BITS;
  }
  d[DS_L - 1] = (int32_t)cd;
  e[DS_L - 1] = (int32_t)ce;
}

// the end: f = +-1 (its low limb 1 or 2^30 - 1) and f = d x mod p, so the
// inverse is sign(f) d, in (-38p, 38p): add 2^6 p, subtract each 2^j p that
// fits, and return the value's NL words
template <int NL, int DS_L>
__device__ __forceinline__ void ds_finish(uint32_t (&out)[NL], int64_t (&d)[DS_L], bool fneg,
                                          const DivstepConst<NL>& C) {
#pragma unroll
  for (int k = 0; k < DS_L; k++) d[k] = (fneg ? -d[k] : d[k]) + C.pk[DS_SHIFTS - 1][k];
  ds_normalize(d);
#pragma unroll
  for (int j = DS_SHIFTS - 1; j >= 0; j--) {
    int64_t s[DS_L];
#pragma unroll
    for (int k = 0; k < DS_L; k++) s[k] = d[k] - C.pk[j][k];
    ds_normalize(s);
    bool ge = s[DS_L - 1] >= 0;
#pragma unroll
    for (int k = 0; k < DS_L; k++) d[k] = ge ? s[k] : d[k];
  }
  l30_to_words(out, d);
}

// t in [0, p) -> t^-1 mod p in [0, p), 0 -> 0, in one thread. Every thread
// of the warp must call it: the batch loop ends once g = 0 on all 32 lanes.
template <int NL>
__device__ __forceinline__ void ds_inverse(uint32_t (&out)[NL], const uint32_t (&t)[NL],
                                           const DivstepConst<NL>& C) {
  constexpr int DS_L = ds_limbs(NL);
  int32_t f[DS_L], g[DS_L], d[DS_L], e[DS_L];
  words_to_l30(g, t);
#pragma unroll
  for (int k = 0; k < DS_L; k++) {
    f[k] = C.p[k];
    d[k] = 0;
    e[k] = k == 0;
  }
  int32_t zeta = -1;  // delta = 1
  for (int b = 0; b < C.n_batches; b++) {
    int32_t any = 0;
#pragma unroll
    for (int k = 0; k < DS_L; k++) any |= g[k];
    if (__all_sync(COOP_FULL, any == 0)) break;
    DsMatrix m;
    zeta = ds_divsteps_var(zeta, (uint32_t)f[0], (uint32_t)g[0], m);
    ds_update_fg(f, g, m);
    ds_update_de(d, e, m, C);
  }
  int64_t L[DS_L];
#pragma unroll
  for (int k = 0; k < DS_L; k++) L[k] = d[k];
  ds_finish(out, L, f[0] != 1, C);  // t = 0: g = 0 from the start, d = 0, out = 0
}

// ------------------------------------------- one warp a lane (divstep_inv_mont)

// s / 2^30 with one limb a lane: lane j holds limb j of a sum s (j < DS_L;
// the lanes above hold 0). The lane above hands down its low 30 bits, the
// high part s >> 30 stays, and a second carry round hands each lane's bits
// above 30 up: the limbs below the top land in [-2, 2^30 + 1], limb 0 in
// [0, 2^30); the top keeps its sign. Lane 0's low 30 bits are dropped: the
// division is exact.
template <int DS_L>
__device__ __forceinline__ int32_t ds_shift_warp(int64_t s, int j) {
  int32_t above = __shfl_down_sync(COOP_FULL, (int32_t)s & DS_MASK, 1);
  int64_t t = (s >> DS_BITS) + (j < DS_L - 1 ? above : 0);
  int32_t cin = __shfl_up_sync(COOP_FULL, (int32_t)(t >> DS_BITS), 1);
  int32_t limb = j < DS_L - 1 ? ((int32_t)t & DS_MASK) : (int32_t)t;
  return j == 0 ? limb : j < DS_L ? limb + cin : 0;
}

// g = 0 as a value, limb j of g at lane j (limbs below the top in
// [-2, 2^30 + 1]): a zero carries 1 out of a limb 2^30 (generate) and on
// through limbs 2^30 - 1 (propagate), resolved at once over the lane masks
// as in coop_resolve; then every limb below the top plus its carry is 0 or
// 2^30 and the top plus its carry is 0. The same answer on every lane.
template <int DS_L>
__device__ __forceinline__ bool ds_is_zero_warp(int32_t g, int j) {
  uint32_t G = __ballot_sync(COOP_FULL, g == (1 << DS_BITS));
  uint32_t X = G | __ballot_sync(COOP_FULL, g == DS_MASK);
  int32_t s = g + (int32_t)((((X + G) ^ X ^ G) >> j) & 1u);
  return __all_sync(COOP_FULL, j < DS_L - 1 ? s == 0 || s == (1 << DS_BITS) : j > DS_L - 1 || s == 0);
}

// one batch on the warp, lane j holding limb j of f, g, d, e and of p (pj):
// every lane runs the same 30 branch-free divsteps on limb 0's words (the
// variable-time ones were slower here: a warp's loop of data-dependent
// length adds its branches to the chain) and forms the same
// digits md, me from limbs 0 of d and e (broadcast with f's and g's before
// the divsteps, so no shuffle waits on them after), then its own limb's
// products. Returns zeta.
template <int NL>
__device__ __forceinline__ int32_t ds_batch_warp(int32_t zeta, int32_t& f, int32_t& g, int32_t& d, int32_t& e,
                                                 int32_t pj, uint32_t pinv, int j) {
  constexpr int DS_L = ds_limbs(NL);
  uint32_t f0 = __shfl_sync(COOP_FULL, f, 0), g0 = __shfl_sync(COOP_FULL, g, 0);
  int32_t d0 = __shfl_sync(COOP_FULL, d, 0), e0 = __shfl_sync(COOP_FULL, e, 0);
  DsMatrix t;
  zeta = ds_divsteps(zeta, f0, g0, t);
  int32_t md = ds_digit((uint32_t)t.u * d0 + (uint32_t)t.v * e0, pinv);
  int32_t me = ds_digit((uint32_t)t.q * d0 + (uint32_t)t.r * e0, pinv);
  int64_t sf = (int64_t)t.u * f + (int64_t)t.v * g;
  int64_t sg = (int64_t)t.q * f + (int64_t)t.r * g;
  int64_t sd = (int64_t)t.u * d + (int64_t)t.v * e + (int64_t)md * pj;
  int64_t se = (int64_t)t.q * d + (int64_t)t.r * e + (int64_t)me * pj;
  f = ds_shift_warp<DS_L>(sf, j);
  g = ds_shift_warp<DS_L>(sg, j);
  d = ds_shift_warp<DS_L>(sd, j);
  e = ds_shift_warp<DS_L>(se, j);
  return zeta;
}

// limb j of p for lane j (0 above the top), without indexing the parameter
// bank by a register
template <int NL>
__device__ __forceinline__ int32_t ds_lane_p(const DivstepConst<NL>& C, int j) {
  int32_t pj = 0;
#pragma unroll
  for (int k = 0; k < ds_limbs(NL); k++) pj = j == k ? C.p[k] : pj;
  return pj;
}

// the end on a warp: every lane gathers d's limbs and forms V = sign(f) d +
// 2^6 p in [0, 2^7 p) in 30-bit limbs (one serial carry pass), then its
// own word of V (lane k < NL, word k; pk: word k of p); the subtractions of
// 2^j p, j = 6..0, where they fit run a word a lane, each borrow chain
// resolved at once over the lane masks as in coop_resolve (generate: word
// below the subtrahend's; propagate: equal), the last borrow deciding.
// Returns lane k's word of sign(f) d mod p (0 above NL).
template <int NL>
__device__ __forceinline__ uint32_t ds_finish_warp(int32_t f, int32_t d, uint32_t pk, const DivstepConst<NL>& C) {
  constexpr int DS_L = ds_limbs(NL);
  int k = warp_lane();
  bool fneg = __shfl_sync(COOP_FULL, f, 0) != 1;  // f = +-1: its low limb is 1 or 2^30 - 1
  int64_t L[DS_L];
#pragma unroll
  for (int i = 0; i < DS_L; i++) {
    int64_t di = __shfl_sync(COOP_FULL, d, i);
    L[i] = (fneg ? -di : di) + C.pk[DS_SHIFTS - 1][i];
  }
  ds_normalize(L);
  uint32_t w[NL], x = 0;
  l30_to_words(w, L);
#pragma unroll
  for (int i = 0; i < NL; i++) x = k == i ? w[i] : x;
  uint32_t below = __shfl_up_sync(COOP_FULL, pk, 1);
  if (k == 0) below = 0;
#pragma unroll
  for (int j = DS_SHIFTS - 1; j >= 0; j--) {
    uint32_t y = j ? (pk << j) | (below >> (32 - j)) : pk;  // word k of 2^j p
    uint32_t G = __ballot_sync(COOP_FULL, x < y);
    uint32_t X = G | __ballot_sync(COOP_FULL, k < NL && x == y);
    uint32_t b = (X + G) ^ X ^ G;  // bit i: the borrow into word i
    if (!((b >> NL) & 1)) x = x - y - ((b >> k) & 1);
  }
  return k < NL ? x : 0;
}

// t (NL words in shared memory, every lane may read them) in [0, p) ->
// t^-1 mod p in [0, p), 0 -> 0, on one warp; `zero` makes g = 0. Lane k < NL
// holds word k of p in pk and gets word k of the inverse.
template <int NL>
__device__ __forceinline__ uint32_t ds_inverse_warp(const uint32_t* t, bool zero, uint32_t pk,
                                                    const DivstepConst<NL>& C) {
  constexpr int DS_L = ds_limbs(NL);
  int j = warp_lane();
  int32_t pj = ds_lane_p(C, j);
  int32_t g = 0;
  if (j < DS_L && !zero) {
    int bit = DS_BITS * j, k = bit / 32, s = bit % 32;
    uint64_t v = (uint64_t)t[k] >> s;
    if (k + 1 < NL) v |= (uint64_t)t[k + 1] << (32 - s);
    g = (int32_t)(v & DS_MASK);
  }
  int32_t f = pj, d = 0, e = j == 0;
  int32_t zeta = -1;  // delta = 1
  for (int b = 0; b < C.n_batches && !ds_is_zero_warp<DS_L>(g, j); b++)
    zeta = ds_batch_warp<NL>(zeta, f, g, d, e, pj, C.pinv, j);
  return ds_finish_warp(f, d, pk, C);
}

// the DivstepConst<NL> a launch receives from Python as int32 words
template <int NL>
inline DivstepConst<NL> divstep_from(const int32_t* cfg) {
  DivstepConst<NL> C;
  memcpy(&C, cfg, sizeof(C));
  return C;
}
