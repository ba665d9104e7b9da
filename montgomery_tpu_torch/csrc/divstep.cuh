// Constant-iteration safegcd (Bernstein-Yang divsteps) on one lane, shared by
// kernels divstep_inv (csrc/divstep_inv.cu, plain values) and
// divstep_inv_mont (csrc/divstep_inv_mont.cu, Montgomery form).
//
// The safegcd state (f, g) and the mod-p coefficients (d, e) are signed
// numbers of DS_L = ceil(32 NL / 30) limbs of 30 bits (13 limbs, 390 bits at
// NL = 12; 14 limbs, 420 bits at NL = 13; 10 limbs, 300 bits at NL = 9;
// limbs below the top in [0, 2^30), the top limb signed) in int64 registers.
// Divsteps run in batches of 30 on the low 64 bits of f and g, building a
// transition matrix with |u| + |v| <= 2^30; each batch then applies the
// matrix to the full-width numbers with exact division by 2^30 (f, g) or a
// Montgomery-style shift mod p (d, e: add m p so that the low 30 bits
// vanish). 30 x 30-bit products and their 3-term sums stay below 2^62, so
// int64 holds them. The batch count comes from ops/divstep.py:
// ceil(iterations(bits(p)) / 30), 37 for the 377-bit BLS12-377 base field
// (1110 divsteps, BY19 Thm 11.2 bound 1091) and the 381-bit BLS12-381 one
// (bound 1102), 25 for the 253-bit ed-on-bls12-377 base field (bound 733)
// and the 255-bit Pallas one (bound 739). |d|, |e| grow by at most p per
// batch, so the end value lies in (-38p, 38p): add 2^6 p and subtract 2^j p,
// j = 6..0, where each fits (2^7 p < 2^(30 DS_L - 1) at every limb count:
// 388 bits against 419 at NL = 13). The plain version (ops/divstep.py
// inv_plain) runs the same algorithm in torch int64, and the inverse is
// unique, so both agree.
#pragma once
#include "field.cuh"

#define DS_BITS 30
#define DS_MASK ((1ll << DS_BITS) - 1)
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

// canonical 32-bit words (value < 2^(32 NL)) -> 30-bit limbs
template <int NL, int DS_L>
__device__ __forceinline__ void words_to_l30(int64_t (&L)[DS_L], const uint32_t (&w)[NL]) {
#pragma unroll
  for (int i = 0; i < DS_L; i++) {
    int bit = DS_BITS * i, k = bit / 32, s = bit % 32;
    uint64_t v = (uint64_t)w[k] >> s;
    if (k + 1 < NL) v |= (uint64_t)w[k + 1] << (32 - s);
    L[i] = (int64_t)(v & DS_MASK);
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

// 30 divsteps on the low words of f and g: returns delta; (u, v, q, r) with
// 2^30 (f', g') = (u f + v g, q f + r g)
__device__ __forceinline__ int ds_divsteps(int delta, uint64_t fw, uint64_t gw, int64_t& u, int64_t& v,
                                           int64_t& q, int64_t& r) {
  u = 1, v = 0, q = 0, r = 1;
#pragma unroll 6
  for (int k = 0; k < DS_BITS; k++) {
    bool odd = gw & 1;
    bool swap = delta > 0 && odd;
    int64_t nu = swap ? 2 * q : 2 * u;
    int64_t nv = swap ? 2 * r : 2 * v;
    int64_t nq = swap ? q - u : (odd ? q + u : q);
    int64_t nr = swap ? r - v : (odd ? r + v : r);
    uint64_t ng = swap ? (gw - fw) >> 1 : (odd ? gw + fw : gw) >> 1;
    fw = swap ? gw : fw;
    gw = ng;
    delta = swap ? 1 - delta : 1 + delta;
    u = nu, v = nv, q = nq, r = nr;
  }
  return delta;
}

// (f, g) <- (u f + v g, q f + r g) / 2^30, exact
template <int DS_L>
__device__ __forceinline__ void ds_update_fg(int64_t (&f)[DS_L], int64_t (&g)[DS_L], int64_t u, int64_t v,
                                             int64_t q, int64_t r) {
  int64_t cf = (u * f[0] + v * g[0]) >> DS_BITS;
  int64_t cg = (q * f[0] + r * g[0]) >> DS_BITS;
#pragma unroll
  for (int i = 1; i < DS_L; i++) {
    cf += u * f[i] + v * g[i];
    cg += q * f[i] + r * g[i];
    f[i - 1] = cf & DS_MASK;
    g[i - 1] = cg & DS_MASK;
    cf >>= DS_BITS;
    cg >>= DS_BITS;
  }
  f[DS_L - 1] = cf;
  g[DS_L - 1] = cg;
}

// (d, e) <- (u d + v e, q d + r e) / 2^30 mod p: each gets m p added, with m
// chosen so that the low 30 bits vanish
template <int NL, int DS_L>
__device__ __forceinline__ void ds_update_de(int64_t (&d)[DS_L], int64_t (&e)[DS_L], int64_t u, int64_t v,
                                             int64_t q, int64_t r, const DivstepConst<NL>& C) {
  int64_t cd = u * d[0] + v * e[0];
  int64_t ce = q * d[0] + r * e[0];
  int64_t md = (int64_t)((((uint64_t)cd & DS_MASK) * C.pinv) & DS_MASK);
  int64_t me = (int64_t)((((uint64_t)ce & DS_MASK) * C.pinv) & DS_MASK);
  cd = (cd + md * C.p[0]) >> DS_BITS;
  ce = (ce + me * C.p[0]) >> DS_BITS;
#pragma unroll
  for (int i = 1; i < DS_L; i++) {
    cd += u * d[i] + v * e[i] + md * C.p[i];
    ce += q * d[i] + r * e[i] + me * C.p[i];
    d[i - 1] = cd & DS_MASK;
    e[i - 1] = ce & DS_MASK;
    cd >>= DS_BITS;
    ce >>= DS_BITS;
  }
  d[DS_L - 1] = cd;
  e[DS_L - 1] = ce;
}

// t in [0, p) -> t^-1 mod p in [0, p), 0 -> 0: the divsteps, then the signed
// end correction sign(f) d brought into [0, p)
template <int NL>
__device__ __forceinline__ void ds_inverse(uint32_t (&out)[NL], const uint32_t (&t)[NL],
                                           const DivstepConst<NL>& C) {
  constexpr int DS_L = ds_limbs(NL);
  bool zero = true;
#pragma unroll
  for (int k = 0; k < NL; k++) zero = zero && t[k] == 0;

  int64_t f[DS_L], g[DS_L], d[DS_L], e[DS_L];
  words_to_l30(g, t);
#pragma unroll
  for (int k = 0; k < DS_L; k++) {
    f[k] = C.p[k];
    d[k] = 0;
    e[k] = k == 0;
  }
  int delta = 1;
  for (int b = 0; b < C.n_batches; b++) {
    uint64_t fw = (uint64_t)f[0] | ((uint64_t)f[1] << DS_BITS);
    uint64_t gw = (uint64_t)g[0] | ((uint64_t)g[1] << DS_BITS);
    int64_t u, v, q, r;
    delta = ds_divsteps(delta, fw, gw, u, v, q, r);
    ds_update_fg(f, g, u, v, q, r);
    ds_update_de(d, e, u, v, q, r, C);
  }
  // f = +-1 and f = d x mod p: the inverse is sign(f) d, in (-38p, 38p)
  bool fneg = f[DS_L - 1] < 0;
#pragma unroll
  for (int k = 0; k < DS_L; k++) d[k] = (fneg ? -d[k] : d[k]) + C.pk[DS_SHIFTS - 1][k];
  ds_normalize(d);
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
#pragma unroll
  for (int k = 0; k < NL; k++) out[k] = zero ? 0u : out[k];
}

// the DivstepConst<NL> a launch receives from Python as int32 words
template <int NL>
inline DivstepConst<NL> divstep_from(const int32_t* cfg) {
  DivstepConst<NL> C;
  memcpy(&C, cfg, sizeof(C));
  return C;
}
