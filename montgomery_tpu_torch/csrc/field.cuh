// Montgomery field arithmetic on 32-bit limbs held in registers.
//
// Replaces the limb-plane formulas that montgomery_tpu/ops/field.py inlines
// into every Pallas kernel (FieldOps.add/_sub_limbs/add_lazy/sub_lazy/sub/
// reduce and the Montgomery product _mul_dot + _mont_reduce_wide). There a
// field element was rows of 13-bit limbs in int32 lanes; here it is NL words
// of 32 bits in one thread's registers, and R = 2^(32 NL) > 64p. Everything
// is a template over the limb count NL, the least with R > 64p for the
// field: NL = 12 for the 377-bit BLS12-377 base field (R = 2^384, R/p about
// 2^7); NL = 13 for the 381-bit BLS12-381 base field (2^384 / p is only
// about 2^3.3, so R = 2^416, R/p about 2^35); NL = 9 for the 255-bit Pallas
// base field (R = 2^288, R/p about 2^34) and for ed-on-bls12-377's, the
// 253-bit BLS12-377 scalar field (R/p about 2^35); the field kernels also
// take NL = 1, 2 and 3 for the example fields small (p = 101: R = 2^32, R/p
// about 2^25.3), babybear (2^31 - 1: R = 2^64, R/p about 2^33) and
// goldilocks (2^64 - 2^32 + 1: R = 2^96, R/p about 2^32). At NL = 1 every
// loop over the words above the first (j = 1 .. NL - 1, i + 1 .. NL - 1) is
// empty: fe_mul is one product and one quotient row, fe_sqr one square and
// one reduction row, and the bounds below hold as written. A kernel file
// instantiates the counts its entry points serve.
//
// Bound on this card: 32-bit integer multiply throughput (IMAD.WIDE / IMAD.HI)
// and register pressure; one product is 2 NL^2 32x32->64 multiplies (288 at
// NL = 12, 338 at NL = 13, 162 at NL = 9). Design: CIOS with 64-bit products
// and the reduction interleaved per row, so the working set is NL + 2 words;
// every loop is fully unrolled so the limbs stay in registers and the modulus
// words are read from the kernel's parameter bank. Carry chains through PTX
// add.cc/mad.cc are later work.
//
// Bounds match the plain versions (ops/field.py Plain16): fe_mul's result is
// (a b + m p) / R < a b / R + p, so it lies in [0, 2p) whenever a b < R p;
// with R > 64p that holds for inputs up to 8p (the lazy sums of the curve
// formulas stay below it). Other outputs are in [0, 2p) as noted.
#pragma once
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

template <int NL>
struct FieldParams {  // layout of FieldOps.field_words
  uint32_t p[NL];
  uint32_t p2[NL];
  uint32_t p4[NL];
  uint32_t mu;  // -p^-1 mod 2^32
};

template <int NL>
struct Fe {
  uint32_t v[NL];
};

// limb k of lane i sits at plane[k * stride + i]; stride is the lane count
// N for a whole plane, or the parent's for a column slice of a wider plane
template <int NL>
__device__ __forceinline__ void fe_load(uint32_t (&r)[NL], const int32_t* plane, int stride, int i) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = (uint32_t)plane[(size_t)k * stride + i];
}

template <int NL>
__device__ __forceinline__ void fe_store(int32_t* plane, int stride, int i, const uint32_t (&a)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; k++) plane[(size_t)k * stride + i] = (int32_t)a[k];
}

// r = a + b mod 2^(32 NL); returns the carry out
template <int NL>
__device__ __forceinline__ uint32_t limbs_add(uint32_t (&r)[NL], const uint32_t (&a)[NL],
                                              const uint32_t (&b)[NL]) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < NL; k++) {
    uint64_t s = (uint64_t)a[k] + b[k] + c;
    r[k] = (uint32_t)s;
    c = s >> 32;
  }
  return (uint32_t)c;
}

// r = a - b mod 2^(32 NL); returns 1 on borrow (a < b)
template <int NL>
__device__ __forceinline__ uint32_t limbs_sub(uint32_t (&r)[NL], const uint32_t (&a)[NL],
                                              const uint32_t (&b)[NL]) {
  uint32_t br = 0;
#pragma unroll
  for (int k = 0; k < NL; k++) {
    uint64_t d = (uint64_t)a[k] - b[k] - br;
    r[k] = (uint32_t)d;
    br = (uint32_t)(d >> 63);
  }
  return br;
}

// r = a b, the whole NA + NB word product (operand scanning: row i adds
// a_i b at word offset i; s below 2^64 since (2^32 - 1)^2 + 2 (2^32 - 1)
// = 2^64 - 1)
template <int NA, int NB>
__device__ __forceinline__ void limbs_mul_wide(uint32_t (&r)[NA + NB], const uint32_t (&a)[NA],
                                               const uint32_t (&b)[NB]) {
#pragma unroll
  for (int k = 0; k < NA + NB; k++) r[k] = 0;
#pragma unroll
  for (int i = 0; i < NA; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NB; j++) {
      uint64_t s = (uint64_t)r[i + j] + (uint64_t)a[i] * b[j] + c;
      r[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    r[i + NB] = (uint32_t)c;
  }
}

template <int NL>
__device__ __forceinline__ void fe_select(uint32_t (&r)[NL], bool c, const uint32_t (&a)[NL],
                                          const uint32_t (&b)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = c ? a[k] : b[k];
}

// x + y reduced into [0, 2p) for x, y in [0, 2p)
template <int NL>
__device__ __forceinline__ void fe_add(uint32_t (&r)[NL], const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                       const FieldParams<NL>& F) {
  uint32_t z[NL], d[NL];
  limbs_add(z, a, b);
  uint32_t br = limbs_sub(d, z, F.p2);
  fe_select(r, br, z, d);
}

// x + y, no reduction
template <int NL>
__device__ __forceinline__ void fe_add_lazy(uint32_t (&r)[NL], const uint32_t (&a)[NL],
                                            const uint32_t (&b)[NL]) {
  limbs_add(r, a, b);
}

// x - y + 4p, no reduction; y < 4p
template <int NL>
__device__ __forceinline__ void fe_sub_lazy(uint32_t (&r)[NL], const uint32_t (&a)[NL],
                                            const uint32_t (&b)[NL], const FieldParams<NL>& F) {
  uint32_t t[NL];
  limbs_add(t, a, F.p4);
  limbs_sub(r, t, b);
}

// x - y mod 2p, in [0, 2p)
template <int NL>
__device__ __forceinline__ void fe_sub(uint32_t (&r)[NL], const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                       const FieldParams<NL>& F) {
  uint32_t d[NL], d2[NL];
  uint32_t br = limbs_sub(d, a, b);
  limbs_add(d2, d, F.p2);
  fe_select(r, br, d2, d);
}

// 2p - x reduced into [0, 2p) for x in [0, 2p); zero stays zero
template <int NL>
__device__ __forceinline__ void fe_neg(uint32_t (&r)[NL], const uint32_t (&a)[NL], const FieldParams<NL>& F) {
  uint32_t d[NL], d2[NL];
  limbs_sub(d, F.p2, a);
  uint32_t br = limbs_sub(d2, d, F.p2);
  fe_select(r, br, d, d2);
}

// Montgomery product a b / R mod p (CIOS), in [0, 2p) for a b < R p
template <int NL>
__device__ __forceinline__ void fe_mul(uint32_t (&r)[NL], const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                       const FieldParams<NL>& F) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int k = 0; k < NL + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a[j] * b[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NL] + c;
    t[NL] = (uint32_t)s;
    t[NL + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F.mu;
    c = ((uint64_t)t[0] + (uint64_t)m * F.p[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; j++) {
      uint64_t u = (uint64_t)t[j] + (uint64_t)m * F.p[j] + c;
      t[j - 1] = (uint32_t)u;
      c = u >> 32;
    }
    s = (uint64_t)t[NL] + c;
    t[NL - 1] = (uint32_t)s;
    t[NL] = t[NL + 1] + (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = t[k];
}

// [0, 2p) -> [0, p) by one conditional subtract
template <int NL>
__device__ __forceinline__ void fe_reduce(uint32_t (&r)[NL], const uint32_t (&a)[NL],
                                          const FieldParams<NL>& F) {
  uint32_t d[NL];
  uint32_t br = limbs_sub(d, a, F.p);
  fe_select(r, br, a, d);
}

// x == y as field elements, for x, y in [0, 2p)
template <int NL>
__device__ __forceinline__ bool fe_is_equal(const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                            const FieldParams<NL>& F) {
  uint32_t ra[NL], rb[NL];
  fe_reduce(ra, a, F);
  fe_reduce(rb, b, F);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < NL; k++) diff |= ra[k] ^ rb[k];
  return diff == 0;
}

template <int NL>
__device__ __forceinline__ bool fe_is_zero(const uint32_t (&a)[NL], const FieldParams<NL>& F) {
  uint32_t ra[NL];
  fe_reduce(ra, a, F);
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < NL; k++) acc |= ra[k];
  return acc == 0;
}

// Montgomery square a^2 / R mod p, equal to fe_mul(a, a) bit for bit (the
// quotient m < R with a^2 + m p = 0 mod R is unique, and neither ends in a
// conditional subtract). The product shares its cross terms: NL(NL-1)/2
// products a_i a_j (i < j), doubled, plus NL squares a_i^2 (78 in all at
// NL = 12, against 144 for fe_mul's); then the NL-row Montgomery reduction
// (SOS), whose carry out of each row rides in `extra` into the next row's top
// word. In [0, 2p) for a^2 < R p.
template <int NL>
__device__ __forceinline__ void fe_sqr(uint32_t (&r)[NL], const uint32_t (&a)[NL], const FieldParams<NL>& F) {
  uint32_t t[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NL; j++) {
      uint64_t s = (uint64_t)t[i + j] + (uint64_t)a[i] * a[j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + NL] = (uint32_t)c;
  }
  // double the cross terms (their sum is below a^2 / 2 < 2^(64 NL - 1))
#pragma unroll
  for (int k = 2 * NL - 1; k > 0; k--) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t sq = (uint64_t)a[i] * a[i];
    uint64_t s = (uint64_t)t[2 * i] + (uint32_t)sq + c;
    t[2 * i] = (uint32_t)s;
    s = (uint64_t)t[2 * i + 1] + (sq >> 32) + (s >> 32);
    t[2 * i + 1] = (uint32_t)s;
    c = s >> 32;
  }
  uint32_t extra = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint32_t m = t[i] * F.mu;
    c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      uint64_t s = (uint64_t)t[i + j] + (uint64_t)m * F.p[j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + NL] + c + extra;
    t[i + NL] = (uint32_t)s;
    extra = (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = t[NL + k];
}

__device__ __forceinline__ int lane_index() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

#define LANES_PER_BLOCK 128

// The build compiles a source with entry points at several limb counts once
// per count, with -DMSM_LIMBS=n, so that each nvcc process instantiates the
// kernels of one count (ops/kernels.py); without it, a source instantiates
// every count it has. Each entry point sits under #if MSM_AT(its count).
#ifndef MSM_LIMBS
#define MSM_LIMBS 0
#endif
#define MSM_AT(n) (MSM_LIMBS == 0 || MSM_LIMBS == (n))

inline int grid_for(int N) { return (N + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK; }

// the FieldParams<NL> a launch receives from Python as NL * 3 + 1 words
template <int NL>
inline FieldParams<NL> field_from(const uint32_t* words) {
  FieldParams<NL> F;
  memcpy(&F, words, sizeof(F));
  return F;
}

template <int NL>
inline Fe<NL> fe_from(const uint32_t* words) {
  Fe<NL> c;
  memcpy(c.v, words, sizeof(c.v));
  return c;
}
