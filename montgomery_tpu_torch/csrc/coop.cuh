// One Montgomery product computed by a whole warp: the latency-bound
// counterpart of field.cuh's fe_mul, for kernels that carry one or a few
// points through a long serial chain (the window combine, few-lane
// doublings).
//
// fe_mul runs the NL-row CIOS loop in one thread: every row's carry chain
// and every quotient digit wait on the word before, so a product is a
// dependent chain of several hundred instructions (1.75 us a product in a
// chain of dependent products at NL = 12 on an H100, against 0.72 us for
// this one: csrc/rates/mul_latency.cu, chip_smoke.py phase 0). Here lane k
// of the warp owns word k of the double-width product (lanes 0..2NL-1, the
// rest hold zeros) and the product is three carry-free column passes, each
// resolved by one carry resolution:
//   T = a b                    (lane k sums a_i b_{k-i}, lo words at k, hi at k+1)
//   M = (T mod R) mu mod R     (mu = -p^-1 mod R, all NL words; the low half)
//   U = T + M p, result U / R  (words NL..2NL-1)
// A column pass is NL independent 32x32->64 products per lane with the hi
// words moved one lane up by a shuffle; a resolution turns 64-bit column sums
// (below 2^38) into exact words with one shuffle and two ballots (carry
// lookahead over the lane mask). M is the unique value below R with
// a b + M p = 0 mod R, the same M that CIOS builds digit by digit, so the
// result (a b + M p) / R equals fe_mul's bit for bit: in [0, 2p) for
// a b < R p. Operands come from shared memory (any lane may read any word);
// the result goes to shared memory, written by lanes NL..2NL-1, so it may
// alias an operand. Every lane of the warp must call it (full-mask
// shuffles); the caller orders the write before other readers
// (__syncwarp within the warp, __syncthreads across warps).
#pragma once
#include "field.cuh"

#define COOP_FULL 0xFFFFFFFFu

// the constants a cooperating warp reads: p and mu = -p^-1 mod R, NL words
// each, in shared memory
template <int NL>
struct CoopConsts {
  uint32_t p[NL];
  uint32_t mu[NL];
};

__device__ __forceinline__ int warp_lane() { return threadIdx.x & 31; }

// exact word of column `lane` from 64-bit column sums v (column k at lane k,
// each below 2^63): the hi word of each column moves one lane up, then the
// single-bit carries ripple through lanes whose word is all ones, resolved
// at once from the generate and propagate masks (bit k of (G|P) + G ^ (G|P)
// ^ G is the carry into lane k). A carry out of lane 31 is dropped.
__device__ __forceinline__ uint32_t coop_resolve(uint64_t v, int lane) {
  uint32_t w = (uint32_t)v, c = (uint32_t)(v >> 32);
  uint32_t cin = __shfl_up_sync(COOP_FULL, c, 1);
  if (lane == 0) cin = 0;
  uint32_t s = w + cin;
  // s < w on overflow; then s <= cin - 1 < 2^32 - 1, so generate and
  // propagate never hold together
  uint32_t G = __ballot_sync(COOP_FULL, s < w);
  uint32_t P = __ballot_sync(COOP_FULL, s == 0xFFFFFFFFu);
  uint32_t X = G | P;
  uint32_t cy = (X + G) ^ X ^ G;
  return s + ((cy >> lane) & 1u);
}

// column `lane` of x y + acc, x_i given by xi(i), y in shared memory: lo
// words of x_i y_{lane-i} summed at this lane, hi words at the next; only
// lanes below `cols` keep their sum
template <int NL, class XI>
__device__ __forceinline__ uint64_t coop_columns(XI xi, const uint32_t* y, uint64_t acc, int lane,
                                                 int cols) {
  uint64_t lo = acc, hi = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    int j = lane - i;
    bool in = j >= 0 && j < NL;
    uint32_t yj = y[in ? j : 0];
    uint64_t prod = (uint64_t)xi(i) * (in ? yj : 0u);
    lo += (uint32_t)prod;
    hi += prod >> 32;
  }
  uint64_t hin = __shfl_up_sync(COOP_FULL, hi, 1);
  if (lane == 0) hin = 0;
  return lane < cols ? lo + hin : 0;
}

// r = a b / R mod p (Montgomery), a, b, r NL words in shared memory
template <int NL>
__device__ __forceinline__ void coop_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                         const CoopConsts<NL>& C) {
  static_assert(2 * NL <= 32, "one warp holds the double-width product");
  int lane = warp_lane();
  uint32_t t = coop_resolve(coop_columns<NL>([&](int i) { return a[i]; }, b, 0, lane, 2 * NL), lane);
  uint32_t m = coop_resolve(
      coop_columns<NL>([&](int i) { return __shfl_sync(COOP_FULL, t, i); }, C.mu, 0, lane, NL), lane);
  if (lane >= NL) m = 0;  // M = T mu mod R: the carry into lane NL is dropped
  uint32_t u = coop_resolve(
      coop_columns<NL>([&](int i) { return __shfl_sync(COOP_FULL, m, i); }, C.p, t, lane, 2 * NL),
      lane);
  if (lane >= NL && lane < 2 * NL) r[lane - NL] = u;
}

// a shared-memory slot to registers and back, for the additions that one
// lane runs between the stages of a cooperative formula
template <int NL>
__device__ __forceinline__ void sm_get(uint32_t (&r)[NL], const uint32_t* a) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = a[k];
}

template <int NL>
__device__ __forceinline__ void sm_put(uint32_t* r, const uint32_t (&a)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = a[k];
}

// the field constants into shared memory, by the block's first thread
template <int NL>
__device__ __forceinline__ void coop_load_consts(CoopConsts<NL>& C, const FieldParams<NL>& F,
                                                 const Fe<NL>& mu) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NL; k++) {
      C.p[k] = F.p[k];
      C.mu[k] = mu.v[k];
    }
  }
}
