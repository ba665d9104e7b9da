// The body that csrc/exp_ladder.cu replaced: x^e on fixed 2-bit digits, the
// table {x, x^2, x^3} in registers, two squarings a digit on field.cuh's
// CIOS fe_sqr and a product on fe_mul unless the digit is 0 (the kernel
// before the sliding window, unchanged). Kept as a probe: chip_smoke.py
// builds it beside the kernels' library, once per limb count, and times it
// in turns with the sliding-window kernel. Its entry points take
// exp_ladder's arguments (the schedule's steps, their count, the table's
// entries, the field words, the lane count) and rebuild e from the steps on
// the host (e = e 2^s + d for each step (s, d)), so they can stand in for
// the kernel's entry points. Each runs its own sequence of products, so its
// output equals the kernel's as a field element, not always as the same
// representative in [0, 2p).
#include "../field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
exp_ladder_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, Fe<NL> e, int nd,
                  FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], x2[NL], x3[NL], acc[NL], sel[NL];
  fe_load(x1, x, N, i);
  fe_mul(x2, x1, x1, F);
  fe_mul(x3, x2, x1, F);
  int d = (e.v[(nd - 1) >> 4] >> (2 * ((nd - 1) & 15))) & 3;  // the leading digit, not 0
#pragma unroll
  for (int k = 0; k < NL; k++) acc[k] = d == 1 ? x1[k] : (d == 2 ? x2[k] : x3[k]);
  for (int j = nd - 2; j >= 0; j--) {
    fe_sqr(acc, acc, F);
    fe_sqr(acc, acc, F);
    d = (e.v[j >> 4] >> (2 * (j & 15))) & 3;
    if (d) {
#pragma unroll
      for (int k = 0; k < NL; k++) sel[k] = d == 1 ? x1[k] : (d == 2 ? x2[k] : x3[k]);
      fe_mul(acc, acc, sel, F);
    }
  }
  fe_store(out, N, i, acc);
}


// e's 2-bit digits from the steps (s << 5 | d): e = e 2^s + d for each;
// returns the digit count, or 0 if e does not fit NL words
template <int NL>
static int digits_of(uint32_t (&e)[NL], const uint32_t* steps, int nsteps) {
  for (int k = 0; k < NL; k++) e[k] = 0;
  for (int s = 0; s < nsteps; s++) {
    int sq = (int)(steps[s] >> 5);
    for (; sq > 0; sq--) {
      if (e[NL - 1] >> 31) return 0;
      for (int k = NL - 1; k > 0; k--) e[k] = (e[k] << 1) | (e[k - 1] >> 31);
      e[0] <<= 1;
    }
    e[0] |= steps[s] & 31;  // a later step's digit is below 2^s: its bits are zero here
  }
  int bits = 0;
  for (int k = NL - 1; k >= 0 && !bits; k--)
    if (e[k]) bits = 32 * k + 32 - __builtin_clz(e[k]);
  return (bits + 1) / 2;
}

template <int NL>
static int launch(void* out, const void* x, const uint32_t* steps, int nsteps, int entries, const uint32_t* field,
                  int N, void* stream) {
  (void)entries;
  uint32_t e[NL];
  int nd = nsteps > 0 ? digits_of(e, steps, nsteps) : 0;
  if (nd == 0) return (int)cudaErrorInvalidValue;
  if (N > 0)
    exp_ladder_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, fe_from<NL>(e), nd, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int probe_exp_ladder_2bit(void* out, const void* x, const uint32_t* steps, int nsteps, int entries,
                                     const uint32_t* field, int N, void* stream) {
  return launch<12>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int probe_exp_ladder_2bit_n13(void* out, const void* x, const uint32_t* steps, int nsteps,
                                         int entries, const uint32_t* field, int N, void* stream) {
  return launch<13>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int probe_exp_ladder_2bit_n9(void* out, const void* x, const uint32_t* steps, int nsteps,
                                        int entries, const uint32_t* field, int N, void* stream) {
  return launch<9>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif
