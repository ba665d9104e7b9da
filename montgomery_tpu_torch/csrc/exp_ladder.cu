// Kernel 15: x^e for an exponent given at run time, 2-bit windows.
//
// Replaces the Pallas kernel "exp_ladder_{e}" of montgomery_tpu/ops/field.py
// (FieldOps.exp_ladder / _ladder_formula, :600-670), which baked a static e
// into each kernel. Here e rides in the launch's parameters as NL words (its
// 2-bit digits, 16 to a word) with the digit count, so one binary serves
// FieldOps.inv (e = p - 2) and the first step of FieldOps.sqrt
// (e = (q - 1) / 2). Entry points: msm_exp_ladder (12 limbs, BLS12-377's
// base field), msm_exp_ladder_n13 (13 limbs, BLS12-381's) and
// msm_exp_ladder_n9 (9 limbs, Pallas's and ed-on-bls12-377's).
//
// Bound on this card: a serial chain per lane of 2 squarings and up to one
// product per digit (about 190 squarings and 140 products for e = p - 2 at
// NL = 12), against 8 NL bytes moved, so integer multiply throughput bounds
// it by far. Design: one thread per lane; the table {x, x^2, x^3} stays in
// registers; every lane walks the same digits, so the loop does not diverge,
// and a digit 0 skips its product (the JAX package multiplied by one there:
// the same value, possibly another representative in [0, 2p); the plain
// version FieldOps.exp_ladder_plain skips it too).
#include "field.cuh"

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

template <int NL>
static int launch(void* out, const void* x, const uint32_t* e, int nd, const uint32_t* field, int N,
                  void* stream) {
  if (N > 0)
    exp_ladder_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, fe_from<NL>(e), nd, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_exp_ladder(void* out, const void* x, const uint32_t* e, int nd, const uint32_t* field,
                              int N, void* stream) {
  return launch<12>(out, x, e, nd, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_exp_ladder_n13(void* out, const void* x, const uint32_t* e, int nd,
                                  const uint32_t* field, int N, void* stream) {
  return launch<13>(out, x, e, nd, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_exp_ladder_n9(void* out, const void* x, const uint32_t* e, int nd,
                                 const uint32_t* field, int N, void* stream) {
  return launch<9>(out, x, e, nd, field, N, stream);
}
#endif
