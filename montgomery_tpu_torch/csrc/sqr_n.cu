// Kernel 16: m Montgomery squarings of every lane, m given at run time.
//
// Replaces two Pallas call sites of montgomery_tpu/ops/field.py
// (FieldOps.sqr_n, :814-851): "sqr_n_dyn" (:839, m read from a plane) and
// "sqr_n_{m}" (:850, one kernel per static m). FieldOps.sqrt runs it once
// per 4-bit window of the 2-Sylow discrete log, for the chain that brings t
// down to the window (42, 38, ..., 2 squarings at BLS12-377's M = 46).
// Entry points: msm_sqr_n (12 limbs), msm_sqr_n_n13 (13 limbs; BLS12-381's
// M = 1 needs no chain, so its sqrt never launches it) and msm_sqr_n_n9 (9
// limbs: Pallas, M = 32, and ed-on-bls12-377), and msm_sqr_n_n1, _n2, _n3
// (the example fields small, M = 2, and babybear, M = 1, whose sqrt never
// launches it; goldilocks, M = 32, seven chains).
//
// Bound on this card: m squarings per lane (fe_sqr: NL (NL + 1) / 2 + NL^2
// 32x32->64 multiplies each) against 8 NL bytes moved, so integer multiply
// throughput for any m above 1. Design: one thread per lane, the element in
// registers across the chain; fe_sqr is the squaring of mont_sqr, equal to
// fe_mul(a, a) bit for bit, so the plain version is m plain products.
#include "field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
sqr_n_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int m, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL];
  fe_load(a, x, N, i);
  for (int j = 0; j < m; j++) fe_sqr(a, a, F);
  fe_store(out, N, i, a);
}

template <int NL>
static int launch(void* out, const void* x, int m, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    sqr_n_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, m, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_sqr_n(void* out, const void* x, int m, const uint32_t* field, int N, void* stream) {
  return launch<12>(out, x, m, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_sqr_n_n13(void* out, const void* x, int m, const uint32_t* field, int N, void* stream) {
  return launch<13>(out, x, m, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_sqr_n_n9(void* out, const void* x, int m, const uint32_t* field, int N, void* stream) {
  return launch<9>(out, x, m, field, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_sqr_n_n1(void* out, const void* x, int m, const uint32_t* field, int N, void* stream) {
  return launch<1>(out, x, m, field, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_sqr_n_n2(void* out, const void* x, int m, const uint32_t* field, int N, void* stream) {
  return launch<2>(out, x, m, field, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_sqr_n_n3(void* out, const void* x, int m, const uint32_t* field, int N, void* stream) {
  return launch<3>(out, x, m, field, N, stream);
}
#endif
