// Kernel 10: Montgomery square of a plane, lane by lane.
//
// Replaces the Pallas kernel "mont_sqr" of montgomery_tpu/ops/field.py
// (FieldOps.square, :525-535, over _sqr_dot, :383-399). On the MSM path it
// runs in the on-curve check of serve.compute_msm (two launches: x^2, y^2).
// Entry points: msm_mont_sqr (12 limbs), msm_mont_sqr_n13, msm_mont_sqr_n9,
// and msm_mont_sqr_n1, _n2, _n3 (the example fields small, babybear and
// goldilocks, bytes-bound).
//
// Bound on this card: per lane 96 bytes moved against one square, 78 + 144
// 32x32->64 products and 12 low ones (fe_sqr in field.cuh); at 2^20 lanes
// that is about 30 us of memory against about 28 us of multiplies at the
// rates csrc/rates/imad_rate.cu measures, so the two are close. Design: one
// thread per lane, coalesced limb-plane loads through the input's row stride
// (a column slice is read in place); the result equals mont_mul(x, x) bit
// for bit.
#include "field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
mont_sqr_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL], r[NL];
  fe_load(a, x, sx, i);
  fe_sqr(r, a, F);
  fe_store(out, N, i, r);
}

template <int NL>
static int launch(void* out, const void* x, int sx, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    mont_sqr_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_mont_sqr(void* out, const void* x, int sx, const uint32_t* field, int N, void* stream) {
  return launch<12>(out, x, sx, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_mont_sqr_n13(void* out, const void* x, int sx, const uint32_t* field, int N,
                                void* stream) {
  return launch<13>(out, x, sx, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_mont_sqr_n9(void* out, const void* x, int sx, const uint32_t* field, int N, void* stream) {
  return launch<9>(out, x, sx, field, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_mont_sqr_n1(void* out, const void* x, int sx, const uint32_t* field, int N, void* stream) {
  return launch<1>(out, x, sx, field, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_mont_sqr_n2(void* out, const void* x, int sx, const uint32_t* field, int N, void* stream) {
  return launch<2>(out, x, sx, field, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_mont_sqr_n3(void* out, const void* x, int sx, const uint32_t* field, int N, void* stream) {
  return launch<3>(out, x, sx, field, N, stream);
}
#endif
