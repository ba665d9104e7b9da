// Kernel 20: denominators of the planar unsafe batched-affine add, with an
// optional validity mask.
//
// Replaces two Pallas kernels of montgomery_tpu/curves/affine.py
// (AffineOps.batch_add_unsafe): "aff_pre_unsafe" (:180, over
// _pre_inv_unsafe_formula, :147-148), denom = x2 - x1, and "aff_pre_masked"
// (:184, over _pre_inv_masked_formula, :150-158), the same where the lane is
// valid and the Montgomery form of 1 elsewhere, so that an excluded lane
// never brings a zero into the shared inversion. One kernel serves both: a
// null mask means every lane is valid.
//
// Bound on this card: memory; per lane two x coordinates (96 bytes) and the
// validity byte read, 48 bytes written, with no product. Design: one thread
// per lane, planes read in place through their row strides, the mask as the
// caller's bool bytes; the null test is uniform across the launch.
#include "field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_pre_unsafe_kernel(int32_t* __restrict__ denom, const int32_t* __restrict__ x1p, int sx1,
                      const int32_t* __restrict__ x2p, int sx2, const uint8_t* __restrict__ valid,
                      Fe<NL> one, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], x2[NL], d[NL];
  fe_load(x1, x1p, sx1, i);
  fe_load(x2, x2p, sx2, i);
  fe_sub(d, x2, x1, F);
  if (valid != nullptr) fe_select(d, valid[i] != 0, d, one.v);
  fe_store(denom, N, i, d);
}

template <int NL>
static int launch(void* denom, const void* x1, int sx1, const void* x2, int sx2, const void* valid,
                  const uint32_t* one, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    aff_pre_unsafe_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)denom, (const int32_t*)x1, sx1, (const int32_t*)x2, sx2, (const uint8_t*)valid,
        fe_from<NL>(one), field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_pre_unsafe(void* denom, const void* x1, int sx1, const void* x2, int sx2,
                                  const void* valid, const uint32_t* one, const uint32_t* field, int N,
                                  void* stream) {
  return launch<12>(denom, x1, sx1, x2, sx2, valid, one, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_pre_unsafe_n13(void* denom, const void* x1, int sx1, const void* x2, int sx2,
                                      const void* valid, const uint32_t* one, const uint32_t* field, int N,
                                      void* stream) {
  return launch<13>(denom, x1, sx1, x2, sx2, valid, one, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_pre_unsafe_n9(void* denom, const void* x1, int sx1, const void* x2, int sx2,
                                     const void* valid, const uint32_t* one, const uint32_t* field, int N,
                                     void* stream) {
  return launch<9>(denom, x1, sx1, x2, sx2, valid, one, field, N, stream);
}
#endif
