// Kernel 21: chord completion of the planar unsafe batched-affine add.
//
// Replaces the Pallas kernel "aff_post_unsafe" of
// montgomery_tpu/curves/affine.py (AffineOps.batch_add_unsafe, :190, over
// _post_inv_unsafe_formula, :160-167): lambda = (y2 - y1) dinv,
// x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1 (aff_chord of
// affine.cuh, which the packed aff_post_packed_u.cu calls too). Outputs:
// x3 (NL, N), y3 (NL, N). The unsafe contract (valid lanes are finite and
// x1 != x2) is the caller's; an excluded lane's output is unspecified.
//
// Bound on this card: per lane 240 bytes read and 96 written, against 2
// products and a square (798 32x32->64 multiplies); the memory bound is a
// little above the multiply bound. Design: one thread per lane, every plane
// read in place through its row stride, the chord's products and square on
// madc.cuh's carry chains (fe_mul_cc, fe_sqr_cc). The body it replaced ran
// the same chord on field.cuh's CIOS fe_mul and fe_sqr; the two agreed bit
// for bit.
#include "affine.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_post_unsafe_kernel(int32_t* __restrict__ x3p, int32_t* __restrict__ y3p, const int32_t* __restrict__ x1p,
                       int sx1, const int32_t* __restrict__ y1p, int sy1, const int32_t* __restrict__ x2p,
                       int sx2, const int32_t* __restrict__ y2p, int sy2, const int32_t* __restrict__ dinv,
                       int sd, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], x3[NL], y3[NL];
  fe_load(x1, x1p, sx1, i);
  fe_load(y1, y1p, sy1, i);
  fe_load(x2, x2p, sx2, i);
  fe_load(y2, y2p, sy2, i);
  fe_load(d, dinv, sd, i);
  aff_chord(x3, y3, x1, y1, x2, y2, d, F);
  fe_store(x3p, N, i, x3);
  fe_store(y3p, N, i, y3);
}

template <int NL>
static int launch(void* x3, void* y3, const void* x1, int sx1, const void* y1, int sy1, const void* x2,
                  int sx2, const void* y2, int sy2, const void* dinv, int sd, const uint32_t* field, int N,
                  void* stream) {
  if (N > 0)
    aff_post_unsafe_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)x3, (int32_t*)y3, (const int32_t*)x1, sx1, (const int32_t*)y1, sy1, (const int32_t*)x2,
        sx2, (const int32_t*)y2, sy2, (const int32_t*)dinv, sd, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_post_unsafe(void* x3, void* y3, const void* x1, int sx1, const void* y1, int sy1,
                                   const void* x2, int sx2, const void* y2, int sy2, const void* dinv, int sd,
                                   const uint32_t* field, int N, void* stream) {
  return launch<12>(x3, y3, x1, sx1, y1, sy1, x2, sx2, y2, sy2, dinv, sd, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_post_unsafe_n13(void* x3, void* y3, const void* x1, int sx1, const void* y1, int sy1,
                                       const void* x2, int sx2, const void* y2, int sy2, const void* dinv,
                                       int sd, const uint32_t* field, int N, void* stream) {
  return launch<13>(x3, y3, x1, sx1, y1, sy1, x2, sx2, y2, sy2, dinv, sd, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_post_unsafe_n9(void* x3, void* y3, const void* x1, int sx1, const void* y1, int sy1,
                                      const void* x2, int sx2, const void* y2, int sy2, const void* dinv,
                                      int sd, const uint32_t* field, int N, void* stream) {
  return launch<9>(x3, y3, x1, sx1, y1, sy1, x2, sx2, y2, sy2, dinv, sd, field, N, stream);
}
#endif
