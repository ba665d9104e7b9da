// The body of aff_post_unsafe on CIOS products (field.cuh's fe_mul and
// fe_sqr) that csrc/aff_post_unsafe.cu's carry-chain body replaced, kept as
// a probe so that chip_smoke.py can time the two in turns on one card. Not
// part of the kernels' library: it is built on its own, once per limb count
// (-DMSM_LIMBS=n), beside it.
//
// Per lane: affine.cuh's aff_chord on CiosMul, lambda = (y2 - y1) dinv,
// x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1; bit for bit the
// kernel's values. Its entry points take the kernel's arguments, so
// chip_smoke.py can put one in place of the kernel's behind
// AffineOps.post_unsafe.
#include "../affine.cuh"

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
  aff_chord<NL, CiosMul>(x3, y3, x1, y1, x2, y2, d, F);
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

#define PROBE_ENTRY(n)                                                                                         \
  extern "C" int probe_aff_post_unsafe_n##n(void* x3, void* y3, const void* x1, int sx1, const void* y1,       \
                                            int sy1, const void* x2, int sx2, const void* y2, int sy2,         \
                                            const void* dinv, int sd, const uint32_t* field, int N,            \
                                            void* stream) {                                                    \
    return launch<n>(x3, y3, x1, sx1, y1, sy1, x2, sx2, y2, sy2, dinv, sd, field, N, stream);                \
  }

#if MSM_AT(12)
PROBE_ENTRY(12)
#endif
#if MSM_AT(13)
PROBE_ENTRY(13)
#endif
#if MSM_AT(9)
PROBE_ENTRY(9)
#endif
