// The wide body of proj_dbl_rcb on CIOS products (field.cuh's fe_mul) that
// csrc/proj_dbl_rcb.cu's carry-chain body replaced, kept as a probe so that
// chip_smoke.py can time the two in turns on one card and run the cofactor
// stage on either. Not part of the kernels' library: it is built on its
// own, once per limb count (-DMSM_LIMBS=n), beside it.
//
// Renes-Costello-Batina 2015/1060, Alg. 9, one point in one thread's
// registers for all k doublings: projective.cuh's rcb_dbl on CiosMul, 9
// CIOS products (field.cuh's fe_mul) a doubling; bit for bit the kernel's
// values. Its entry points take the kernel's arguments, so chip_smoke.py can
// put one in place of the kernel's behind ProjectiveOps.double_n; it runs
// every launch on this body (mu and few unused).
#include "../projective.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
proj_dbl_rcb_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                    const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                    const int32_t* __restrict__ Z1, int k, Fe<NL> b3, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x[NL], y[NL], z[NL];
  fe_load(x, X1, N, i);
  fe_load(y, Y1, N, i);
  fe_load(z, Z1, N, i);
  for (int r = 0; r < k; r++) rcb_dbl<NL, CiosMul>(x, y, z, b3, F);
  fe_store(X3, N, i, x);
  fe_store(Y3, N, i, y);
  fe_store(Z3, N, i, z);
}

template <int NL>
static int launch(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1, int k,
                  const uint32_t* b3, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    proj_dbl_rcb_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (const int32_t*)X1, (const int32_t*)Y1, (const int32_t*)Z1, k,
        fe_from<NL>(b3), field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#define PROBE_ENTRY(n)                                                                                         \
  extern "C" int probe_proj_dbl_rcb_n##n(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1,         \
                                         const void* Z1, int k, const uint32_t* b3, const uint32_t*,           \
                                         const uint32_t* field, int N, int, void* stream) {                    \
    return launch<n>(X3, Y3, Z3, X1, Y1, Z1, k, b3, field, N, stream);                                         \
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
