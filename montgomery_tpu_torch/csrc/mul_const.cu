// Kernel 1: Montgomery product of every lane by one constant.
//
// Replaces the Pallas kernel "mul_const" of montgomery_tpu/ops/field.py
// (FieldOps.mul_const, :562-589), which baked the constant's limbs into the
// traced formula. It serves to_montgomery (c = R^2), from_montgomery (c = 1)
// and the GLV endomorphism phi(x, y) = (beta x, y). Entry points:
// msm_mul_const (12 limbs, BLS12-377), msm_mul_const_n13 (13 limbs,
// BLS12-381) and msm_mul_const_n9 (9 limbs: Pallas, and ed-on-bls12-377's
// to Montgomery form in EdwardsMsm.points_from_bytes), and msm_mul_const_n1,
// _n2, _n3 (the example fields small, babybear and goldilocks, where the
// bytes bound it).
//
// Bound on this card: one NL-word CIOS product per lane, so integer multiply
// throughput; each lane reads and writes 4 NL bytes, far below the multiply
// time. Design: one thread per lane with coalesced limb-plane loads
// (limb k of lane i at k*N + i); the constant rides by value in the kernel's
// parameter bank (no trace-time baking, one binary for every constant).
#include "field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
mul_const_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, Fe<NL> c, FieldParams<NL> F,
                 int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL], r[NL];
  fe_load(a, x, N, i);
  fe_mul(r, a, c.v, F);
  fe_store(out, N, i, r);
}

template <int NL>
static int launch(void* out, const void* x, const uint32_t* c, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    mul_const_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, fe_from<NL>(c), field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_mul_const(void* out, const void* x, const uint32_t* c, const uint32_t* field, int N,
                             void* stream) {
  return launch<12>(out, x, c, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_mul_const_n13(void* out, const void* x, const uint32_t* c, const uint32_t* field, int N,
                                 void* stream) {
  return launch<13>(out, x, c, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_mul_const_n9(void* out, const void* x, const uint32_t* c, const uint32_t* field, int N,
                                void* stream) {
  return launch<9>(out, x, c, field, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_mul_const_n1(void* out, const void* x, const uint32_t* c, const uint32_t* field, int N,
                                void* stream) {
  return launch<1>(out, x, c, field, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_mul_const_n2(void* out, const void* x, const uint32_t* c, const uint32_t* field, int N,
                                void* stream) {
  return launch<2>(out, x, c, field, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_mul_const_n3(void* out, const void* x, const uint32_t* c, const uint32_t* field, int N,
                                void* stream) {
  return launch<3>(out, x, c, field, N, stream);
}
#endif
