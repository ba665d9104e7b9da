// Kernel 8: denominators of the unsafe packed batched-affine add.
//
// Replaces the Pallas kernel "aff_pre_packed_u" of
// montgomery_tpu/curves/affine.py (AffineOps.add_packed, unsafe branch, over
// _pre_packed_unsafe_formula, :275-281): denom = x_B - x_A in [0, 2p), and the
// Montgomery form of 1 (R mod p) where the lane has no pair (hp == 0), so
// that a pass-through lane never brings a zero into the shared inversion.
//
// Bound on this card: memory; per lane it reads two x coordinates (96 bytes)
// and the pair flag, and writes 48 bytes, with no product. Design: one thread
// per lane; A and B are column ranges of the packed (2n+1, *) arrays and are
// read in place through their row strides.
#include "field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_pre_packed_u_kernel(int32_t* __restrict__ denom, const int32_t* __restrict__ A, int sa,
                        const int32_t* __restrict__ B, int sb, const int32_t* __restrict__ hp, Fe<NL> one,
                        FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], x2[NL], d[NL];
  fe_load(x1, A, sa, i);
  fe_load(x2, B, sb, i);
  fe_sub(d, x2, x1, F);
  fe_select(d, hp[i] != 0, d, one.v);
  fe_store(denom, N, i, d);
}

template <int NL>
static int launch(void* denom, const void* A, int sa, const void* B, int sb, const void* hp,
                  const uint32_t* one, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    aff_pre_packed_u_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)denom, (const int32_t*)A, sa, (const int32_t*)B, sb, (const int32_t*)hp, fe_from<NL>(one),
        field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_pre_packed_u(void* denom, const void* A, int sa, const void* B, int sb, const void* hp,
                                    const uint32_t* one, const uint32_t* field, int N, void* stream) {
  return launch<12>(denom, A, sa, B, sb, hp, one, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_pre_packed_u_n13(void* denom, const void* A, int sa, const void* B, int sb,
                                        const void* hp, const uint32_t* one, const uint32_t* field, int N,
                                        void* stream) {
  return launch<13>(denom, A, sa, B, sb, hp, one, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_pre_packed_u_n9(void* denom, const void* A, int sa, const void* B, int sb,
                                       const void* hp, const uint32_t* one, const uint32_t* field, int N,
                                       void* stream) {
  return launch<9>(denom, A, sa, B, sb, hp, one, field, N, stream);
}
#endif
