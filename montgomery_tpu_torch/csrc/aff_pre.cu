// Kernel 18: edge-case triage of the planar safe batched-affine add.
//
// Replaces the Pallas kernel "aff_pre" of montgomery_tpu/curves/affine.py
// (AffineOps.batch_add, :134, over _pre_inv_formula, :76-99). Per lane of
// two planar point batches G and H: aff_triage of affine.cuh gives the
// denominator (2 y1 for a doubling, x2 - x1 otherwise, the Montgomery form
// of 1 where poisoned: cancel, a tangent at y = 0, an infinite operand), the
// slope numerator (3 x1^2 + a for a doubling) and the flags. Outputs: denom
// (NL, N), numer (NL, N), flags (1, N). The entry points take a in
// Montgomery form, or a null pointer for the a = 0 curves, whose kernel is
// the instantiation WITH_A = false: the body without the a term.
//
// Bound on this card: memory; per lane 192 bytes of coordinates and two
// infinity bytes read, 100 bytes written, against one square. Design: one
// thread per lane; each coordinate plane is read in place through its own
// row stride (a column slice or a flattened grid passes without a copy); the
// infinity masks are the batches' bool bytes, read as they are.
#include "affine.cuh"

template <int NL, bool WITH_A>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_pre_kernel(int32_t* __restrict__ denom, int32_t* __restrict__ numer, int32_t* __restrict__ flags,
               const int32_t* __restrict__ x1p, int sx1, const int32_t* __restrict__ y1p, int sy1,
               const int32_t* __restrict__ x2p, int sx2, const int32_t* __restrict__ y2p, int sy2,
               const uint8_t* __restrict__ inf1, const uint8_t* __restrict__ inf2, Fe<NL> one,
               FieldParams<NL> F, int N, Fe<NL> ca) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], u[NL];
  fe_load(x1, x1p, sx1, i);
  fe_load(y1, y1p, sy1, i);
  fe_load(x2, x2p, sx2, i);
  fe_load(y2, y2p, sy2, i);
  flags[i] = aff_triage<NL, WITH_A>(d, u, x1, y1, x2, y2, inf1[i] != 0, inf2[i] != 0, one.v, ca.v, F);
  fe_store(denom, N, i, d);
  fe_store(numer, N, i, u);
}

template <int NL>
static int launch(void* denom, void* numer, void* flags, const void* x1, int sx1, const void* y1, int sy1,
                  const void* x2, int sx2, const void* y2, int sy2, const void* inf1, const void* inf2,
                  const uint32_t* one, const uint32_t* a, const uint32_t* field, int N, void* stream) {
  if (N > 0) {
    auto kernel = a ? aff_pre_kernel<NL, true> : aff_pre_kernel<NL, false>;
    kernel<<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)denom, (int32_t*)numer, (int32_t*)flags, (const int32_t*)x1, sx1, (const int32_t*)y1, sy1,
        (const int32_t*)x2, sx2, (const int32_t*)y2, sy2, (const uint8_t*)inf1, (const uint8_t*)inf2,
        fe_from<NL>(one), field_from<NL>(field), N, a ? fe_from<NL>(a) : Fe<NL>{});
  }
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_pre(void* denom, void* numer, void* flags, const void* x1, int sx1, const void* y1,
                           int sy1, const void* x2, int sx2, const void* y2, int sy2, const void* inf1,
                           const void* inf2, const uint32_t* one, const uint32_t* a, const uint32_t* field,
                           int N, void* stream) {
  return launch<12>(denom, numer, flags, x1, sx1, y1, sy1, x2, sx2, y2, sy2, inf1, inf2, one, a, field, N,
    stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_pre_n13(void* denom, void* numer, void* flags, const void* x1, int sx1, const void* y1,
                               int sy1, const void* x2, int sx2, const void* y2, int sy2, const void* inf1,
                               const void* inf2, const uint32_t* one, const uint32_t* a,
                               const uint32_t* field, int N, void* stream) {
  return launch<13>(denom, numer, flags, x1, sx1, y1, sy1, x2, sx2, y2, sy2, inf1, inf2, one, a, field, N,
    stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_pre_n9(void* denom, void* numer, void* flags, const void* x1, int sx1, const void* y1,
                              int sy1, const void* x2, int sx2, const void* y2, int sy2, const void* inf1,
                              const void* inf2, const uint32_t* one, const uint32_t* a, const uint32_t* field,
                              int N, void* stream) {
  return launch<9>(denom, numer, flags, x1, sx1, y1, sy1, x2, sx2, y2, sy2, inf1, inf2, one, a, field, N,
    stream);
}
#endif
