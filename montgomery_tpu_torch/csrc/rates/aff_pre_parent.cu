// The bodies of aff_pre and aff_pre_packed before the a term (the tangent's
// numerator 3 x1^2, no template flag), kept as a probe so that chip_smoke.py
// can time the kernels' a = 0 instantiation against them in turns on one
// card. Not part of the kernels' library: it is built on its own at 12 limbs
// (-DMSM_LIMBS=12) beside it.
//
// parent_triage is affine.cuh's aff_triage as it was without WITH_A and ca.
// The entry points take the kernels' arguments, a included (unread), so
// chip_smoke.py can put one in place of the kernel's behind AffineOps.pre
// and AffineOps.pre_packed.
#include "../affine.cuh"

template <int NL>
__device__ __forceinline__ int parent_triage(uint32_t (&denom)[NL], uint32_t (&numer)[NL],
                                             const uint32_t (&x1)[NL], const uint32_t (&y1)[NL],
                                             const uint32_t (&x2)[NL], const uint32_t (&y2)[NL], bool inf1,
                                             bool inf2, const uint32_t (&one)[NL], const FieldParams<NL>& F) {
  bool xeq = fe_is_equal(x1, x2, F), yeq = fe_is_equal(y1, y2, F);
  bool finite = !inf1 && !inf2;
  bool is_dbl = xeq && yeq && finite;
  bool cancel = xeq && !yeq && finite;
  bool y1_zero = fe_is_zero(y1, F);
  uint32_t a[NL], b[NL];
  fe_add(a, y1, y1, F);
  fe_sub(b, x2, x1, F);
  fe_select(denom, is_dbl, a, b);
  bool poisoned = cancel || (is_dbl && y1_zero) || !finite;
  fe_select(denom, poisoned, one, denom);
  uint32_t xx[NL];
  fe_sqr(xx, x1, F);
  fe_add(a, xx, xx, F);
  fe_add(a, a, xx, F);
  fe_sub(b, y2, y1, F);
  fe_select(numer, is_dbl, a, b);
  return (is_dbl ? AFF_DBL : 0) | (cancel ? AFF_CANCEL : 0) | (y1_zero ? AFF_Y1_ZERO : 0);
}

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_pre_kernel(int32_t* __restrict__ denom, int32_t* __restrict__ numer, int32_t* __restrict__ flags,
               const int32_t* __restrict__ x1p, int sx1, const int32_t* __restrict__ y1p, int sy1,
               const int32_t* __restrict__ x2p, int sx2, const int32_t* __restrict__ y2p, int sy2,
               const uint8_t* __restrict__ inf1, const uint8_t* __restrict__ inf2, Fe<NL> one,
               FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], u[NL];
  fe_load(x1, x1p, sx1, i);
  fe_load(y1, y1p, sy1, i);
  fe_load(x2, x2p, sx2, i);
  fe_load(y2, y2p, sy2, i);
  flags[i] = parent_triage(d, u, x1, y1, x2, y2, inf1[i] != 0, inf2[i] != 0, one.v, F);
  fe_store(denom, N, i, d);
  fe_store(numer, N, i, u);
}

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_pre_packed_kernel(int32_t* __restrict__ denom, int32_t* __restrict__ numer, int32_t* __restrict__ flags,
                      const int32_t* __restrict__ A, int sa, const int32_t* __restrict__ B, int sb,
                      const int32_t* __restrict__ sA, const int32_t* __restrict__ sB,
                      const int32_t* __restrict__ hp, Fe<NL> one, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], u[NL];
  load_signed(x1, y1, A, sa, i, sA[i] != 0, F);
  load_signed(x2, y2, B, sb, i, sB[i] != 0, F);
  bool inf1 = A[(size_t)2 * NL * sa + i] != 0, inf2 = B[(size_t)2 * NL * sb + i] != 0;
  int fl = parent_triage(d, u, x1, y1, x2, y2, inf1, inf2, one.v, F);
  fe_select(d, hp[i] != 0, d, one.v);
  fe_store(denom, N, i, d);
  fe_store(numer, N, i, u);
  flags[i] = fl;
}

#if MSM_AT(12)
extern "C" int probe_aff_pre_n12(void* denom, void* numer, void* flags, const void* x1, int sx1,
                                 const void* y1, int sy1, const void* x2, int sx2, const void* y2, int sy2,
                                 const void* inf1, const void* inf2, const uint32_t* one, const uint32_t* a,
                                 const uint32_t* field, int N, void* stream) {
  (void)a;
  if (N > 0)
    aff_pre_kernel<12><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)denom, (int32_t*)numer, (int32_t*)flags, (const int32_t*)x1, sx1, (const int32_t*)y1, sy1,
        (const int32_t*)x2, sx2, (const int32_t*)y2, sy2, (const uint8_t*)inf1, (const uint8_t*)inf2,
        fe_from<12>(one), field_from<12>(field), N);
  return (int)cudaGetLastError();
}

extern "C" int probe_aff_pre_packed_n12(void* denom, void* numer, void* flags, const void* A, int sa,
                                        const void* B, int sb, const void* sA, const void* sB, const void* hp,
                                        const uint32_t* one, const uint32_t* a, const uint32_t* field, int N,
                                        void* stream) {
  (void)a;
  if (N > 0)
    aff_pre_packed_kernel<12><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)denom, (int32_t*)numer, (int32_t*)flags, (const int32_t*)A, sa, (const int32_t*)B, sb,
        (const int32_t*)sA, (const int32_t*)sB, (const int32_t*)hp, fe_from<12>(one), field_from<12>(field),
        N);
  return (int)cudaGetLastError();
}
#endif
