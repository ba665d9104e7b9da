// Kernel 11: edge-case triage of the safe packed batched-affine add.
//
// Replaces the Pallas kernel "aff_pre_packed" of
// montgomery_tpu/curves/affine.py (AffineOps.add_packed, safe branch, over
// _pre_packed_formula, :303-312). Per lane, with the signs folded into y
// before the triage (so A and -A cancel): aff_triage of affine.cuh gives the
// denominator, the slope numerator and the flags; a lane without a pair
// (hp == 0) gets denominator 1 (R mod p), so nothing it holds, an unpaired
// lane reading A twice included, reaches the shared inversion. The slope
// numerator of a doubling is 3 x1^2 + a. Outputs: denom (NL, N), numer
// (NL, N), flags (1, N). The entry points take a in Montgomery form, or a
// null pointer for the a = 0 curves, whose kernel is the instantiation
// WITH_A = false: the body without the a term.
//
// Bound on this card: memory; per lane 212 bytes read (two packed columns,
// two signs, the pair flag) and 100 written against one square. Design: one
// thread per lane; A and B are column ranges of the packed (2NL+1, *) arrays
// and are read in place through their row strides.
#include "affine.cuh"

template <int NL, bool WITH_A>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_pre_packed_kernel(int32_t* __restrict__ denom, int32_t* __restrict__ numer, int32_t* __restrict__ flags,
                      const int32_t* __restrict__ A, int sa, const int32_t* __restrict__ B, int sb,
                      const int32_t* __restrict__ sA, const int32_t* __restrict__ sB,
                      const int32_t* __restrict__ hp, Fe<NL> one, FieldParams<NL> F, int N,
                      Fe<NL> ca) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], u[NL];
  load_signed(x1, y1, A, sa, i, sA[i] != 0, F);
  load_signed(x2, y2, B, sb, i, sB[i] != 0, F);
  bool inf1 = A[(size_t)2 * NL * sa + i] != 0, inf2 = B[(size_t)2 * NL * sb + i] != 0;
  int fl = aff_triage<NL, WITH_A>(d, u, x1, y1, x2, y2, inf1, inf2, one.v, ca.v, F);
  fe_select(d, hp[i] != 0, d, one.v);
  fe_store(denom, N, i, d);
  fe_store(numer, N, i, u);
  flags[i] = fl;
}

template <int NL>
static int launch(void* denom, void* numer, void* flags, const void* A, int sa, const void* B, int sb,
                  const void* sA, const void* sB, const void* hp, const uint32_t* one, const uint32_t* a,
                  const uint32_t* field, int N, void* stream) {
  if (N > 0) {
    auto kernel = a ? aff_pre_packed_kernel<NL, true> : aff_pre_packed_kernel<NL, false>;
    kernel<<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)denom, (int32_t*)numer, (int32_t*)flags, (const int32_t*)A, sa, (const int32_t*)B, sb,
        (const int32_t*)sA, (const int32_t*)sB, (const int32_t*)hp, fe_from<NL>(one),
        field_from<NL>(field), N, a ? fe_from<NL>(a) : Fe<NL>{});
  }
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_pre_packed(void* denom, void* numer, void* flags, const void* A, int sa, const void* B,
                                  int sb, const void* sA, const void* sB, const void* hp, const uint32_t* one,
                                  const uint32_t* a, const uint32_t* field, int N, void* stream) {
  return launch<12>(denom, numer, flags, A, sa, B, sb, sA, sB, hp, one, a, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_pre_packed_n13(void* denom, void* numer, void* flags, const void* A, int sa,
                                      const void* B, int sb, const void* sA, const void* sB, const void* hp,
                                      const uint32_t* one, const uint32_t* a, const uint32_t* field, int N,
                                      void* stream) {
  return launch<13>(denom, numer, flags, A, sa, B, sb, sA, sB, hp, one, a, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_pre_packed_n9(void* denom, void* numer, void* flags, const void* A, int sa,
                                     const void* B, int sb, const void* sA, const void* sB, const void* hp,
                                     const uint32_t* one, const uint32_t* a, const uint32_t* field, int N,
                                     void* stream) {
  return launch<9>(denom, numer, flags, A, sa, B, sb, sA, sB, hp, one, a, field, N, stream);
}
#endif
