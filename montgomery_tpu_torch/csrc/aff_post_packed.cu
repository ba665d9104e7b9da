// Kernel 12: completion of the safe packed batched-affine add.
//
// Replaces the Pallas kernel "aff_post_packed" of
// montgomery_tpu/curves/affine.py (AffineOps.add_packed, safe branch, over
// _post_packed_formula, :314-329). Per lane, with the signs folded into y:
// aff_complete of affine.cuh (chord or tangent from the numerator and the
// inverted denominator, then the edge-case selects); a paired lane (hp != 0)
// writes the sum with its infinity flag, an unpaired lane passes the
// sign-applied A through, inf row included. Output: one packed (2NL+1, N)
// array.
//
// Bound on this card: per lane 312 bytes read (two packed columns, dinv,
// numer, flags, two signs, the pair flag) and 100 written, against two
// products and one square (798 32x32->64 multiplies); memory bounds it by a
// little. Design: one thread per lane, every operand read in place through
// its row stride; neg/sub/select are the branch-free helpers of field.cuh.
#include "affine.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_post_packed_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ A, int sa,
                       const int32_t* __restrict__ B, int sb, const int32_t* __restrict__ sA,
                       const int32_t* __restrict__ sB, const int32_t* __restrict__ dinv, int sd,
                       const int32_t* __restrict__ numer, int sn, const int32_t* __restrict__ flags,
                       const int32_t* __restrict__ hp, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], u[NL], x3[NL], y3[NL];
  load_signed(x1, y1, A, sa, i, sA[i] != 0, F);
  load_signed(x2, y2, B, sb, i, sB[i] != 0, F);
  int32_t inf1 = A[(size_t)2 * NL * sa + i];
  bool inf2 = B[(size_t)2 * NL * sb + i] != 0;
  fe_load(d, dinv, sd, i);
  fe_load(u, numer, sn, i);
  bool inf3 = aff_complete(x3, y3, x1, y1, x2, y2, d, u, flags[i], inf1 != 0, inf2, F);
  bool paired = hp[i] != 0;
  fe_select(x3, paired, x3, x1);
  fe_select(y3, paired, y3, y1);
  fe_store(out, N, i, x3);
  fe_store(out + (size_t)NL * N, N, i, y3);
  out[(size_t)2 * NL * N + i] = paired ? (int32_t)inf3 : inf1;
}

template <int NL>
static int launch(void* out, const void* A, int sa, const void* B, int sb, const void* sA, const void* sB,
                  const void* dinv, int sd, const void* numer, int sn, const void* flags, const void* hp,
                  const uint32_t* field, int N, void* stream) {
  if (N > 0)
    aff_post_packed_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)A, sa, (const int32_t*)B, sb, (const int32_t*)sA, (const int32_t*)sB,
        (const int32_t*)dinv, sd, (const int32_t*)numer, sn, (const int32_t*)flags, (const int32_t*)hp,
        field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_post_packed(void* out, const void* A, int sa, const void* B, int sb, const void* sA,
                                   const void* sB, const void* dinv, int sd, const void* numer, int sn,
                                   const void* flags, const void* hp, const uint32_t* field, int N,
                                   void* stream) {
  return launch<12>(out, A, sa, B, sb, sA, sB, dinv, sd, numer, sn, flags, hp, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_post_packed_n13(void* out, const void* A, int sa, const void* B, int sb,
                                       const void* sA, const void* sB, const void* dinv, int sd,
                                       const void* numer, int sn, const void* flags, const void* hp,
                                       const uint32_t* field, int N, void* stream) {
  return launch<13>(out, A, sa, B, sb, sA, sB, dinv, sd, numer, sn, flags, hp, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_post_packed_n9(void* out, const void* A, int sa, const void* B, int sb, const void* sA,
                                      const void* sB, const void* dinv, int sd, const void* numer, int sn,
                                      const void* flags, const void* hp, const uint32_t* field, int N,
                                      void* stream) {
  return launch<9>(out, A, sa, B, sb, sA, sB, dinv, sd, numer, sn, flags, hp, field, N, stream);
}
#endif
