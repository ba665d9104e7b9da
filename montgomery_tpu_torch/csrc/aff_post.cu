// Kernel 19: completion of the planar safe batched-affine add.
//
// Replaces the Pallas kernel "aff_post" of montgomery_tpu/curves/affine.py
// (AffineOps.batch_add, :140, over _post_inv_formula, :101-121). Per lane:
// aff_complete of affine.cuh (the chord or tangent from the numerator and
// the inverted denominator, then the edge-case selects: one infinite operand
// passes the other through; cancel, a tangent at y = 0 and two infinite
// operands give infinity). Outputs: x3 (NL, N), y3 (NL, N) and the bool
// infinity mask (N).
//
// Bound on this card: per lane 288 bytes of planes, 4 of flags and two
// infinity bytes read, 97 bytes written, against two products and one
// square (798 32x32->64 multiplies); memory bounds it by a little. Design:
// one thread per lane, every plane read in place through its row stride,
// the masks read and written as bool bytes.
#include "affine.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_post_kernel(int32_t* __restrict__ x3p, int32_t* __restrict__ y3p, uint8_t* __restrict__ inf3,
                const int32_t* __restrict__ x1p, int sx1, const int32_t* __restrict__ y1p, int sy1,
                const int32_t* __restrict__ x2p, int sx2, const int32_t* __restrict__ y2p, int sy2,
                const int32_t* __restrict__ dinv, int sd, const int32_t* __restrict__ numer, int sn,
                const int32_t* __restrict__ flags, const uint8_t* __restrict__ inf1,
                const uint8_t* __restrict__ inf2, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], u[NL], x3[NL], y3[NL];
  fe_load(x1, x1p, sx1, i);
  fe_load(y1, y1p, sy1, i);
  fe_load(x2, x2p, sx2, i);
  fe_load(y2, y2p, sy2, i);
  fe_load(d, dinv, sd, i);
  fe_load(u, numer, sn, i);
  bool inf = aff_complete(x3, y3, x1, y1, x2, y2, d, u, flags[i], inf1[i] != 0, inf2[i] != 0, F);
  fe_store(x3p, N, i, x3);
  fe_store(y3p, N, i, y3);
  inf3[i] = inf;
}

template <int NL>
static int launch(void* x3, void* y3, void* inf3, const void* x1, int sx1, const void* y1, int sy1,
                  const void* x2, int sx2, const void* y2, int sy2, const void* dinv, int sd,
                  const void* numer, int sn, const void* flags, const void* inf1, const void* inf2,
                  const uint32_t* field, int N, void* stream) {
  if (N > 0)
    aff_post_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)x3, (int32_t*)y3, (uint8_t*)inf3, (const int32_t*)x1, sx1, (const int32_t*)y1, sy1,
        (const int32_t*)x2, sx2, (const int32_t*)y2, sy2, (const int32_t*)dinv, sd, (const int32_t*)numer,
        sn, (const int32_t*)flags, (const uint8_t*)inf1, (const uint8_t*)inf2, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_post(void* x3, void* y3, void* inf3, const void* x1, int sx1, const void* y1, int sy1,
                            const void* x2, int sx2, const void* y2, int sy2, const void* dinv, int sd,
                            const void* numer, int sn, const void* flags, const void* inf1, const void* inf2,
                            const uint32_t* field, int N, void* stream) {
  return launch<12>(x3, y3, inf3, x1, sx1, y1, sy1, x2, sx2, y2, sy2, dinv, sd, numer, sn, flags, inf1, inf2,
    field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_post_n13(void* x3, void* y3, void* inf3, const void* x1, int sx1, const void* y1,
                                int sy1, const void* x2, int sx2, const void* y2, int sy2, const void* dinv,
                                int sd, const void* numer, int sn, const void* flags, const void* inf1,
                                const void* inf2, const uint32_t* field, int N, void* stream) {
  return launch<13>(x3, y3, inf3, x1, sx1, y1, sy1, x2, sx2, y2, sy2, dinv, sd, numer, sn, flags, inf1, inf2,
    field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_post_n9(void* x3, void* y3, void* inf3, const void* x1, int sx1, const void* y1,
                               int sy1, const void* x2, int sx2, const void* y2, int sy2, const void* dinv,
                               int sd, const void* numer, int sn, const void* flags, const void* inf1,
                               const void* inf2, const uint32_t* field, int N, void* stream) {
  return launch<9>(x3, y3, inf3, x1, sx1, y1, sy1, x2, sx2, y2, sy2, dinv, sd, numer, sn, flags, inf1, inf2,
    field, N, stream);
}
#endif
