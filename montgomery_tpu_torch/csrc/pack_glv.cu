// Kernel 7: GLV point expansion fused with the packed-row layout.
//
// Replaces the Pallas kernel "pack_glv" of montgomery_tpu/curves/affine.py
// (AffineOps.pack_rows_glv / _pack_glv_formula, :238-264): from N affine
// points (x, y, inf) it writes the packed rows of [P..., phi(P)...] with
// phi(x, y) = (beta x, y), one (2n+1, 2N) array: rows [x (n) | y (n) | inf].
// The TPU packed two 13-bit limbs per int32 row; this port's limbs are whole
// 32-bit words, so a packed point is 2n+1 = 25 rows and there is no 16-bit
// packing. The MSM engine gathers one such column per operand per round.
//
// Bound on this card: memory. Each point reads 97 bytes and writes 200; the
// one product by beta per point (288 multiplies) is below that at this width.
// Design: one thread per point writes both halves of the output directly
// (column i and column N + i), so no concatenation follows the launch.
#include "field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
pack_glv_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx, const int32_t* __restrict__ y,
                int sy, const uint8_t* __restrict__ inf, Fe<NL> beta, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL], b[NL], ab[NL];
  fe_load(a, x, sx, i);
  fe_load(b, y, sy, i);
  fe_mul(ab, a, beta.v, F);
  int S = 2 * N;
  int32_t flag = inf[i] != 0;
  fe_store(out, S, i, a);
  fe_store(out, S, N + i, ab);
  fe_store(out + (size_t)NL * S, S, i, b);
  fe_store(out + (size_t)NL * S, S, N + i, b);
  out[(size_t)2 * NL * S + i] = flag;
  out[(size_t)2 * NL * S + N + i] = flag;
}

template <int NL>
static int launch(void* out, const void* x, int sx, const void* y, int sy, const void* inf,
                  const uint32_t* beta, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    pack_glv_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, (const int32_t*)y, sy, (const uint8_t*)inf, fe_from<NL>(beta),
        field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_pack_glv(void* out, const void* x, int sx, const void* y, int sy, const void* inf,
                            const uint32_t* beta, const uint32_t* field, int N, void* stream) {
  return launch<12>(out, x, sx, y, sy, inf, beta, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_pack_glv_n13(void* out, const void* x, int sx, const void* y, int sy, const void* inf,
                                const uint32_t* beta, const uint32_t* field, int N, void* stream) {
  return launch<13>(out, x, sx, y, sy, inf, beta, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_pack_glv_n9(void* out, const void* x, int sx, const void* y, int sy, const void* inf,
                               const uint32_t* beta, const uint32_t* field, int N, void* stream) {
  return launch<9>(out, x, sx, y, sy, inf, beta, field, N, stream);
}
#endif
