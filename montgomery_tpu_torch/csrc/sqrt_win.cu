// Kernel 17: one 4-bit window of the 2-Sylow discrete log of FieldOps.sqrt.
//
// Replaces the Pallas kernel "sqrt_win_{M}_{k}_{lk}" of
// montgomery_tpu/ops/field.py (FieldOps._sqrt_window_formula, :859-914,
// driven by FieldOps.sqrt, :916-970), which was built once per window. Here
// the window k, its width lk <= 4, M and `last` are run-time parameters, so
// one binary serves every window of every field. Inputs t (the 2-Sylow part
// still to solve), r (the root so far) and s = t^(2^(M - 4k - lk)); outputs
// t', r' and the window's digit. For bit i of the window: square a copy of
// v (= s corrected by the bits found so far) lk - 1 - i times and compare it
// with one in canonical values; the bit is set where they differ, and then
// v (while later bits of the window need it) takes v g^(-2^(M - lk + i)),
// t (unless this is the last window) t g^(-2^j) and r (from bit position
// j = 4k + i >= 1 on) r g^(-2^(j - 1)), exactly the JAX package's indices.
// Entry points: msm_sqrt_win (12 limbs), msm_sqrt_win_n13 (13 limbs:
// BLS12-381's one window of lk = 1) and msm_sqrt_win_n9 (9 limbs).
//
// Bound on this card: lk (lk - 1) / 2 squarings and up to 3 lk products per
// lane against 20 NL + 4 bytes moved: integer multiply throughput. Design:
// one thread per lane; the M x NL words of g^(-2^j) (Montgomery form) sit in
// a device buffer, 2.2 KB at NL = 12, and every lane of a warp reads the
// same row, so each read is one broadcast through the L1 cache; the
// corrections depend on the lane's bit, so each is computed and then
// selected (no divergence), as the JAX formula does.
#include "field.cuh"

template <int NL>
__device__ __forceinline__ void load_row(uint32_t (&g)[NL], const uint32_t* __restrict__ table, int row) {
#pragma unroll
  for (int k = 0; k < NL; k++) g[k] = __ldg(table + row * NL + k);
}

// a <- bit ? a * g : a
template <int NL>
__device__ __forceinline__ void correct(uint32_t (&a)[NL], bool bit, const uint32_t* __restrict__ table,
                                        int row, const FieldParams<NL>& F) {
  uint32_t g[NL], p[NL];
  load_row(g, table, row);
  fe_mul(p, a, g, F);
  fe_select(a, bit, p, a);
}

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
sqrt_win_kernel(int32_t* __restrict__ t_out, int32_t* __restrict__ r_out, int32_t* __restrict__ digit_out,
                const int32_t* __restrict__ t_in, const int32_t* __restrict__ r_in,
                const int32_t* __restrict__ s_in, const uint32_t* __restrict__ g_table, Fe<NL> one, int k,
                int lk, int M, int last, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t t[NL], r[NL], v[NL], chk[NL];
  fe_load(t, t_in, N, i);
  fe_load(r, r_in, N, i);
  fe_load(v, s_in, N, i);
  int digit = 0;
  for (int b = 0; b < lk; b++) {
#pragma unroll
    for (int q = 0; q < NL; q++) chk[q] = v[q];
    for (int q = 0; q < lk - 1 - b; q++) fe_sqr(chk, chk, F);
    bool bit = !fe_is_equal(chk, one.v, F);
    digit |= (int)bit << b;
    int j = 4 * k + b;  // the bit's position in the discrete log
    if (b < lk - 1) correct(v, bit, g_table, M - lk + b, F);
    if (!last) correct(t, bit, g_table, j, F);
    if (j >= 1) correct(r, bit, g_table, j - 1, F);
  }
  fe_store(t_out, N, i, t);
  fe_store(r_out, N, i, r);
  digit_out[i] = digit;
}

template <int NL>
static int launch(void* t_out, void* r_out, void* digit_out, const void* t, const void* r, const void* s,
                  const void* g_table, const uint32_t* one, int k, int lk, int M, int last,
                  const uint32_t* field, int N, void* stream) {
  if (N > 0)
    sqrt_win_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)t_out, (int32_t*)r_out, (int32_t*)digit_out, (const int32_t*)t, (const int32_t*)r,
        (const int32_t*)s, (const uint32_t*)g_table, fe_from<NL>(one), k, lk, M, last,
        field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_sqrt_win(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                            const void* s, const void* g_table, const uint32_t* one, int k, int lk, int M,
                            int last, const uint32_t* field, int N, void* stream) {
  return launch<12>(t_out, r_out, digit_out, t, r, s, g_table, one, k, lk, M, last, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_sqrt_win_n13(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                                const void* s, const void* g_table, const uint32_t* one, int k, int lk,
                                int M, int last, const uint32_t* field, int N, void* stream) {
  return launch<13>(t_out, r_out, digit_out, t, r, s, g_table, one, k, lk, M, last, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_sqrt_win_n9(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                               const void* s, const void* g_table, const uint32_t* one, int k, int lk,
                               int M, int last, const uint32_t* field, int N, void* stream) {
  return launch<9>(t_out, r_out, digit_out, t, r, s, g_table, one, k, lk, M, last, field, N, stream);
}
#endif
