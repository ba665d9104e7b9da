// The bit-by-bit sqrt window that csrc/sqrt_win.cu replaced, kept as a probe
// so that chip_smoke.py can time the table lookup against it in turns on one
// card. Not part of the kernels' library: it is built on its own, beside it.
//
// The JAX package's _sqrt_window_formula (montgomery_tpu/ops/field.py:859-914)
// in one thread a lane: for bit i of the window, square a copy of v (s
// corrected by the bits found so far) lk - 1 - i times and compare it with
// one; where they differ the bit is set, and v (while later bits need it),
// t (unless last) and r (from bit position 4k + i >= 1) take their products
// with g^(-2^j), computed on every lane and selected. The M x NL words of
// g^(-2^j) (Montgomery form) sit in a device buffer; every lane of a warp
// reads the same row (a broadcast through the L1 cache). Its outputs equal
// the table lookup's as field elements wherever the input is a state the
// earlier windows leave.
#include "../field.cuh"

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

// one window on N lanes at 12 limbs (nl = 12) or 9 (nl = 9); the arguments
// of the parent's msm_sqrt_win. Returns cudaGetLastError().
extern "C" int sqrt_win_bitwise(int nl, void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                                const void* s, const void* g_table, const uint32_t* one, int k, int lk, int M,
                                int last, const uint32_t* field, int N, void* stream) {
  if (nl == 12)
    return launch<12>(t_out, r_out, digit_out, t, r, s, g_table, one, k, lk, M, last, field, N, stream);
  if (nl == 9)
    return launch<9>(t_out, r_out, digit_out, t, r, s, g_table, one, k, lk, M, last, field, N, stream);
  return (int)cudaErrorInvalidValue;
}
