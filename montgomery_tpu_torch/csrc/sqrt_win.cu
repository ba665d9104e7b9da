// Kernel 17: one 4-bit window of the 2-Sylow discrete log of FieldOps.sqrt,
// as a table lookup.
//
// Replaces the Pallas kernel "sqrt_win_{M}_{k}_{lk}" of
// montgomery_tpu/ops/field.py (FieldOps._sqrt_window_formula, :859-914,
// driven by FieldOps.sqrt, :916-970), which was built once per window and
// found the window's digit bit by bit: lk (lk - 1) / 2 squarings, lk compares
// with one and every correction product of every bit (up to 3 lk), each
// computed on every lane and selected. Inputs t (the 2-Sylow part still to
// solve), r (the root so far) and s = t^(2^(M - 4k - lk)); outputs t', r' and
// the window's digit d. Once the earlier windows have corrected t, s equals
// zeta^d with zeta = g^(2^(M - lk)) a primitive 2^lk-th root of unity (g
// generates the 2-Sylow subgroup, of order 2^M), and the JAX formula's
// per-bit corrections fold into one product each, since g has order 2^M:
//   t' = t g^(-d 2^(4k))               (none on the last window)
//   r' = r g^(-floor(d 2^(4k) / 2))    (at k = 0: without the parity bit)
// Both are unique mod p, so t', r' and d are the JAX package's values (the
// reference's table-based sqrt, field-sqrt.ts:113-265, which the TPU turned
// into masked products). The host builds the 3 x 2^lk rows of each window
// once (FieldOps.sqrt_window_rows): the t rows, the r rows and the compare
// values zeta^d in canonical Montgomery form, row j's NL words at j NL.
// A lane whose s matches no compare value is not in the state the earlier
// windows leave: its digit is -1 and t, r pass through unchanged (the plain
// version does the same). Entry points: msm_sqrt_win (12 limbs),
// msm_sqrt_win_n13 (13 limbs: BLS12-381's one window of lk = 1) and
// msm_sqrt_win_n9 (9 limbs), and msm_sqrt_win_n1, _n2, _n3 (the example
// fields small, M = 2: one window of lk = 2; babybear, M = 1: one of lk = 1;
// goldilocks, M = 32: eight of lk = 4); one binary serves every window of
// every field.
//
// Bound on this card: bytes. Per lane 3 planes in and 2 planes plus the
// digit out (244 B at NL = 12) against two products (one on the last
// window): 0.19 ms of memory at 2,621,456 lanes and 3.35 TB/s, about as much
// as the products' multiplies. Design: one thread per lane; the window's
// rows go into shared memory once per block (48 rows of NL words at lk = 4:
// 2.3 KB at NL = 12); s is made canonical by one conditional subtraction,
// then compared with all 2^lk values, branch-free (every lane reads the same
// word: a broadcast); d = 0 selects the rows for one, so the products are
// computed on every lane and stay products (no select but the no-match one,
// no branch on the value).
#include "field.cuh"

#define SQRT_WIN_THREADS 256
#define SQRT_WIN_MAX_ROWS 16  // 2^lk for lk <= 4

template <int NL>
__global__ void __launch_bounds__(SQRT_WIN_THREADS)
sqrt_win_kernel(int32_t* __restrict__ t_out, int32_t* __restrict__ r_out, int32_t* __restrict__ digit_out,
                const int32_t* __restrict__ t_in, const int32_t* __restrict__ r_in,
                const int32_t* __restrict__ s_in, const uint32_t* __restrict__ table, int lk, int last,
                FieldParams<NL> F, int N) {
  __shared__ uint32_t rows[3 * SQRT_WIN_MAX_ROWS * NL];
  const int nrow = 1 << lk;
  for (int j = threadIdx.x; j < 3 * nrow * NL; j += blockDim.x) rows[j] = table[j];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t s[NL];
  fe_load(s, s_in, N, i);
  fe_reduce(s, s, F);
  const uint32_t* cmp = rows + 2 * nrow * NL;
  int digit = -1;
#pragma unroll 4
  for (int d = 0; d < nrow; d++) {
    uint32_t diff = 0;
#pragma unroll
    for (int q = 0; q < NL; q++) diff |= s[q] ^ cmp[d * NL + q];
    digit = diff == 0 ? d : digit;
  }
  const bool hit = digit >= 0;
  const int row = hit ? digit : 0;
  uint32_t a[NL], g[NL], prod[NL];
  fe_load(a, t_in, N, i);
  if (!last) {
#pragma unroll
    for (int q = 0; q < NL; q++) g[q] = rows[row * NL + q];
    fe_mul(prod, a, g, F);
    fe_select(a, hit, prod, a);
  }
  fe_store(t_out, N, i, a);
  fe_load(a, r_in, N, i);
#pragma unroll
  for (int q = 0; q < NL; q++) g[q] = rows[(nrow + row) * NL + q];
  fe_mul(prod, a, g, F);
  fe_select(a, hit, prod, a);
  fe_store(r_out, N, i, a);
  digit_out[i] = digit;
}

template <int NL>
static int launch(void* t_out, void* r_out, void* digit_out, const void* t, const void* r, const void* s,
                  const void* table, int lk, int last, const uint32_t* field, int N, void* stream) {
  if (lk < 1 || lk > 4) return (int)cudaErrorInvalidValue;
  if (N > 0)
    sqrt_win_kernel<NL><<<(N + SQRT_WIN_THREADS - 1) / SQRT_WIN_THREADS, SQRT_WIN_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (int32_t*)t_out, (int32_t*)r_out, (int32_t*)digit_out, (const int32_t*)t, (const int32_t*)r,
        (const int32_t*)s, (const uint32_t*)table, lk, last, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_sqrt_win(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                            const void* s, const void* table, int lk, int last, const uint32_t* field, int N,
                            void* stream) {
  return launch<12>(t_out, r_out, digit_out, t, r, s, table, lk, last, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_sqrt_win_n13(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                                const void* s, const void* table, int lk, int last, const uint32_t* field,
                                int N, void* stream) {
  return launch<13>(t_out, r_out, digit_out, t, r, s, table, lk, last, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_sqrt_win_n9(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                               const void* s, const void* table, int lk, int last, const uint32_t* field,
                               int N, void* stream) {
  return launch<9>(t_out, r_out, digit_out, t, r, s, table, lk, last, field, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_sqrt_win_n1(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                               const void* s, const void* table, int lk, int last, const uint32_t* field,
                               int N, void* stream) {
  return launch<1>(t_out, r_out, digit_out, t, r, s, table, lk, last, field, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_sqrt_win_n2(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                               const void* s, const void* table, int lk, int last, const uint32_t* field,
                               int N, void* stream) {
  return launch<2>(t_out, r_out, digit_out, t, r, s, table, lk, last, field, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_sqrt_win_n3(void* t_out, void* r_out, void* digit_out, const void* t, const void* r,
                               const void* s, const void* table, int lk, int last, const uint32_t* field,
                               int N, void* stream) {
  return launch<3>(t_out, r_out, digit_out, t, r, s, table, lk, last, field, N, stream);
}
#endif
