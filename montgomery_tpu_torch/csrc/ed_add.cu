// Kernel 13: the unified twisted Edwards add on planar extended coordinates,
// and the same add applied k times as a doubling, k given at run time.
//
// Replaces the Pallas kernel "ed_add" of montgomery_tpu/curves/edwards.py
// (EdwardsOps.add / _add_formula, :81-114), which served as the add and, in
// EdwardsAdapter.double_n (montgomery_tpu/msm/adapters.py:153-154), as a
// fori_loop of k doublings ed_add(P, P). Here msm_ed_add_n9 is the add (8
// planes in, 4 out: bucket reduction and window combine) and msm_ed_dbl_n9
// runs k doublings in one launch (the combine's 2^(c h) W), so the window
// combine costs one launch per level, not c h serial ones. Both instantiate
// at NL = 9, ed-on-bls12-377's base field.
//
// Bound on this card: 9 CIOS products per add (1458 32x32->64 multiplies at
// NL = 9) against 12 x 36 = 432 bytes a lane for the add; the multiplies
// bound it (about 0.18 ns of multiplies a lane at the rate that
// csrc/rates/imad_rate.cu measures, against 0.13 ns of memory at
// 3.35 TB/s). The doubling reads and writes one point per lane whatever k
// is, so it is bound by its k adds.
// Design: one thread per lane, the point in registers across all k
// doublings; the constant k = 2d rides in the parameter bank.
#include "edwards.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
ed_add_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
              int32_t* __restrict__ T3, const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
              const int32_t* __restrict__ Z1, const int32_t* __restrict__ T1, const int32_t* __restrict__ X2,
              const int32_t* __restrict__ Y2, const int32_t* __restrict__ Z2, const int32_t* __restrict__ T2,
              Fe<NL> k2d, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], z1[NL], t1[NL], x2[NL], y2[NL], z2[NL], t2[NL];
  fe_load(x1, X1, N, i);
  fe_load(y1, Y1, N, i);
  fe_load(z1, Z1, N, i);
  fe_load(t1, T1, N, i);
  fe_load(x2, X2, N, i);
  fe_load(y2, Y2, N, i);
  fe_load(z2, Z2, N, i);
  fe_load(t2, T2, N, i);
  ed_add(x1, y1, z1, t1, x1, y1, z1, t1, x2, y2, z2, t2, k2d, F);
  fe_store(X3, N, i, x1);
  fe_store(Y3, N, i, y1);
  fe_store(Z3, N, i, z1);
  fe_store(T3, N, i, t1);
}

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
ed_dbl_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
              int32_t* __restrict__ T3, const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
              const int32_t* __restrict__ Z1, const int32_t* __restrict__ T1, int k, Fe<NL> k2d,
              FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x[NL], y[NL], z[NL], t[NL];
  fe_load(x, X1, N, i);
  fe_load(y, Y1, N, i);
  fe_load(z, Z1, N, i);
  fe_load(t, T1, N, i);
  for (int r = 0; r < k; r++) ed_add(x, y, z, t, x, y, z, t, x, y, z, t, k2d, F);
  fe_store(X3, N, i, x);
  fe_store(Y3, N, i, y);
  fe_store(Z3, N, i, z);
  fe_store(T3, N, i, t);
}

extern "C" int msm_ed_add_n9(void* X3, void* Y3, void* Z3, void* T3, const void* X1, const void* Y1,
                             const void* Z1, const void* T1, const void* X2, const void* Y2, const void* Z2,
                             const void* T2, const uint32_t* k2d, const uint32_t* field, int N, void* stream) {
  if (N > 0)
    ed_add_kernel<9><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (int32_t*)T3, (const int32_t*)X1, (const int32_t*)Y1,
        (const int32_t*)Z1, (const int32_t*)T1, (const int32_t*)X2, (const int32_t*)Y2, (const int32_t*)Z2,
        (const int32_t*)T2, fe_from<9>(k2d), field_from<9>(field), N);
  return (int)cudaGetLastError();
}

extern "C" int msm_ed_dbl_n9(void* X3, void* Y3, void* Z3, void* T3, const void* X1, const void* Y1,
                             const void* Z1, const void* T1, int k, const uint32_t* k2d, const uint32_t* field,
                             int N, void* stream) {
  if (N > 0)
    ed_dbl_kernel<9><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (int32_t*)T3, (const int32_t*)X1, (const int32_t*)Y1,
        (const int32_t*)Z1, (const int32_t*)T1, k, fe_from<9>(k2d), field_from<9>(field), N);
  return (int)cudaGetLastError();
}
