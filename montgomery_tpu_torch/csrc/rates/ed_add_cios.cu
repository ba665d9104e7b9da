// The body that csrc/ed_add.cu's bodies replaced: the unified add and the
// k-fold doubling one thread a lane on field.cuh's CIOS fe_mul (the kernels
// before the carry-chain redesign, unchanged but for the product named as
// edwards.cuh's CiosMul template argument). Kept as a probe: chip_smoke.py
// builds it beside the kernels' library and runs the Twisted Edwards MSM on
// it in turns with the new bodies. Its entry points take msm_ed_add_n9's and
// msm_ed_dbl_n9's arguments (the body flag `few` is not read), so they can
// stand in for them; the results are equal bit for bit.
#include "../edwards.cuh"

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
  ed_add<NL, CiosMul>(x1, y1, z1, t1, x1, y1, z1, t1, x2, y2, z2, t2, k2d, F);
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
  for (int r = 0; r < k; r++) ed_add<NL, CiosMul>(x, y, z, t, x, y, z, t, x, y, z, t, k2d, F);
  fe_store(X3, N, i, x);
  fe_store(Y3, N, i, y);
  fe_store(Z3, N, i, z);
  fe_store(T3, N, i, t);
}

extern "C" int probe_ed_add_n9(void* X3, void* Y3, void* Z3, void* T3, const void* X1, const void* Y1,
                               const void* Z1, const void* T1, const void* X2, const void* Y2, const void* Z2,
                               const void* T2, const uint32_t* k2d, const uint32_t* field, int N, int few,
                               void* stream) {
  (void)few;
  if (N > 0)
    ed_add_kernel<9><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (int32_t*)T3, (const int32_t*)X1, (const int32_t*)Y1,
        (const int32_t*)Z1, (const int32_t*)T1, (const int32_t*)X2, (const int32_t*)Y2, (const int32_t*)Z2,
        (const int32_t*)T2, fe_from<9>(k2d), field_from<9>(field), N);
  return (int)cudaGetLastError();
}

extern "C" int probe_ed_dbl_n9(void* X3, void* Y3, void* Z3, void* T3, const void* X1, const void* Y1,
                               const void* Z1, const void* T1, int k, const uint32_t* k2d, const uint32_t* field, int N,
                               int few, void* stream) {
  (void)few;
  if (N > 0)
    ed_dbl_kernel<9><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (int32_t*)T3, (const int32_t*)X1, (const int32_t*)Y1,
        (const int32_t*)Z1, (const int32_t*)T1, k, fe_from<9>(k2d), field_from<9>(field), N);
  return (int)cudaGetLastError();
}
