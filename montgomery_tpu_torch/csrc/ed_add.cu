// Kernel 13: the unified twisted Edwards add on planar extended coordinates,
// and the same add applied k times as a doubling, k given at run time.
//
// Replaces the Pallas kernel "ed_add" of montgomery_tpu/curves/edwards.py
// (EdwardsOps.add / _add_formula, :81-114), which served as the add and, in
// EdwardsAdapter.double_n (montgomery_tpu/msm/adapters.py:153-154), as a
// fori_loop of k doublings ed_add(P, P). Here msm_ed_add_n9 is the add (8
// planes in, 4 out: the window sums' trees and scans) and msm_ed_dbl_n9
// runs k doublings in one launch. Both instantiate at NL = 9,
// ed-on-bls12-377's base field.
//
// Bound on this card: 9 products per add (1458 32x32->64 multiplies at
// NL = 9) against 12 x 36 = 432 bytes a lane, so the multiplies bound a
// launch that fills the card; but the Twisted Edwards MSM launches the add
// on 20 to 40,960 lanes and the doubling on 20 (k = 6), below one wave of
// one-thread lanes, where the chain of 9 dependent products in one thread
// (0.52 us each on carry chains at NL = 9) is the time. The products fall
// into three dependent stages, {A, B, ZZ, k T1} | {C} | {X3, Y3, Z3, T3}.
// Two bodies (the launch's `few`; the wrapper picks one by lane count,
// EdwardsOps.FEW_ADD_LANES / FEW_DBL_LANES), equal bit for bit (the same
// field operations on the same values; fe_mul_cc equals fe_mul):
// - wide: one thread a lane on edwards.cuh's ed_add<9, CarryChainMul>;
// - few (narrow launches): four neighbouring threads of a warp a lane,
//   thread r the r-th product of stages 1 and 3 on fe_mul_cc and thread 3
//   stage 2's, the stages' values gathered by warp shuffles, so a lane's
//   chain is 3 products and a launch has 4 threads a lane to hide it. On an
//   H100 at 700 W (chip_smoke.py `redesign_ed_add`) it takes 4.0-4.4 us a
//   launch from 1 to 1,280 lanes against 6.8-7.6 for the wide body and
//   8.6-9.7 for the parent's CIOS body; the two cross between 20,480 and
//   40,960 lanes (the four-thread body issues 12 product slots for 9 products).
//   A block a lane on coop_ed_add was timed too and lost from 640 lanes up.
#include "edwards.cuh"

#define QUAD_BLOCK 128  // the few body: 32 lanes a block, four threads a lane

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
  ed_add<NL, CarryChainMul>(x1, y1, z1, t1, x1, y1, z1, t1, x2, y2, z2, t2, k2d, F);
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
  for (int r = 0; r < k; r++) ed_add<NL, CarryChainMul>(x, y, z, t, x, y, z, t, x, y, z, t, k2d, F);
  fe_store(X3, N, i, x);
  fe_store(Y3, N, i, y);
  fe_store(Z3, N, i, z);
  fe_store(T3, N, i, t);
}

// ----------------------------------------- few body: four threads a lane

// v of thread `src` of the warp, word by word (every thread of the warp
// calls it)
template <int NL>
__device__ __forceinline__ void quad_get(uint32_t (&r)[NL], const uint32_t (&v)[NL], int src) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = __shfl_sync(COOP_FULL, v[k], src);
}

// stages 2 and 3 of the add on a lane's four threads, thread `role` of
// them (base: the warp lane of role 0): r holds the thread's stage-1
// product (A, B, ZZ, k T1 by role); t2 is T2 on role 3. On return r holds
// the thread's output coordinate (X3, Y3, Z3, T3 by role).
template <int NL>
__device__ __forceinline__ void quad_stages_23(uint32_t (&r)[NL], const uint32_t (&t2)[NL], int role, int base,
                                               const FieldParams<NL>& F) {
  if (role == 3) fe_mul_cc(r, r, t2, F);  // C = (k T1) T2
  uint32_t A[NL], B[NL], ZZ[NL], C[NL], D[NL], u[NL], v[NL];
  quad_get(A, r, base);
  quad_get(B, r, base + 1);
  quad_get(ZZ, r, base + 2);
  quad_get(C, r, base + 3);
  fe_add_lazy(D, ZZ, ZZ);
  // X3 = E F, Y3 = G H, Z3 = F G, T3 = E H with E = B - A, F = D - C,
  // G = D + C, H = B + A
  if (role == 0) {
    fe_sub_lazy(u, B, A, F);
    fe_sub_lazy(v, D, C, F);
  } else if (role == 1) {
    fe_add_lazy(u, D, C);
    fe_add_lazy(v, B, A);
  } else if (role == 2) {
    fe_sub_lazy(u, D, C, F);
    fe_add_lazy(v, D, C);
  } else {
    fe_sub_lazy(u, B, A, F);
    fe_add_lazy(v, B, A);
  }
  fe_mul_cc(r, u, v, F);
}

template <int NL>
__global__ void __launch_bounds__(QUAD_BLOCK)
ed_add_few_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                    int32_t* __restrict__ T3, const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                    const int32_t* __restrict__ Z1, const int32_t* __restrict__ T1,
                    const int32_t* __restrict__ X2, const int32_t* __restrict__ Y2,
                    const int32_t* __restrict__ Z2, const int32_t* __restrict__ T2, Fe<NL> k2d,
                    FieldParams<NL> F, int N) {
  int role = threadIdx.x & 3, base = threadIdx.x & 28;
  int i = blockIdx.x * (QUAD_BLOCK / 4) + (threadIdx.x >> 2);
  bool live = i < N;  // a dead lane's threads still take part in the shuffles
  uint32_t u[NL], v[NL], r[NL], t2[NL];
  if (!live) {
#pragma unroll
    for (int k = 0; k < NL; k++) u[k] = v[k] = t2[k] = 0;
  } else if (role < 2) {  // A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2)
    uint32_t a[NL], b[NL];
    fe_load(a, Y1, N, i);
    fe_load(b, X1, N, i);
    if (role == 0) fe_sub_lazy(u, a, b, F);
    else fe_add_lazy(u, a, b);
    fe_load(a, Y2, N, i);
    fe_load(b, X2, N, i);
    if (role == 0) fe_sub_lazy(v, a, b, F);
    else fe_add_lazy(v, a, b);
  } else if (role == 2) {  // ZZ = Z1 Z2
    fe_load(u, Z1, N, i);
    fe_load(v, Z2, N, i);
  } else {  // k T1, then C = (k T1) T2
    fe_load(u, T1, N, i);
    fe_load(t2, T2, N, i);
#pragma unroll
    for (int k = 0; k < NL; k++) v[k] = k2d.v[k];
  }
  fe_mul_cc(r, u, v, F);
  quad_stages_23(r, t2, role, base, F);
  if (live) fe_store(role == 0 ? X3 : role == 1 ? Y3 : role == 2 ? Z3 : T3, N, i, r);
}

template <int NL>
__global__ void __launch_bounds__(QUAD_BLOCK)
ed_dbl_few_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                    int32_t* __restrict__ T3, const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                    const int32_t* __restrict__ Z1, const int32_t* __restrict__ T1, int k, Fe<NL> k2d,
                    FieldParams<NL> F, int N) {
  int role = threadIdx.x & 3, base = threadIdx.x & 28;
  int i = blockIdx.x * (QUAD_BLOCK / 4) + (threadIdx.x >> 2);
  bool live = i < N;
  // roles 0, 1 carry X (p1) and Y (p2), role 2 Z, role 3 T (p1)
  uint32_t p1[NL], p2[NL], u[NL], v[NL], r[NL];
#pragma unroll
  for (int w = 0; w < NL; w++) p1[w] = p2[w] = 0;
  if (live) {
    fe_load(p1, role < 2 ? X1 : role == 2 ? Z1 : T1, N, i);
    if (role < 2) fe_load(p2, Y1, N, i);
  }
#pragma unroll
  for (int w = 0; w < NL; w++) r[w] = role == 1 ? p2[w] : p1[w];
  for (int s = 0; s < k; s++) {
    if (role == 0) {
      fe_sub_lazy(u, p2, p1, F);  // Y - X
    } else if (role == 1) {
      fe_add_lazy(u, p2, p1);  // Y + X
    } else {
#pragma unroll
      for (int w = 0; w < NL; w++) u[w] = p1[w];  // Z, or T
    }
#pragma unroll
    for (int w = 0; w < NL; w++) v[w] = role == 3 ? k2d.v[w] : u[w];
    fe_mul_cc(r, u, v, F);
    quad_stages_23(r, p1, role, base, F);  // role 3: C = (k T) T
    // the next doubling's inputs: X3 and Y3 to both of roles 0 and 1
    uint32_t o[NL];
    quad_get(o, r, (threadIdx.x & 31) ^ 1);
#pragma unroll
    for (int w = 0; w < NL; w++) {
      p1[w] = role == 1 ? o[w] : r[w];
      p2[w] = role == 0 ? o[w] : r[w];
    }
  }
  if (live) fe_store(role == 0 ? X3 : role == 1 ? Y3 : role == 2 ? Z3 : T3, N, i, r);
}

// ------------------------------------------------------------ entry points

extern "C" int msm_ed_add_n9(void* X3, void* Y3, void* Z3, void* T3, const void* X1, const void* Y1,
                             const void* Z1, const void* T1, const void* X2, const void* Y2, const void* Z2,
                             const void* T2, const uint32_t* k2d, const uint32_t* field, int N, int few,
                             void* stream) {
  int32_t *x3 = (int32_t*)X3, *y3 = (int32_t*)Y3, *z3 = (int32_t*)Z3, *t3 = (int32_t*)T3;
  const int32_t *x1 = (const int32_t*)X1, *y1 = (const int32_t*)Y1, *z1 = (const int32_t*)Z1,
                *t1 = (const int32_t*)T1, *x2 = (const int32_t*)X2, *y2 = (const int32_t*)Y2,
                *z2 = (const int32_t*)Z2, *t2 = (const int32_t*)T2;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0) return (int)cudaGetLastError();
  if (few)
    ed_add_few_kernel<9><<<(N + QUAD_BLOCK / 4 - 1) / (QUAD_BLOCK / 4), QUAD_BLOCK, 0, st>>>(
        x3, y3, z3, t3, x1, y1, z1, t1, x2, y2, z2, t2, fe_from<9>(k2d), field_from<9>(field), N);
  else
    ed_add_kernel<9><<<grid_for(N), LANES_PER_BLOCK, 0, st>>>(x3, y3, z3, t3, x1, y1, z1, t1, x2, y2, z2, t2,
                                                              fe_from<9>(k2d), field_from<9>(field), N);
  return (int)cudaGetLastError();
}

extern "C" int msm_ed_dbl_n9(void* X3, void* Y3, void* Z3, void* T3, const void* X1, const void* Y1,
                             const void* Z1, const void* T1, int k, const uint32_t* k2d, const uint32_t* field, int N,
                             int few, void* stream) {
  int32_t *x3 = (int32_t*)X3, *y3 = (int32_t*)Y3, *z3 = (int32_t*)Z3, *t3 = (int32_t*)T3;
  const int32_t *x1 = (const int32_t*)X1, *y1 = (const int32_t*)Y1, *z1 = (const int32_t*)Z1,
                *t1 = (const int32_t*)T1;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0) return (int)cudaGetLastError();
  if (few)
    ed_dbl_few_kernel<9><<<(N + QUAD_BLOCK / 4 - 1) / (QUAD_BLOCK / 4), QUAD_BLOCK, 0, st>>>(
        x3, y3, z3, t3, x1, y1, z1, t1, k, fe_from<9>(k2d), field_from<9>(field), N);
  else
    ed_dbl_kernel<9><<<grid_for(N), LANES_PER_BLOCK, 0, st>>>(x3, y3, z3, t3, x1, y1, z1, t1, k, fe_from<9>(k2d),
                                                              field_from<9>(field), N);
  return (int)cudaGetLastError();
}
