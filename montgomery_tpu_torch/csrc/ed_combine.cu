// Kernel 29: the Twisted Edwards window combine S = sum_k 2^(c k) W_k of K
// window sums, in one launch (the counterpart of proj_combine_rcb.cu for the
// Edwards group).
//
// Replaces the log-depth combine of montgomery_tpu/msm/pippenger.py
// (combine_windows, :508-540) on the Edwards group, which ran one "ed_add"
// Pallas kernel (montgomery_tpu/curves/edwards.py:87) a level and
// EdwardsAdapter.double_n, a fori_loop of ed_add(P, P)
// (montgomery_tpu/msm/adapters.py:153-154): log2(K) levels of c K / 2,
// c K / 4, ... doublings on 16 lanes or fewer, each doubling one thread's
// chain of 9 dependent products (the port's ed_dbl did the same, k
// doublings a launch: 403 serial doublings at c = 13, K = 20 padded to 32).
//
// Bound on this card: latency. The MSM combines one point; its multiplies
// are microseconds of work on one SM, but every doubling waits on the one
// before. Design: Horner order, acc = W_{K-1}; for k = K-2 .. 0:
// acc = 2^c acc + W_k, which is (K - 1) c doublings and K - 1 adds (247 and
// 19 at c = 13, K = 20), with the point in shared memory from the first
// window to the store. One block of 5 warps carries one combine: warps 0-3
// run edwards.cuh's coop_ed_add (each stage's products on separate warps,
// each product on a whole warp), so a doubling or an add is 3 dependent
// warp products; warp 4 loads the next W_k into the addend slots while the
// doublings run. The doubling is the unified add applied to (P, P), as in
// the JAX package, so the kernel equals the plain Horner
// (EdwardsOps.combine_plain) bit for bit. A W_k may be the identity
// (0 : 1 : 1 : 0): the formula is complete. 9 limbs (ed-on-bls12-377).
#include "edwards.cuh"

#define ED_COMBINE_WARPS (COOP_ED_WARPS + 1)

// point i of (4 NL, stride) planes into (X, Y, Z, T) by the threads
// t = 0 .. nthreads - 1 of the caller's choosing; the caller's barrier
// publishes it
template <int NL>
__device__ __forceinline__ void ed_load_point(uint32_t* X, uint32_t* Y, uint32_t* Z, uint32_t* T,
                                              const int32_t* PX, const int32_t* PY, const int32_t* PZ,
                                              const int32_t* PT, size_t stride, size_t i, int t,
                                              int nthreads) {
  for (int j = t; j >= 0 && j < 4 * NL; j += nthreads) {
    const int32_t* P = j < NL ? PX : j < 2 * NL ? PY : j < 3 * NL ? PZ : PT;
    uint32_t* D = j < NL ? X : j < 2 * NL ? Y : j < 3 * NL ? Z : T;
    D[j % NL] = (uint32_t)P[(size_t)(j % NL) * stride + i];
  }
}

template <int NL>
__global__ void __launch_bounds__(32 * ED_COMBINE_WARPS)
ed_combine_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                  int32_t* __restrict__ T3, const int32_t* __restrict__ WX, const int32_t* __restrict__ WY,
                  const int32_t* __restrict__ WZ, const int32_t* __restrict__ WT, int K, int c, Fe<NL> k2d,
                  Fe<NL> mu, FieldParams<NL> F, int N) {
  __shared__ CoopEdPoint<NL> S;
  size_t i = blockIdx.x, st = (size_t)N * K;  // window k of lane i at i K + k
  coop_load_consts(S.C, F, mu);
  if (threadIdx.x == 0) sm_put(S.k, k2d.v);
  ed_load_point<NL>(S.X, S.Y, S.Z, S.T, WX, WY, WZ, WT, st, i * K + K - 1, threadIdx.x, blockDim.x);
  __syncthreads();
  int loader = threadIdx.x - 32 * COOP_ED_WARPS;  // warp 4
  for (int k = K - 2; k >= 0; k--) {
    ed_load_point<NL>(S.X2, S.Y2, S.Z2, S.T2, WX, WY, WZ, WT, st, i * K + k, loader, 32);
    for (int r = 0; r < c; r++) coop_ed_add(S, S.X, S.Y, S.Z, S.T, F);
    coop_ed_add(S, S.X2, S.Y2, S.Z2, S.T2, F);
  }
  for (int j = threadIdx.x; j < 4 * NL; j += blockDim.x) {
    int32_t* P = j < NL ? X3 : j < 2 * NL ? Y3 : j < 3 * NL ? Z3 : T3;
    const uint32_t* D = j < NL ? S.X : j < 2 * NL ? S.Y : j < 3 * NL ? S.Z : S.T;
    P[(size_t)(j % NL) * N + i] = (int32_t)D[j % NL];
  }
}

extern "C" int msm_ed_combine_n9(void* X3, void* Y3, void* Z3, void* T3, const void* WX, const void* WY,
                                 const void* WZ, const void* WT, int K, int c, const uint32_t* k2d,
                                 const uint32_t* mu, const uint32_t* field, int N, void* stream) {
  if (N > 0 && K > 0 && c > 0)
    ed_combine_kernel<9><<<N, 32 * ED_COMBINE_WARPS, 0, (cudaStream_t)stream>>>(
        (int32_t*)X3, (int32_t*)Y3, (int32_t*)Z3, (int32_t*)T3, (const int32_t*)WX, (const int32_t*)WY,
        (const int32_t*)WZ, (const int32_t*)WT, K, c, fe_from<9>(k2d), fe_from<9>(mu), field_from<9>(field), N);
  return (int)cudaGetLastError();
}
