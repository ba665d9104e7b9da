// Kernel 6: Montgomery-form inverse by safegcd (Bernstein-Yang divsteps),
// 0 -> 0, one warp a lane.
//
// Replaces the Pallas kernel "divstep_inv_mont" of montgomery_tpu/ops/field.py
// (FieldOps.inv_root, :724-761, over ops/divstep.py _inv_formula): the root of
// every batch inversion, at most 512 lanes (FieldOps.BATCH_INV_STOP). Per
// lane: leave Montgomery form (a product by 1: [0, p], p only where x = 0
// mod p), run the divsteps, re-enter Montgomery form (a product by R^2 with
// this port's R = 2^(32 NL)). Entry points: msm_divstep_inv_mont (NL = 12,
// BLS12-377), msm_divstep_inv_mont_n13 (NL = 13, BLS12-381: 14 limbs of 30
// bits) and msm_divstep_inv_mont_n9 (NL = 9: Pallas, and ed-on-bls12-377,
// where it is the root of to_host's batch inversion), and
// msm_divstep_inv_mont_n1, _n2, _n3 (the example fields small, babybear and
// goldilocks: 2, 3 and 4 limbs of 30 bits, 1, 4 and 7 batches at most; the
// warp's products on 2, 4 and 6 lanes).
//
// Bound on this card: latency, not throughput. At most 512 lanes run one
// serial chain each: about 28 batches of 30 dependent divsteps and a matrix
// application (19 on the 255-bit fields), and two Montgomery products. One
// thread a lane (as this kernel was first ported: 68.5 us at 512 lanes)
// filled 4 blocks on 4 of the 132 SMs and carried each 13-limb application
// serially in one thread, on int64 limbs, for always the proven 37 batches.
// Design: one warp a lane (512 warps, a wave over the card). Lane j of the
// warp holds limb j of f, g, d and e (csrc/divstep.cuh, the 32-bit core);
// every lane runs the same branch-free divsteps on limb 0's words
// (shuffled to all, so the warp never diverges), forms its own limb's
// products, and hands carries to its neighbours by two shuffle rounds; the
// loop ends once g = 0 (__all_sync); the end's subtractions of 2^j p run a
// word a lane. The two Montgomery products run on the warp (coop_mul,
// csrc/coop.cuh: bit for bit fe_mul's). Four warps a block share the
// constants in shared memory. A launch then takes about the batches of its
// slowest lane times a warp batch's latency (chip_smoke.py's floor).
#include "divstep.cuh"

#define INV_WARPS 4  // lanes (warps) a block

template <int NL>
__global__ void __launch_bounds__(32 * INV_WARPS)
divstep_inv_mont_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx, DivstepConst<NL> C,
                        FieldParams<NL> F, Fe<NL> mu, int N) {
  __shared__ CoopConsts<NL> K;
  __shared__ uint32_t r2[NL], one[NL], buf[INV_WARPS][NL];
  coop_load_consts(K, F, mu);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NL; k++) {
      r2[k] = C.r2[k];
      one[k] = k == 0;
    }
  }
  __syncthreads();
  int w = threadIdx.x >> 5, j = warp_lane();
  int i = blockIdx.x * INV_WARPS + w;
  if (i >= N) return;  // the whole warp
  uint32_t* a = buf[w];
  if (j < NL) a[j] = (uint32_t)x[(size_t)j * sx + i];
  __syncwarp();
  coop_mul(a, a, one, K);  // out of Montgomery form, in [0, p]
  __syncwarp();
  bool zero = __all_sync(COOP_FULL, j >= NL || a[j] == 0) || __all_sync(COOP_FULL, j >= NL || a[j] == K.p[j]);
  uint32_t inv = ds_inverse_warp(a, zero, j < NL ? K.p[j] : 0u, C);
  __syncwarp();
  if (j < NL) a[j] = inv;
  __syncwarp();
  coop_mul(a, a, r2, K);  // back to Montgomery form, in [0, 2p)
  __syncwarp();
  if (j < NL) out[(size_t)j * N + i] = (int32_t)a[j];
}

// the wrapper asks for `blocks` blocks of INV_WARPS warps (ops/divstep.py
// INV_MONT_LANES_PER_BLOCK); too few for N lanes is refused
template <int NL>
static int launch(void* out, const void* x, int sx, const int32_t* cfg, const uint32_t* field, const uint32_t* mu,
                  int N, int blocks, void* stream) {
  if ((int64_t)blocks * INV_WARPS < N) return (int)cudaErrorInvalidValue;
  if (N > 0)
    divstep_inv_mont_kernel<NL><<<blocks, 32 * INV_WARPS, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, divstep_from<NL>(cfg), field_from<NL>(field), fe_from<NL>(mu), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_divstep_inv_mont(void* out, const void* x, int sx, const int32_t* cfg, const uint32_t* field,
                                    const uint32_t* mu, int N, int blocks, void* stream) {
  return launch<12>(out, x, sx, cfg, field, mu, N, blocks, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_divstep_inv_mont_n13(void* out, const void* x, int sx, const int32_t* cfg,
                                        const uint32_t* field, const uint32_t* mu, int N, int blocks, void* stream) {
  return launch<13>(out, x, sx, cfg, field, mu, N, blocks, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_divstep_inv_mont_n9(void* out, const void* x, int sx, const int32_t* cfg,
                                       const uint32_t* field, const uint32_t* mu, int N, int blocks, void* stream) {
  return launch<9>(out, x, sx, cfg, field, mu, N, blocks, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_divstep_inv_mont_n1(void* out, const void* x, int sx, const int32_t* cfg,
                                       const uint32_t* field, const uint32_t* mu, int N, int blocks, void* stream) {
  return launch<1>(out, x, sx, cfg, field, mu, N, blocks, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_divstep_inv_mont_n2(void* out, const void* x, int sx, const int32_t* cfg,
                                       const uint32_t* field, const uint32_t* mu, int N, int blocks, void* stream) {
  return launch<2>(out, x, sx, cfg, field, mu, N, blocks, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_divstep_inv_mont_n3(void* out, const void* x, int sx, const int32_t* cfg,
                                       const uint32_t* field, const uint32_t* mu, int N, int blocks, void* stream) {
  return launch<3>(out, x, sx, cfg, field, mu, N, blocks, stream);
}
#endif
