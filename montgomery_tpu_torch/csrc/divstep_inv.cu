// Kernel 22: plain-domain inverse by safegcd (Bernstein-Yang divsteps),
// canonical values in [0, p) to x^-1 mod p in [0, p), 0 -> 0.
//
// Replaces the Pallas kernel "divstep_inv" of montgomery_tpu/ops/divstep.py
// (inv_divstep, :231-246, over _inv_formula): the safegcd inverse of plain
// values, which inv_divstep and inv_mont_divstep (ops/divstep.py) launch and
// the micro-benchmark times at 2^18 lanes. Entry points: msm_divstep_inv
// (NL = 12, BLS12-377), msm_divstep_inv_n13 (BLS12-381), msm_divstep_inv_n9
// (NL = 9), and msm_divstep_inv_n1, _n2, _n3 (the example fields small,
// babybear and goldilocks). The config is the
// DivstepConst<NL> of divstep_inv_mont; this kernel does not read its r2.
//
// Bound on this card: integer instruction throughput. 2^18 lanes fill the
// card many times over, and per lane each batch is 30 divsteps and the
// matrix applied to four numbers of 13 limbs, against 96 bytes moved. As
// first ported, the core ran on int64 (two instructions for every 64-bit
// select, add and shift, a multi-IMAD product for each 30 x 30-bit one) in
// four int64 arrays of DS_L limbs (above 100 registers a thread, which
// capped occupancy), for always the proven 37 batches.
// Design: one thread a lane on the 32-bit core of csrc/divstep.cuh: the
// divsteps on 32-bit words in variable time (runs of zeros and up to 6 odd
// steps at once: about 7.7 rounds of a loop for 30 divsteps, fewer
// instructions though a warp's lanes diverge), the limbs in int32 (half the
// state's registers: 72 at 12 limbs, 70 at 9, no spill), one IMAD.WIDE a
// product, full carries in the thread (fewer instructions than the warp
// kernel's two-round scheme, whose range holds these limbs too); a warp
// leaves the batch loop once g = 0 on all 32 of its lanes (__all_sync), so
// lanes past N run on zeros and vote at once.
#include "divstep.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
divstep_inv_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx, DivstepConst<NL> C, int N) {
  int i = lane_index();
  uint32_t t[NL], inv[NL];
  if (i < N) {
    fe_load(t, x, sx, i);
  } else {
#pragma unroll
    for (int k = 0; k < NL; k++) t[k] = 0;
  }
  ds_inverse(inv, t, C);  // every lane of the warp: the loop votes
  if (i < N) fe_store(out, N, i, inv);
}

template <int NL>
static int launch(void* out, const void* x, int sx, const int32_t* cfg, int N, void* stream) {
  if (N > 0)
    divstep_inv_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, divstep_from<NL>(cfg), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_divstep_inv(void* out, const void* x, int sx, const int32_t* cfg, int N, void* stream) {
  return launch<12>(out, x, sx, cfg, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_divstep_inv_n9(void* out, const void* x, int sx, const int32_t* cfg, int N, void* stream) {
  return launch<9>(out, x, sx, cfg, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_divstep_inv_n13(void* out, const void* x, int sx, const int32_t* cfg, int N, void* stream) {
  return launch<13>(out, x, sx, cfg, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_divstep_inv_n1(void* out, const void* x, int sx, const int32_t* cfg, int N, void* stream) {
  return launch<1>(out, x, sx, cfg, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_divstep_inv_n2(void* out, const void* x, int sx, const int32_t* cfg, int N, void* stream) {
  return launch<2>(out, x, sx, cfg, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_divstep_inv_n3(void* out, const void* x, int sx, const int32_t* cfg, int N, void* stream) {
  return launch<3>(out, x, sx, cfg, N, stream);
}
#endif
