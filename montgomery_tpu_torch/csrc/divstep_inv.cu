// Kernel 22: plain-domain inverse by constant-iteration safegcd
// (Bernstein-Yang divsteps), canonical values in [0, p) to x^-1 mod p in
// [0, p), 0 -> 0.
//
// Replaces the Pallas kernel "divstep_inv" of montgomery_tpu/ops/divstep.py
// (inv_divstep, :231-246, over _inv_formula): the safegcd inverse of plain
// values, which inv_divstep and inv_mont_divstep (ops/divstep.py) launch and
// the micro-benchmark times at 2^18 lanes. Per lane: the safegcd core of
// csrc/divstep.cuh, the same lane body as divstep_inv_mont without its two
// Montgomery products. Entry points: msm_divstep_inv (NL = 12, BLS12-377)
// and msm_divstep_inv_n9 (NL = 9). The config is the DivstepConst<NL> of
// divstep_inv_mont; this kernel does not read its r2.
//
// Bound on this card: per lane 37 batches (BLS12-377) of 30 dependent
// divsteps on 64-bit words and four 13-limb matrix applications (about 264
// 64-bit products a batch) against 96 bytes moved, so integer multiply
// throughput and the serial divstep chain bound it, never memory. Four
// int64 arrays of DS_L limbs per lane put the register count above 100,
// which caps occupancy at wide launches. Design: one thread per lane,
// everything in registers, as divstep_inv_mont; the batched matrix form
// touches the 390-bit numbers once per 30 divsteps.
#include "divstep.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
divstep_inv_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx, DivstepConst<NL> C, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t t[NL], inv[NL];
  fe_load(t, x, sx, i);
  ds_inverse(inv, t, C);
  fe_store(out, N, i, inv);
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
