// Kernel 6: Montgomery-form inverse by constant-iteration safegcd
// (Bernstein-Yang divsteps), 0 -> 0.
//
// Replaces the Pallas kernel "divstep_inv_mont" of montgomery_tpu/ops/field.py
// (FieldOps.inv_root, :724-761, over ops/divstep.py _inv_formula): the root of
// every batch inversion, at most 512 lanes. Per lane: leave Montgomery form
// (a product by 1, then reduce into [0, p)), run the divsteps, re-enter
// Montgomery form (a product by R^2 with this port's R = 2^(32 NL)). Entry
// points: msm_divstep_inv_mont (NL = 12, BLS12-377),
// msm_divstep_inv_mont_n13 (NL = 13, BLS12-381: 14 limbs of 30 bits) and
// msm_divstep_inv_mont_n9 (NL = 9: Pallas, and ed-on-bls12-377, where it is
// the root of to_host's batch inversion).
//
// The safegcd core (csrc/divstep.cuh, shared with kernel divstep_inv) runs
// between the two products.
//
// Bound on this card: a serial chain of 1110 divsteps per lane (a few
// dependent integer operations each) and 37 matrix applications of about
// 130 64-bit products; 512 lanes fill 4 blocks on 4 of the 132 SMs, so the
// launch is latency bound, not throughput bound. It runs once per batch
// inversion. Design: one thread per lane, everything in registers; the
// batched matrix form touches the 390-bit numbers once per 30 divsteps.
#include "divstep.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
divstep_inv_mont_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx, DivstepConst<NL> C,
                        FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL], t[NL], one[NL];
  fe_load(a, x, sx, i);
#pragma unroll
  for (int k = 0; k < NL; k++) one[k] = k == 0;
  fe_mul(t, a, one, F);  // out of Montgomery form, in [0, p]
  uint32_t br = limbs_sub(a, t, F.p);
  fe_select(t, br, t, a);  // [0, p)
  uint32_t inv[NL];
  ds_inverse(inv, t, C);
  fe_mul(a, inv, C.r2, F);  // back to Montgomery form, in [0, 2p)
  fe_store(out, N, i, a);
}

template <int NL>
static int launch(void* out, const void* x, int sx, const int32_t* cfg, const uint32_t* field, int N,
                  void* stream) {
  if (N > 0)
    divstep_inv_mont_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, divstep_from<NL>(cfg), field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_divstep_inv_mont(void* out, const void* x, int sx, const int32_t* cfg, const uint32_t* field,
                                    int N, void* stream) {
  return launch<12>(out, x, sx, cfg, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_divstep_inv_mont_n13(void* out, const void* x, int sx, const int32_t* cfg,
                                        const uint32_t* field, int N, void* stream) {
  return launch<13>(out, x, sx, cfg, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_divstep_inv_mont_n9(void* out, const void* x, int sx, const int32_t* cfg,
                                       const uint32_t* field, int N, void* stream) {
  return launch<9>(out, x, sx, cfg, field, N, stream);
}
#endif
