// Kernel 15: x^e for an exponent given at run time, on a sliding window.
//
// Replaces the Pallas kernel "exp_ladder_{e}" of montgomery_tpu/ops/field.py
// (FieldOps.exp_ladder / _ladder_formula, :600-670), which baked a static e
// into each kernel. Here the host turns e into a schedule once
// (ops/field.py ladder_schedule: steps of (squarings, odd digit), a window
// of w bits) and the steps ride in the launch's parameters, so one binary
// serves FieldOps.inv (e = p - 2) and the first step of FieldOps.sqrt
// (e = (q - 1) / 2). Entry points: msm_exp_ladder (12 limbs, BLS12-377's
// base field), msm_exp_ladder_n13 (13 limbs, BLS12-381's) and
// msm_exp_ladder_n9 (9 limbs, Pallas's and ed-on-bls12-377's), and
// msm_exp_ladder_n1, _n2, _n3 (the example fields small, babybear and
// goldilocks: at NL = 1 fe_mul_cc and fe_sqr_cc are field.cuh's CIOS
// product and square, madc.cuh says why).
//
// Bound on this card: the integer multiply pipe. A lane is a serial chain
// of about 330 squarings and 60 products at NL = 12 (e = (q - 1) / 2, w = 4)
// against 8 NL bytes moved. The body it replaced ran fixed 2-bit digits
// on field.cuh's CIOS
// fe_sqr and fe_mul, whose C-level 64-bit adds wait on each carry (988 other
// instructions beside 300 multiplies in one product at NL = 12). Design: one
// thread a lane (2.6 M lanes fill the card); the squarings on madc.cuh's
// fe_sqr_cc (the square on PTX carry chains, 222 products at NL = 12) and
// the products on fe_mul_cc; the table of odd powers x, x^3, ...,
// x^(2 entries - 1) in dynamic shared memory, entry x limb x lane (lane
// fastest: no bank conflicts; above 48 KB after cudaFuncSetAttribute);
// every lane walks the same steps, read from the parameter bank, so nothing
// diverges. A step's digit 0 (only trailing zeros) takes no product. The
// plain version FieldOps.exp_ladder_plain runs the same schedule, and each
// product and square equals CIOS fe_mul bit for bit, so the two agree bit
// for bit.
#include "madc.cuh"

// ops/field.py LADDER_MAX_STEPS: e < R <= 2^416 at w >= 2 takes at most 210
#define LADDER_MAX_STEPS 256

// one step a halfword: squarings << 5 | digit (an odd digit below 32, or 0)
struct LadderSteps {
  uint16_t v[LADDER_MAX_STEPS];
};

template <int NL>
__device__ __forceinline__ void tbl_put(uint32_t* tbl, int entry, int t, const uint32_t (&a)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; k++) tbl[(entry * NL + k) * LANES_PER_BLOCK + t] = a[k];
}

template <int NL>
__device__ __forceinline__ void tbl_get(uint32_t (&a)[NL], const uint32_t* tbl, int entry, int t) {
#pragma unroll
  for (int k = 0; k < NL; k++) a[k] = tbl[(entry * NL + k) * LANES_PER_BLOCK + t];
}

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
exp_ladder_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, LadderSteps steps, int nsteps,
                  int entries, FieldParams<NL> F, int N) {
  extern __shared__ uint32_t tbl[];  // each thread reads and writes its own column only
  int i = lane_index(), t = threadIdx.x;
  if (i >= N) return;
  uint32_t acc[NL], y[NL];
  fe_load(acc, x, N, i);
  tbl_put(tbl, 0, t, acc);
  if (entries > 1) {
    uint32_t x2[NL];
    fe_sqr_cc(x2, acc, F);
    for (int k = 1; k < entries; k++) {
      fe_mul_cc(acc, acc, x2, F);
      tbl_put(tbl, k, t, acc);
    }
  }
  tbl_get(acc, tbl, (steps.v[0] & 31) >> 1, t);  // the first digit d0: entry (d0 - 1) / 2
  for (int s = 1; s < nsteps; s++) {
    int sq = steps.v[s] >> 5, d = steps.v[s] & 31;
    for (int r = 0; r < sq; r++) fe_sqr_cc(acc, acc, F);
    if (d) {
      tbl_get(y, tbl, d >> 1, t);
      fe_mul_cc(acc, acc, y, F);
    }
  }
  fe_store(out, N, i, acc);
}

template <int NL>
static int launch(void* out, const void* x, const uint32_t* steps, int nsteps, int entries, const uint32_t* field,
                  int N, void* stream) {
  if (nsteps < 1 || nsteps > LADDER_MAX_STEPS || entries < 1 || entries > 16) return (int)cudaErrorInvalidValue;
  LadderSteps st;
  for (int s = 0; s < nsteps; s++) st.v[s] = (uint16_t)steps[s];
  size_t smem = (size_t)entries * NL * LANES_PER_BLOCK * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(exp_ladder_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (N > 0)
    exp_ladder_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, smem, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, st, nsteps, entries, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_exp_ladder(void* out, const void* x, const uint32_t* steps, int nsteps, int entries,
                              const uint32_t* field, int N, void* stream) {
  return launch<12>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_exp_ladder_n13(void* out, const void* x, const uint32_t* steps, int nsteps, int entries,
                                  const uint32_t* field, int N, void* stream) {
  return launch<13>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_exp_ladder_n9(void* out, const void* x, const uint32_t* steps, int nsteps, int entries,
                                 const uint32_t* field, int N, void* stream) {
  return launch<9>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_exp_ladder_n1(void* out, const void* x, const uint32_t* steps, int nsteps, int entries,
                                 const uint32_t* field, int N, void* stream) {
  return launch<1>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_exp_ladder_n2(void* out, const void* x, const uint32_t* steps, int nsteps, int entries,
                                 const uint32_t* field, int N, void* stream) {
  return launch<2>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_exp_ladder_n3(void* out, const void* x, const uint32_t* steps, int nsteps, int entries,
                                 const uint32_t* field, int N, void* stream) {
  return launch<3>(out, x, steps, nsteps, entries, field, N, stream);
}
#endif
