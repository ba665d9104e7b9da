// Latency of the safegcd core's steps on the card at hand (csrc/divstep.cuh,
// BLS12-377, NL = 12): one batch of 30 divsteps (constant time, as
// divstep_inv_mont's warps run them, and variable time, as divstep_inv's
// threads do) and one matrix application, each in one thread, and one whole batch
// on a warp as divstep_inv_mont runs it (shuffles, divsteps, its own limb's
// products, two carry rounds, the exit vote).
// chip_smoke.py multiplies the batches an input needs by these for the
// dependent-chain floors of divstep_inv_mont and divstep_inv: a lane's
// batches run one after another, however the card is used.
// Not part of the kernels' library: it is built on its own, beside it.
//
// One block of one warp runs `iters` steps, each on the result of the one
// before, and stores its state, so none is optimised away; the launch time
// over iters is the latency of one step (launch overhead amortised). The
// chains start from BLS12-377's f = p and g = the given words.
#include "../divstep.cuh"

constexpr int NL = 12;
constexpr int DS_L = ds_limbs(NL);

// which = 0 (3): 30 divsteps a step in constant (variable) time, the next
// step's words taken from this step's matrix (f kept odd, zeta kept small
// as it is in an inversion)
template <bool VAR>
__global__ void __launch_bounds__(32) divsteps_chain(int32_t* out, uint32_t f, uint32_t g, int iters) {
  if (threadIdx.x) return;
  int32_t zeta = -1;
  DsMatrix t;
  for (int i = 0; i < iters; i++) {
    zeta = VAR ? ds_divsteps_var(zeta, f, g, t) : ds_divsteps(zeta, f, g, t);
    zeta = (zeta & 7) - 4;
    f = ((uint32_t)t.u ^ (uint32_t)t.q ^ f) | 1u;
    g ^= (uint32_t)t.v + (uint32_t)t.r;
  }
  out[0] = zeta;
  out[1] = (int32_t)f;
  out[2] = (int32_t)g;
}

// which = 1: one matrix application on f, g, d, e in one thread
// (ds_update_fg and ds_update_de of divstep_inv), the matrix fixed
__global__ void __launch_bounds__(32)
apply_thread_chain(int32_t* out, Fe<NL> w, DsMatrix t, DivstepConst<NL> C, int iters) {
  if (threadIdx.x) return;
  int32_t f[DS_L], g[DS_L], d[DS_L], e[DS_L];
  words_to_l30(g, w.v);
#pragma unroll
  for (int k = 0; k < DS_L; k++) {
    f[k] = C.p[k];
    d[k] = g[k];
    e[k] = C.p[k];
  }
  for (int i = 0; i < iters; i++) {
    ds_update_fg(f, g, t);
    ds_update_de(d, e, t, C);
  }
#pragma unroll
  for (int k = 0; k < DS_L; k++) out[k] = f[k] ^ g[k] ^ d[k] ^ e[k];
}

// which = 2: one whole batch on a warp with its exit test (ds_batch_warp
// and ds_is_zero_warp of divstep_inv_mont), over one inversion of the given
// value after another
__global__ void __launch_bounds__(32) batch_warp_chain(int32_t* out, Fe<NL> w, DivstepConst<NL> C, int iters) {
  int j = warp_lane();
  int32_t pj = ds_lane_p(C, j);
  uint32_t words[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) words[k] = w.v[k];
  int32_t L[DS_L];
  words_to_l30(L, words);
  int32_t g = 0;
#pragma unroll
  for (int k = 0; k < DS_L; k++) g = j == k ? L[k] : g;
  int32_t g0 = g, f = pj, d = 0, e = j == 0, zeta = -1;
  for (int i = 0; i < iters; i++) {
    if (ds_is_zero_warp<DS_L>(g, j)) {  // the inversion is done: start it again
      f = pj, g = g0, d = 0, e = j == 0, zeta = -1;
    }
    zeta = ds_batch_warp<NL>(zeta, f, g, d, e, pj, C.pinv, j);
  }
  out[j] = f ^ g ^ d ^ e ^ zeta;
}

// One launch of `iters` steps of chain `which`; words: NL words of g (the
// matrix of chain 1 in the first four); out: 32 int32. Returns
// cudaGetLastError().
extern "C" int divstep_latency(int which, int iters, const uint32_t* words, const int32_t* cfg, void* out,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Fe<NL> w = fe_from<NL>(words);
  DivstepConst<NL> C = divstep_from<NL>(cfg);
  if (which == 0)
    divsteps_chain<false><<<1, 32, 0, st>>>((int32_t*)out, (uint32_t)C.p[0], w.v[0], iters);
  else if (which == 3)
    divsteps_chain<true><<<1, 32, 0, st>>>((int32_t*)out, (uint32_t)C.p[0], w.v[0], iters);
  else if (which == 1)
    apply_thread_chain<<<1, 32, 0, st>>>((int32_t*)out, w,
                                         DsMatrix{(int32_t)w.v[0] >> 2, (int32_t)w.v[1] >> 3,
                                                  (int32_t)w.v[2] >> 3, (int32_t)w.v[3] >> 2},
                                         C, iters);
  else
    batch_warp_chain<<<1, 32, 0, st>>>((int32_t*)out, w, C, iters);
  return (int)cudaGetLastError();
}
