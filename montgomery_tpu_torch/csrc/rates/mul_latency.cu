// Latency of one dependent Montgomery product on the card at hand, in the
// three forms the field kernels use: fe_mul in one thread (field.cuh),
// fe_mul_cc on carry chains in one thread (madc.cuh) and coop_mul on a
// whole warp (coop.cuh); and of one dependent square in its three forms
// (field.cuh's CIOS-row fe_sqr, madc.cuh's fe_sqr_cc, fe_mul_cc(a, a)),
// with the squares' throughput over a launch that fills the card
// (sqr_rate), from which exp_ladder takes its square. chip_smoke.py
// multiplies the window combine's serial product count by the warp
// product's latency for the combine's
// dependent-chain floor: a kernel that carries one point through a chain of
// products cannot beat that chain, however it uses the card.
// Instantiated at 12 limbs (BLS12-377's base field, the Weierstrass combine),
// 13 (BLS12-381's) and 9 (ed-on-bls12-377's, the Twisted Edwards combine).
// chip_smoke.py also prints the SASS of the two one-thread chains: each
// loop body is one product, so they give the instruction mix of fe_mul and
// fe_mul_cc.
// Not part of the kernels' library: it is built on its own, beside it.
//
// One block of one warp runs `iters` products, each on the result of the one
// before (x <- x y), and stores x, so none is optimised away; the launch time
// over iters is the latency of one product (launch overhead amortised).
#include "../coop.cuh"
#include "../madc.cuh"

template <int NL>
__global__ void __launch_bounds__(32)
one_thread_chain(uint32_t* out, Fe<NL> x0, Fe<NL> y, FieldParams<NL> F, int iters) {
  if (threadIdx.x) return;
  uint32_t x[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) x[k] = x0.v[k];
  for (int i = 0; i < iters; i++) fe_mul(x, x, y.v, F);
#pragma unroll
  for (int k = 0; k < NL; k++) out[k] = x[k];
}

template <int NL>
__global__ void __launch_bounds__(32)
cc_chain(uint32_t* out, Fe<NL> x0, Fe<NL> y, FieldParams<NL> F, int iters) {
  if (threadIdx.x) return;
  // plus %laneid (0 here), so that ptxas keeps the chain on the per-thread
  // datapath, as in a kernel, rather than on the uniform one
  uint32_t lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  uint32_t x[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) x[k] = x0.v[k] + lane;
  for (int i = 0; i < iters; i++) fe_mul_cc(x, x, y.v, F);
#pragma unroll
  for (int k = 0; k < NL; k++) out[k] = x[k];
}

// which: 0 fe_sqr, 1 fe_sqr_cc, 2 fe_mul_cc(x, x)
template <int NL>
__device__ __forceinline__ void square_by(uint32_t (&x)[NL], int which, const FieldParams<NL>& F) {
  if (which == 0) fe_sqr(x, x, F);
  else if (which == 1) fe_sqr_cc(x, x, F);
  else fe_mul_cc(x, x, x, F);
}

// iters dependent squares of x0 + %laneid in each thread of the launch; a
// single thread gives a square's latency, a launch that fills the card its
// throughput. Thread t stores its last square at out[t NL ..]
template <int NL, int WHICH>
__global__ void __launch_bounds__(128)
sqr_chain(uint32_t* out, Fe<NL> x0, FieldParams<NL> F, int iters, int threads) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint32_t lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  uint32_t x[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) x[k] = x0.v[k] + (k == 0 ? lane + (t >> 5) : 0u);
  for (int i = 0; i < iters; i++) square_by<NL>(x, WHICH, F);
#pragma unroll
  for (int k = 0; k < NL; k++) out[(size_t)t * NL + k] = x[k];
}

template <int NL>
__global__ void __launch_bounds__(32)
warp_chain(uint32_t* out, Fe<NL> x0, Fe<NL> y, Fe<NL> mu, FieldParams<NL> F, int iters) {
  __shared__ uint32_t x[NL], ys[NL];
  __shared__ CoopConsts<NL> C;
  coop_load_consts(C, F, mu);
  if (threadIdx.x < NL) {
    x[threadIdx.x] = x0.v[threadIdx.x];
    ys[threadIdx.x] = y.v[threadIdx.x];
  }
  __syncwarp();
  for (int i = 0; i < iters; i++) {
    coop_mul(x, x, ys, C);
    __syncwarp();
  }
  if (threadIdx.x < NL) out[threadIdx.x] = x[threadIdx.x];
}

template <int NL>
static int launch(int warp, int iters, const uint32_t* x, const uint32_t* y, const uint32_t* mu,
                  const uint32_t* field, void* out, void* stream) {
  if (warp == 2)
    cc_chain<NL><<<1, 32, 0, (cudaStream_t)stream>>>((uint32_t*)out, fe_from<NL>(x), fe_from<NL>(y),
                                                     field_from<NL>(field), iters);
  else if (warp)
    warp_chain<NL><<<1, 32, 0, (cudaStream_t)stream>>>((uint32_t*)out, fe_from<NL>(x), fe_from<NL>(y),
                                                       fe_from<NL>(mu), field_from<NL>(field), iters);
  else
    one_thread_chain<NL><<<1, 32, 0, (cudaStream_t)stream>>>((uint32_t*)out, fe_from<NL>(x), fe_from<NL>(y),
                                                             field_from<NL>(field), iters);
  return (int)cudaGetLastError();
}

template <int NL>
static int sqr_launch(int which, int threads, int iters, const uint32_t* x, const uint32_t* field, void* out,
                      void* stream) {
  int blocks = (threads + 127) / 128, bt = threads < 128 ? threads : 128;
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  if (which == 0) sqr_chain<NL, 0><<<blocks, bt, 0, st>>>(o, fe_from<NL>(x), field_from<NL>(field), iters, threads);
  else if (which == 1) sqr_chain<NL, 1><<<blocks, bt, 0, st>>>(o, fe_from<NL>(x), field_from<NL>(field), iters, threads);
  else sqr_chain<NL, 2><<<blocks, bt, 0, st>>>(o, fe_from<NL>(x), field_from<NL>(field), iters, threads);
  return (int)cudaGetLastError();
}

// One launch of `iters` dependent squares in each of `threads` threads at nl
// = 12, 13 or 9 limbs: which = 0 fe_sqr, 1 fe_sqr_cc, 2 fe_mul_cc(x, x);
// out holds nl words a thread. Returns cudaGetLastError().
extern "C" int sqr_rate(int nl, int which, int threads, int iters, const uint32_t* x, const uint32_t* field,
                        void* out, void* stream) {
  if (which < 0 || which > 2 || threads < 1) return (int)cudaErrorInvalidValue;
  if (nl == 12) return sqr_launch<12>(which, threads, iters, x, field, out, stream);
  if (nl == 13) return sqr_launch<13>(which, threads, iters, x, field, out, stream);
  if (nl == 9) return sqr_launch<9>(which, threads, iters, x, field, out, stream);
  return (int)cudaErrorInvalidValue;
}

// One launch of `iters` dependent products at nl = 12, 13 or 9 limbs: warp =
// 0 one thread (fe_mul), 1 a warp, 2 one thread on carry chains; out holds the nl words of the last product. Returns
// cudaGetLastError().
extern "C" int mul_latency(int nl, int warp, int iters, const uint32_t* x, const uint32_t* y,
                           const uint32_t* mu, const uint32_t* field, void* out, void* stream) {
  if (nl == 12) return launch<12>(warp, iters, x, y, mu, field, out, stream);
  if (nl == 13) return launch<13>(warp, iters, x, y, mu, field, out, stream);
  if (nl == 9) return launch<9>(warp, iters, x, y, mu, field, out, stream);
  return (int)cudaErrorInvalidValue;
}
