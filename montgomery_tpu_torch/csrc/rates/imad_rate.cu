// Throughput of the two integer multiplies the field kernels are made of, on
// the card at hand: the 32x32->64 product of every limb product (PTX
// mul.wide.u32, SASS IMAD.WIDE.U32) and the low 32-bit multiply-add of each
// Montgomery quotient digit (mad.lo.u32, SASS IMAD). chip_smoke.py times both
// and divides each kernel's multiplies by these rates for its operation bound.
// Not part of the kernels' library: it is built on its own, beside it.
//
// Each thread runs CHAINS independent dependency chains, so the latency of one
// multiply hides behind the others and the multiplier's throughput is what the
// time measures; every chain's end value is stored, so none is optimised away.
// A wide step multiplies the low and the high word of the chain's last value,
// so both halves of every product are live, and adds nothing: ptxas moves a
// 64-bit addend out of IMAD.WIDE.U32 into two integer adds, which would be
// timed with it, and compiles a chain that reads only the low word to the low
// multiply. Operand values do not change the multiplier's time.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int CHAINS = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mul_wide_kernel(uint64_t* out, uint32_t m, int iters) {
  uint64_t acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = ((uint64_t)m << 32) + threadIdx.x * (c + 1) + blockIdx.x;
#pragma unroll 32
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile("mul.wide.u32 %0, %1, %2;"
                   : "=l"(acc[c]) : "r"((uint32_t)acc[c]), "r"((uint32_t)(acc[c] >> 32)));
  }
  uint64_t s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s ^= acc[c];
  out[blockIdx.x * THREADS + threadIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS)
mad_lo_kernel(uint64_t* out, uint32_t m, int iters) {
  uint32_t acc[CHAINS], k = m ^ 0x5BD1E995u;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = threadIdx.x * (c + 1) + blockIdx.x;
#pragma unroll 32
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(acc[c]) : "r"(m), "r"(k));
  }
  uint64_t s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s ^= acc[c];
  out[blockIdx.x * THREADS + threadIdx.x] = s;
}

// One launch of `blocks` x 256 threads, each running CHAINS x iters
// multiplies; out holds blocks x 256 words. Returns cudaGetLastError().
extern "C" int imad_rate(int wide, int blocks, int iters, void* out, void* stream) {
  uint32_t m = 0x9E3779B9u;
  if (wide)
    mul_wide_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>((uint64_t*)out, m, iters);
  else
    mad_lo_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>((uint64_t*)out, m, iters);
  return (int)cudaGetLastError();
}

extern "C" int imad_rate_chains() { return CHAINS; }
extern "C" int imad_rate_threads() { return THREADS; }
