// Kernel 23: plain-domain modular product x y mod p by a schoolbook product
// and a Barrett reduction, lane by lane.
//
// Replaces the Pallas kernel "barrett_mul" of montgomery_tpu/ops/alt_mul.py
// (barrett_mul, :132-150, over schoolbook_product + barrett_reduce): the
// alternative multiplier that the micro-benchmark's `altmul` section times
// against the Montgomery product. Entry points: msm_barrett_mul (NL = 12,
// BLS12-377), msm_barrett_mul_n13 (NL = 13, BLS12-381), msm_barrett_mul_n9
// (NL = 9), and msm_barrett_mul_n1, _n2, _n3 (the example fields small,
// babybear and goldilocks). The pipeline is the
// reference's (wasm/barrett.ts:7-78), on 32-bit words:
//   T  = x y, all 2 NL words (limbs_mul_wide);
//   q1 = floor(T / 2^(K - 1)), NL words, K = bits(p);
//   q  = floor(q1 mu / 2^(K + 1)), NL words, mu = floor(2^(2K) / p), from
//        the whole 2 NL-word product q1 mu (no truncation);
//   r  = T - q p mod 2^(32 NL), from the low NL words of q p;
//   two conditional subtractions of p.
// For x, y in [0, p) (the contract), T < p^2 < 2^(2K), so q1 < 2^(K + 1)
// and mu < 2^(K + 1) fit NL words (FieldOps sizes NL so that 32 NL >= K + 6),
// and the classical Barrett error (HAC 14.42) gives q <= floor(T / p) <=
// q + 2: r lies in [0, 3p) < 2^(32 NL), so the truncation mod 2^(32 NL)
// loses nothing and two subtractions bring r into [0, p). The result is
// unique, so the kernel, its plain version (ops/alt_mul.py
// barrett_mul_plain, the same word-level steps on 16-bit halves) and the JAX
// package's value agree bit for bit. Inputs outside [0, p) are outside the
// contract (the same steps still run, and kernel and plain version still
// agree).
//
// The shifts straddle words (K = 377 puts q1's cut at bit 376 = 11 x 32 +
// 24): both shift counts lie in [B, B + 64) with B = 32 barrett_base(NL) =
// 32 (NL - 2), clamped to 0 at NL = 1 (K - 1 and K + 1 are then below 32),
// so each output word is a funnel shift of two of three words at
// compile-time offsets, selected by the run-time count; no register array is
// indexed at run time, and one binary serves every field of NL words. The
// counts (K - 1 - B, K + 1 - B): (6, 8) at p = 101 (NL = 1), (30, 32) at
// 2^31 - 1 (NL = 2), (31, 33) at goldilocks (NL = 3), (56, 58) at BLS12-377,
// (28, 30) at BLS12-381.
//
// Bound on this card: 366 32x32->64 multiplies per lane at NL = 12 (144 for
// x y, 144 for q1 mu, 78 for the low words of q p) against 144 bytes moved;
// at 2^18 lanes about 11 us of either at the multiply rate of
// csrc/rates/imad_rate.cu and 3.35 TB/s. Design: one thread per lane,
// coalesced limb-plane loads, every loop unrolled so the words stay in
// registers; the constants ride in the kernel's parameter bank.
#include "field.cuh"

template <int NL>
struct BarrettConst {  // layout of ops/alt_mul.py BarrettParams.kernel_words
  uint32_t p[NL];
  uint32_t mu[NL];  // floor(2^(2K) / p)
  int32_t t1;       // K - 1 - 32 barrett_base(NL), in [0, 64)
  int32_t t2;       // K + 1 - 32 barrett_base(NL), in [0, 64)
};

// the word at which the shifts' windows start (ops/alt_mul.py barrett_base)
__host__ __device__ constexpr int barrett_base(int NL) { return NL > 2 ? NL - 2 : 0; }

// word k of a, 0 past its end (k is a compile-time constant once unrolled)
template <int N>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&a)[N], int k) {
  return k < N ? a[k < N ? k : 0] : 0u;
}

// r = floor(a / 2^(32 D0 + t)) mod 2^(32 NOUT), for t in [0, 64)
template <int NIN, int NOUT, int D0>
__device__ __forceinline__ void shr_bits(uint32_t (&r)[NOUT], const uint32_t (&a)[NIN], int t) {
  bool up = t >= 32;
  uint32_t s = (uint32_t)t & 31u;
#pragma unroll
  for (int i = 0; i < NOUT; i++) {
    uint32_t w0 = word_at(a, i + D0), w1 = word_at(a, i + D0 + 1), w2 = word_at(a, i + D0 + 2);
    r[i] = __funnelshift_r(up ? w1 : w0, up ? w2 : w1, s);
  }
}

// r = a b mod 2^(32 N): the N (N + 1) / 2 products below the cut
template <int N>
__device__ __forceinline__ void limbs_mul_lo(uint32_t (&r)[N], const uint32_t (&a)[N], const uint32_t (&b)[N]) {
#pragma unroll
  for (int k = 0; k < N; k++) r[k] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; i + j < N; j++) {
      uint64_t s = (uint64_t)r[i + j] + (uint64_t)a[i] * b[j] + c;
      r[i + j] = (uint32_t)s;
      c = s >> 32;
    }
  }
}

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
barrett_mul_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx,
                   const int32_t* __restrict__ y, int sy, BarrettConst<NL> C, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL], b[NL], T[2 * NL];
  fe_load(a, x, sx, i);
  fe_load(b, y, sy, i);
  limbs_mul_wide(T, a, b);
  uint32_t q1[NL], P[2 * NL], q[NL];
  shr_bits<2 * NL, NL, barrett_base(NL)>(q1, T, C.t1);
  limbs_mul_wide(P, q1, C.mu);
  shr_bits<2 * NL, NL, barrett_base(NL)>(q, P, C.t2);
  uint32_t qp[NL], r[NL], d[NL];
  limbs_mul_lo(qp, q, C.p);
#pragma unroll
  for (int k = 0; k < NL; k++) a[k] = T[k];
  limbs_sub(r, a, qp);
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    uint32_t br = limbs_sub(d, r, C.p);
    fe_select(r, br, r, d);
  }
  fe_store(out, N, i, r);
}

template <int NL>
static int launch(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* cfg, int N,
                  void* stream) {
  BarrettConst<NL> C;
  memcpy(&C, cfg, sizeof(C));
  if (N > 0)
    barrett_mul_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, (const int32_t*)y, sy, C, N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_barrett_mul(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* cfg,
                               int N, void* stream) {
  return launch<12>(out, x, sx, y, sy, cfg, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_barrett_mul_n13(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* cfg,
                                   int N, void* stream) {
  return launch<13>(out, x, sx, y, sy, cfg, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_barrett_mul_n9(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* cfg,
                                  int N, void* stream) {
  return launch<9>(out, x, sx, y, sy, cfg, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_barrett_mul_n1(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* cfg,
                                  int N, void* stream) {
  return launch<1>(out, x, sx, y, sy, cfg, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_barrett_mul_n2(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* cfg,
                                  int N, void* stream) {
  return launch<2>(out, x, sx, y, sy, cfg, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_barrett_mul_n3(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* cfg,
                                  int N, void* stream) {
  return launch<3>(out, x, sx, y, sy, cfg, N, stream);
}
#endif
