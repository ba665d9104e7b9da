// Kernel 4: GLV decomposition and signed c-bit window digits, one scalar per
// thread.
//
// Replaces the Pallas kernel "glv_digits_{c}" of
// montgomery_tpu/scalar/device.py (digits_glv_device, fused branch :341-356,
// over decompose_device :259-298 and _signed_windows_inline :301-315). It
// computes the same integers: the lattice coefficients u = floor(s g / 2^m)
// by the truncated most-significant-limb product on the 13-bit limb grid
// (limbs of index >= k0 only, two guard limbs), the residuals
// s0 = s + a0 u1 + b0 u2 and s1 = a1 u1 + b1 u2 mod 2^(nw w) in two's
// complement, their magnitudes and signs, and K signed digits per half.
//
// Bound on this card: each scalar reads 80 bytes and writes 8K bytes (160 at
// K = 10), against about 500 products of two 13-bit limbs; so bytes, once
// the limbs stay in registers. Design: the limb counts (ns, ng, nu, nw and
// the four coefficient lengths) are template parameters (GlvShape), one
// instantiation for each GLV curve the port defines at w = 13, and every
// limb loop is unrolled, so every limb array is indexed by compile-time
// constants and lives in registers (ptxas: no stack frame). The constants
// stay in the kernel's parameter bank (GlvConst), read at compile-time
// offsets. Products of two 13-bit limbs are 32-bit multiply-adds: a column of
// the truncated product sums at most min(ns, ng) of them plus a carry, below
// 2^32 unsigned, and a residual column signed sums of at most nu of them per
// coefficient, s and a carry, below 2^31 (GlvDevice.kernel_words proves both
// at each curve's constants). The residual's two coefficient products are
// summed column by column before one signed carry pass: the same value mod
// 2^(nw w) as carrying each apart. The windows come from a bit buffer fed
// with the magnitude limbs in compile-time order, c bits at a time, c at run
// time in [1, 16].
#include "field.cuh"

#define GLV_MAXL 24
#define GLV_W 13
#define GLV_MASK ((1u << GLV_W) - 1)
// msm_glv_digits' return for a GlvConst whose sizes no instantiation has
// (CUDA's own error codes are positive)
#define GLV_NO_SHAPE (-1)

struct GlvConst {  // layout of scalar/device.py GlvDevice.kernel_words
  int ns, k0, khi, nu, nw, ng, w, c, K, max_bits;
  uint32_t g1[GLV_MAXL], g2[GLV_MAXL];
  int coef_sign[4];  // a0, b0, a1, b1: -1, 0 or +1
  int coef_len[4];
  uint32_t coef[4][GLV_MAXL];
};

// the limb counts of one curve at w = 13; k0 = ns - 1 and khi - k0 = nu + 2
// follow from glv_device (m = (ns + 1) w, two guard limbs)
template <int NS_, int NG_, int NU_, int NW_, int LA0, int LB0, int LA1, int LB1>
struct GlvShape {
  static constexpr int NS = NS_, NG = NG_, NU = NU_, NW = NW_;
  static constexpr int K0 = NS - 1, KLEN = NU + 2;
  static constexpr int LEN[4] = {LA0, LB0, LA1, LB1};

  static bool matches(const GlvConst& G) {
    return G.ns == NS && G.ng == NG && G.nu == NU && G.nw == NW && G.k0 == K0 &&
           G.khi - G.k0 == KLEN && G.w == GLV_W && G.coef_len[0] == LA0 && G.coef_len[1] == LB0 &&
           G.coef_len[2] == LA1 && G.coef_len[3] == LB1;
  }
};

// the instantiations: scalar/device.py GLV_SHAPES lists the same
using GlvBls12_377 = GlvShape<20, 12, 10, 10, 1, 10, 10, 1>;
using GlvBls12_381 = GlvShape<20, 12, 11, 11, 10, 1, 1, 10>;
using GlvPallas = GlvShape<20, 12, 11, 11, 10, 10, 10, 10>;

// u = limbs [2, 2 + nu) of (sum_{a+j >= k0} s_a g_j 2^(w(a+j-k0))) mod 2^(w(khi-k0)),
// carried column by column
template <class S>
__device__ __forceinline__ void msb_mul(uint32_t (&u)[S::NU], const uint32_t (&s)[S::NS],
                                        const uint32_t (&g)[GLV_MAXL]) {
  uint32_t carry = 0;
#pragma unroll
  for (int t = 0; t < S::KLEN; t++) {
    uint32_t acc = carry;
#pragma unroll
    for (int j = 0; j < S::NG; j++) {
      int a = S::K0 + t - j;
      if (a >= 0 && a < S::NS) acc += s[a] * g[j];
    }
    if (t >= 2) u[t - 2] = acc & GLV_MASK;
    carry = acc >> GLV_W;
  }
}

// sum_j u_{t-j} c_j, column t of u times a coefficient of LEN limbs (below
// 2^31: kernel_words)
template <class S, int LEN>
__device__ __forceinline__ int32_t column(const uint32_t (&u)[S::NU], const uint32_t (&cf)[GLV_MAXL], int t) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < LEN; j++) {
    int a = t - j;
    if (a >= 0 && a < S::NU) acc += u[a] * cf[j];
  }
  return (int32_t)acc;
}

// |r| and sign of r = (WITH_S ? s : 0) + sa u1 |a| + sb u2 |b| mod 2^(nw w),
// read as a two's-complement integer; coefficients H and H + 1 of G
template <class S, int H, bool WITH_S>
__device__ __forceinline__ bool residual(uint32_t (&mag)[S::NW], const uint32_t (&s)[S::NS],
                                         const uint32_t (&u1)[S::NU], const uint32_t (&u2)[S::NU],
                                         const GlvConst& G) {
  int sa = G.coef_sign[H], sb = G.coef_sign[H + 1];
  int32_t carry = 0;
#pragma unroll
  for (int t = 0; t < S::NW; t++) {
    int32_t acc = carry + sa * column<S, S::LEN[H]>(u1, G.coef[H], t) +
                  sb * column<S, S::LEN[H + 1]>(u2, G.coef[H + 1], t);
    if (WITH_S && t < S::NS) acc += (int32_t)s[t];
    mag[t] = (uint32_t)acc & GLV_MASK;
    carry = acc >> GLV_W;  // arithmetic shift: floor
  }
  bool neg = (mag[S::NW - 1] >> (GLV_W - 1)) != 0;
  // |r| = 2^(nw w) - r where negative: complement every limb, add one
  uint32_t flip = neg ? GLV_MASK : 0, c = neg;
#pragma unroll
  for (int t = 0; t < S::NW; t++) {
    uint32_t v = (mag[t] ^ flip) + c;
    mag[t] = v & GLV_MASK;
    c = v >> GLV_W;
  }
  return neg;
}

// the K signed c-bit digits of the magnitude, negated where `neg`, to
// out[k stride + col]: the limbs enter a bit buffer in order, and each c
// bits that are there become one window (the buffer holds below c + w <= 29
// bits; windows past the top limb read zeros)
template <class S>
__device__ __forceinline__ void signed_windows(int32_t* out, const uint32_t (&mag)[S::NW], bool neg,
                                               size_t col, size_t stride, int c, int K) {
  int half = 1 << (c - 1), full = 1 << c, sgn = neg ? -1 : 1;
  uint32_t cmask = (uint32_t)full - 1, buf = 0;
  int nb = 0, k = 0, carry = 0;
  auto emit = [&]() {
    int dk = (int)(buf & cmask) + carry;
    int over = dk > half ? 1 : 0;
    if (k < K) out[(size_t)k * stride + col] = (dk - over * full) * sgn;
    carry = over;
    buf >>= c;
    k++;
  };
#pragma unroll
  for (int t = 0; t < S::NW; t++) {
    buf |= mag[t] << nb;
    nb += GLV_W;
    for (; nb >= c; nb -= c) emit();
  }
  while (k < K) emit();
}

template <class S>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
glv_digits_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ s_limbs, GlvConst G, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t s[S::NS], u1[S::NU], u2[S::NU], m[S::NW];
#pragma unroll
  for (int a = 0; a < S::NS; a++) s[a] = (uint32_t)s_limbs[(size_t)a * N + i];
  msb_mul<S>(u1, s, G.g1);
  msb_mul<S>(u2, s, G.g2);
  bool neg = residual<S, 0, true>(m, s, u1, u2, G);
  signed_windows<S>(out, m, neg, i, 2 * (size_t)N, G.c, G.K);
  neg = residual<S, 2, false>(m, s, u1, u2, G);
  signed_windows<S>(out, m, neg, (size_t)N + i, 2 * (size_t)N, G.c, G.K);
}

template <class S>
static bool launch_if(const GlvConst& G, int32_t* out, const int32_t* s, int N, cudaStream_t st) {
  if (!S::matches(G)) return false;
  glv_digits_kernel<S><<<grid_for(N), LANES_PER_BLOCK, 0, st>>>(out, s, G, N);
  return true;
}

extern "C" int msm_glv_digits(void* out, const void* s_limbs, const int32_t* cfg, int N, void* stream) {
  GlvConst G;
  memcpy(&G, cfg, sizeof(G));
  if (N <= 0) return (int)cudaGetLastError();
  int32_t* o = (int32_t*)out;
  const int32_t* s = (const int32_t*)s_limbs;
  cudaStream_t st = (cudaStream_t)stream;
  if (G.c < 1 || G.c > 16 ||
      !(launch_if<GlvBls12_377>(G, o, s, N, st) || launch_if<GlvBls12_381>(G, o, s, N, st) ||
        launch_if<GlvPallas>(G, o, s, N, st)))
    return GLV_NO_SHAPE;
  return (int)cudaGetLastError();
}
