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
// Bound on this card: a few hundred 13x13-bit products and a few hundred
// dependent carry steps per scalar; each scalar reads 80 bytes and writes
// 8K bytes, so the kernel is bound by its serial carry chains. It runs once
// per MSM. Design: one thread per scalar with the limb counts as run-time
// parameters (one binary for every c and curve); limb arrays live in local
// memory, which is simple and right, and cheap beside the bucket phase.
#include "field.cuh"

#define GLV_MAXL 24

struct GlvConst {  // layout of scalar/device.py GlvDevice.kernel_words
  int ns, k0, khi, nu, nw, ng, w, c, K, max_bits;
  uint32_t g1[GLV_MAXL], g2[GLV_MAXL];
  int coef_sign[4];  // a0, b0, a1, b1: -1, 0 or +1
  int coef_len[4];
  uint32_t coef[4][GLV_MAXL];
};

// u = limbs [2, 2 + nu) of (sum_{a+j >= k0} s_a g_j 2^(w(a+j-k0))) mod 2^(w(khi-k0))
__device__ void msb_mul(uint32_t* u, const uint32_t* s, const uint32_t* g, const GlvConst& G) {
  uint64_t T[GLV_MAXL];
  int len = G.khi - G.k0;
  uint64_t mask = (1ull << G.w) - 1;
  for (int t = 0; t < len; t++) T[t] = 0;
  for (int j = 0; j < G.ng; j++) {
    for (int a = 0; a < G.ns; a++) {
      int k = a + j;
      if (k >= G.k0 && k < G.khi) T[k - G.k0] += (uint64_t)s[a] * g[j];
    }
  }
  for (int t = 0; t + 1 < len; t++) {
    T[t + 1] += T[t] >> G.w;
    T[t] &= mask;
  }
  T[len - 1] &= mask;
  for (int x = 0; x < G.nu; x++) u[x] = (uint32_t)T[2 + x];
}

// |r| and sign of r = (with_s ? s : 0) + sa u1 |a| + sb u2 |b| mod 2^(nw w),
// read as a two's-complement integer
__device__ bool residual(uint32_t* mag, const uint32_t* s, bool with_s, const uint32_t* u1, const uint32_t* u2,
                         int ci, const GlvConst& G) {
  int64_t acc[GLV_MAXL];
  int64_t mask = (1ll << G.w) - 1;
  int nw = G.nw;
  for (int t = 0; t < nw; t++) acc[t] = (with_s && t < G.ns) ? (int64_t)s[t] : 0;
  for (int h = 0; h < 2; h++) {
    int sg = G.coef_sign[ci + h];
    if (sg == 0) continue;
    const uint32_t* u = h ? u2 : u1;
    const uint32_t* cf = G.coef[ci + h];
    int64_t T[GLV_MAXL];
    for (int t = 0; t < nw; t++) T[t] = 0;
    for (int j = 0; j < G.coef_len[ci + h]; j++)
      for (int a = 0; a < G.nu && a + j < nw; a++) T[a + j] += (int64_t)u[a] * cf[j];
    for (int t = 0; t + 1 < nw; t++) {
      T[t + 1] += T[t] >> G.w;
      T[t] &= mask;
    }
    T[nw - 1] &= mask;
    for (int t = 0; t < nw; t++) acc[t] += sg * T[t];
  }
  for (int t = 0; t + 1 < nw; t++) {
    acc[t + 1] += acc[t] >> G.w;  // arithmetic shift: floor
    acc[t] &= mask;
  }
  acc[nw - 1] &= mask;
  bool neg = (acc[nw - 1] >> (G.w - 1)) > 0;
  if (neg) {  // |r| = 2^(nw w) - r
    int64_t c = 1;
    for (int t = 0; t < nw; t++) {
      int64_t v = (mask - acc[t]) + c;
      acc[t] = v & mask;
      c = v >> G.w;
    }
  }
  for (int t = 0; t < nw; t++) mag[t] = (uint32_t)acc[t];
  return neg;
}

__device__ void signed_windows(int32_t* out, const uint32_t* mag, bool neg, long col, long stride,
                               const GlvConst& G) {
  int half = 1 << (G.c - 1), full = 1 << G.c, sgn = neg ? -1 : 1;
  uint64_t cmask = (uint64_t)full - 1;
  int carry = 0;
  for (int k = 0; k < G.K; k++) {
    int off = k * G.c, l0 = off / G.w, sh = off % G.w;
    uint64_t acc = 0;
    for (int t = 0; t < 4 && l0 + t < G.nw; t++) acc |= (uint64_t)mag[l0 + t] << (t * G.w);
    int dk = (int)((acc >> sh) & cmask) + carry;
    int over = dk > half ? 1 : 0;
    out[(long)k * stride + col] = (dk - over * full) * sgn;
    carry = over;
  }
}

__global__ void __launch_bounds__(LANES_PER_BLOCK)
glv_digits_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ s_limbs, GlvConst G, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t s[GLV_MAXL], u1[GLV_MAXL], u2[GLV_MAXL], m0[GLV_MAXL], m1[GLV_MAXL];
  for (int a = 0; a < G.ns; a++) s[a] = (uint32_t)s_limbs[(long)a * N + i];
  msb_mul(u1, s, G.g1, G);
  msb_mul(u2, s, G.g2, G);
  bool n0 = residual(m0, s, true, u1, u2, 0, G);
  bool n1 = residual(m1, s, false, u1, u2, 2, G);
  signed_windows(out, m0, n0, i, 2l * N, G);
  signed_windows(out, m1, n1, (long)N + i, 2l * N, G);
}

extern "C" int msm_glv_digits(void* out, const void* s_limbs, const int32_t* cfg, int N, void* stream) {
  GlvConst G;
  memcpy(&G, cfg, sizeof(G));
  if (N > 0)
    glv_digits_kernel<<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)s_limbs, G, N);
  return (int)cudaGetLastError();
}
