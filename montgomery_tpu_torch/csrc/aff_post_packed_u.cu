// Kernel 9: chord completion of the unsafe packed batched-affine add, fused
// with the last descent level of its batch inversion.
//
// Replaces the Pallas kernel "aff_post_packed_u" of
// montgomery_tpu/curves/affine.py (AffineOps.add_packed, unsafe branch, over
// _post_packed_unsafe_formula, :283-301). Per lane, with the signs folded in
// (y1 = -y_A where sA, y2 = -y_B where sB):
//   lambda = (y2 - y1) dinv, x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1;
// a paired lane (hp != 0) writes (x3, y3, inf = 0), an unpaired lane passes
// the sign-applied A through, inf row included. Output: one packed
// (2n+1, M) array. The unsafe contract (no two operands of a pair share x,
// no infinity among paired operands) is the caller's.
//
// The lane's inverse dinv is formed here from the batch inversion's parent
// level (FieldOps.batch_inv_parent: inv1, the inverses of the tree's first
// product level, and h = M / 2) and the pre kernel's denominators, exactly
// as the descent would (ops/field.py, FieldOps._descend):
//   i < h: inv1[i] denom[i + h];  h <= i < 2h: inv1[i - h] denom[i - h];
//   i = 2h (M odd): inv1[h];      h = 0 (no tree): inv1[i],
// the same Montgomery product of the same operands, so the sums are today's
// bit for bit.
//
// Bound on this card: bytes and multiplies nearly balanced. A lane reads A
// and B (x, y; A's inf row), the signs and hp, its half of the parent
// inverse and its partner's denominator (24 + 48 bytes in place of a 48-byte
// dinv) and writes one packed column: 380 bytes, against 356 for the chord
// alone plus 312 that the descent level moved through device memory (the
// repeat and the concatenation of its operands and a full-width mont_mul).
// 3 products and a square a lane (1,086 32x32->64 multiplies), about 0.11 ms
// of multiplies at 835,592 lanes against 0.095 ms of bytes. Design: one
// thread per lane, operands read in place through their row strides, the
// chord of affine.cuh (shared with the planar aff_post_unsafe.cu), and
// __launch_bounds__ with a minimum of 5 blocks of 128 threads an SM, so that
// enough warps are resident for one warp's loads to overlap another's
// products. Chosen by measurement on an H100 80GB HBM3 at 700 W, with the
// kernel built at other minimums and timed beside this one: 5 blocks (96
// registers, 68 bytes of spill) ran 0.2401 ms at 835,592 lanes and 2.955 ms
// at 10,649,608, against 0.2455 and 3.006 at 4 (127 registers), 0.2443 and
// 2.977 with no minimum (151 registers), and 0.2761 and 3.306 at 6 (80
// registers, 300 bytes of spill).
//
// The minimum is chosen per limb count (post_u_min_blocks): the least
// spill, then the faster of two neighbouring minimums by device time, the
// kernel built at minimums of none and 3 to 7 and timed a launch at the
// first super-round level of the 2^16 and 2^20 paths (chip_smoke.py
// post_u_minimums, H100 80GB HBM3 at 700 W). At 13 limbs (BLS12-381) no
// spill needs a minimum of 4 or less: 3 (161 registers, as with no
// minimum) ran 0.2818 ms at 835,592 lanes and 3.489 ms at 10,649,608,
// against 0.2831 and 3.529 at 4 (128 registers); 5 (96 registers, 116
// bytes of spill) ran 0.2794 and 3.461, 6 (368 bytes) 0.3161 and 3.919. At
// 9 limbs (Pallas) 5 gives 95 registers and no spill, 0.1311 ms at 835,592
// lanes and 1.769 at 11,714,568, against 0.1360 and 1.840 at 4 (113
// registers) and 0.1350 and 1.808 at 6 (80 registers, 16 bytes of spill).
#include "affine.cuh"

// the minimum of resident blocks an SM asked of ptxas at each limb count
__host__ __device__ constexpr int post_u_min_blocks(int NL) { return NL == 13 ? 3 : 5; }

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK, post_u_min_blocks(NL))
aff_post_packed_u_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ A, int sa,
                         const int32_t* __restrict__ B, int sb, const int32_t* __restrict__ sA,
                         const int32_t* __restrict__ sB, const int32_t* __restrict__ inv1, int si,
                         const int32_t* __restrict__ denom, int sd, int h, const int32_t* __restrict__ hp,
                         FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], x3[NL], y3[NL];
  if (h == 0 || i >= 2 * h) {
    fe_load(d, inv1, si, h == 0 ? i : h);
  } else {
    uint32_t a[NL], b[NL];
    fe_load(a, inv1, si, i < h ? i : i - h);
    fe_load(b, denom, sd, i < h ? i + h : i - h);
    fe_mul(d, a, b, F);
  }
  load_signed(x1, y1, A, sa, i, sA[i] != 0, F);
  load_signed(x2, y2, B, sb, i, sB[i] != 0, F);
  aff_chord(x3, y3, x1, y1, x2, y2, d, F);
  bool paired = hp[i] != 0;
  fe_select(x3, paired, x3, x1);
  fe_select(y3, paired, y3, y1);
  int32_t inf1 = A[(size_t)2 * NL * sa + i];
  fe_store(out, N, i, x3);
  fe_store(out + (size_t)NL * N, N, i, y3);
  out[(size_t)2 * NL * N + i] = paired ? 0 : inf1;
}

template <int NL>
static int launch(void* out, const void* A, int sa, const void* B, int sb, const void* sA, const void* sB,
                  const void* inv1, int si, const void* denom, int sd, int h, const void* hp,
                  const uint32_t* field, int N, void* stream) {
  if (N > 0)
    aff_post_packed_u_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)A, sa, (const int32_t*)B, sb, (const int32_t*)sA, (const int32_t*)sB,
        (const int32_t*)inv1, si, (const int32_t*)denom, sd, h, (const int32_t*)hp, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_aff_post_packed_u(void* out, const void* A, int sa, const void* B, int sb, const void* sA,
                                     const void* sB, const void* inv1, int si, const void* denom, int sd,
                                     int h, const void* hp, const uint32_t* field, int N, void* stream) {
  return launch<12>(out, A, sa, B, sb, sA, sB, inv1, si, denom, sd, h, hp, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_aff_post_packed_u_n13(void* out, const void* A, int sa, const void* B, int sb,
                                         const void* sA, const void* sB, const void* inv1, int si,
                                         const void* denom, int sd, int h, const void* hp,
                                         const uint32_t* field, int N, void* stream) {
  return launch<13>(out, A, sa, B, sb, sA, sB, inv1, si, denom, sd, h, hp, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_aff_post_packed_u_n9(void* out, const void* A, int sa, const void* B, int sb,
                                        const void* sA, const void* sB, const void* inv1, int si,
                                        const void* denom, int sd, int h, const void* hp,
                                        const uint32_t* field, int N, void* stream) {
  return launch<9>(out, A, sa, B, sb, sA, sB, inv1, si, denom, sd, h, hp, field, N, stream);
}
#endif
