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
// chord of affine.cuh (shared with the planar aff_post_unsafe.cu) and the
// fused level's product on madc.cuh's carry chains (fe_mul_cc, fe_sqr_cc),
// and __launch_bounds__ with a minimum of resident blocks of 128 threads an
// SM, so that enough warps are resident for one warp's loads to overlap
// another's products. The body it replaced ran the same on field.cuh's
// CIOS fe_mul and fe_sqr at that body's minimums (5 blocks at 12 and 9
// limbs, 3 at 13); the two agreed bit for bit.
//
// The minimum is chosen per limb count (post_u_min_blocks): the least
// spill, then the faster of the two highest minimums without it by device
// time, the kernel built at minimums of none and 3 to 7 and timed a launch
// at the first super-round level of the 2^16 and 2^20 paths (chip_smoke.py
// post_u_minimums, H100 80GB HBM3 at 700 W), ms at 835,592 lanes and at
// 10,649,608 (11,714,568 at 9 limbs):
//   12 limbs: 4 (127 registers, no spill) 0.1793 and 2.204; 3 (149) 0.2091
//     and 2.598; none (123) 0.1889 and 2.263; 5 (96 registers, 48 bytes of
//     spill) 0.1843 and 2.192; 6 (184 bytes) 0.2016 and 2.481; 7 (296)
//     0.2386 and 2.967.
//   13 limbs: 4 (126 registers, no spill) 0.2181 and 2.698; 3 (166) 0.2361
//     and 2.908; none (126) 0.2183 and 2.693; 5 (96 registers, 88 bytes of
//     spill) 0.2147 and 2.635; 6 (248 bytes) 0.2507 and 3.105.
//   9 limbs: 5 (96 registers, no spill) 0.1141 and 1.512; 4 (120) 0.1278
//     and 1.712; none (96) 0.1256 and 1.638; 6 (80 registers, 8 bytes of
//     spill) 0.1178 and 1.553; 7 (36 bytes) 0.1149 and 1.482.
#include "affine.cuh"

// the minimum of resident blocks an SM asked of ptxas at each limb count
__host__ __device__ constexpr int post_u_min_blocks(int NL) { return NL == 9 ? 5 : 4; }

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
    fe_mul_cc(d, a, b, F);
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
