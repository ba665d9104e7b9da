// Kernel 14: the sign-applied unified twisted Edwards add on packed rows,
// with pass-through.
//
// Replaces the Pallas kernel "ed_add_packed" of
// montgomery_tpu/curves/edwards.py (EdwardsOps.add_packed /
// _add_packed_formula, :163-187): every accumulation round of the Twisted
// Edwards MSM. A point is one column of 4 NL int32 rows [X | Y | Z | T] of
// whole 32-bit limbs (36 rows at NL = 9; the TPU packed two 13-bit limbs per
// row, 40 rows). Per lane: negate X and T of A where sA != 0 and of B where
// sB != 0 (-(x, y) = (-x, y)), add with ed_add of edwards.cuh, and write the
// sum where hp != 0, the signed A where hp == 0 (an unpaired lane passes
// through). Output: one (4 NL, M) array.
//
// Bound on this card: 9 products per lane (1458 32x32->64 multiplies at
// NL = 9) against 2 x 144 + 12 bytes read and 144 written; the multiplies
// bound it (about 0.18 ns a lane at the rate csrc/rates/imad_rate.cu
// measures, against 0.13 ns of memory at 3.35 TB/s). Design: one thread per
// lane, the add's products on madc.cuh's carry chains (ed_add on
// CarryChainMul); A and B are column ranges of packed arrays (a round's
// gathered operands, a super-round level's two halves) read in place
// through their row strides. On an H100 the carry chains took a launch of
// 10,813,448 lanes (the 2^20 path's first level) from 4.11 to 2.66 ms,
// 0.73 of the multiply bound (chip_smoke.py, in turns with the CIOS body
// it replaced); four threads a lane, one product
// each of the add's stages 4 | 1 | 4, took 3.88 ms.
#include "edwards.cuh"

// column i of packed rows [X | Y | Z | T] with row stride s, negated where neg
template <int NL>
__device__ __forceinline__ void load_signed_ext(uint32_t (&x)[NL], uint32_t (&y)[NL], uint32_t (&z)[NL],
                                                uint32_t (&t)[NL], const int32_t* P, int s, int i, bool neg,
                                                const FieldParams<NL>& F) {
  uint32_t u[NL];
  fe_load(u, P, s, i);
  fe_neg(x, u, F);
  fe_select(x, neg, x, u);
  fe_load(y, P + (size_t)NL * s, s, i);
  fe_load(z, P + (size_t)2 * NL * s, s, i);
  fe_load(u, P + (size_t)3 * NL * s, s, i);
  fe_neg(t, u, F);
  fe_select(t, neg, t, u);
}

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
ed_add_packed_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ A, int sa,
                     const int32_t* __restrict__ B, int sb, const int32_t* __restrict__ sA,
                     const int32_t* __restrict__ sB, const int32_t* __restrict__ hp, Fe<NL> k2d,
                     FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], z1[NL], t1[NL], x2[NL], y2[NL], z2[NL], t2[NL];
  load_signed_ext(x1, y1, z1, t1, A, sa, i, sA[i] != 0, F);
  load_signed_ext(x2, y2, z2, t2, B, sb, i, sB[i] != 0, F);
  if (hp[i] != 0) ed_add<NL, CarryChainMul>(x1, y1, z1, t1, x1, y1, z1, t1, x2, y2, z2, t2, k2d, F);
  fe_store(out, N, i, x1);
  fe_store(out + (size_t)NL * N, N, i, y1);
  fe_store(out + (size_t)2 * NL * N, N, i, z1);
  fe_store(out + (size_t)3 * NL * N, N, i, t1);
}

extern "C" int msm_ed_add_packed_n9(void* out, const void* A, int sa, const void* B, int sb, const void* sA,
                                    const void* sB, const void* hp, const uint32_t* k2d, const uint32_t* field,
                                    int N, void* stream) {
  if (N > 0)
    ed_add_packed_kernel<9><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)A, sa, (const int32_t*)B, sb, (const int32_t*)sA, (const int32_t*)sB,
        (const int32_t*)hp, fe_from<9>(k2d), field_from<9>(field), N);
  return (int)cudaGetLastError();
}
