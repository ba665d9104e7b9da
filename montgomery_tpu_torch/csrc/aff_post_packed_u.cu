// Kernel 9: chord completion of the unsafe packed batched-affine add.
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
// Bound on this card: 2 products and a square per lane (798 32x32->64
// multiplies) against 256 bytes read and 100 written; the memory bound
// (0.089 ms at 835,592 lanes on an H100) is a little above the multiply
// bound. Design: one thread per lane,
// operands read in place through their row strides; neg/sub/select are the
// branch-free helpers of field.cuh, load_signed and aff_chord (shared with
// the planar aff_post_unsafe.cu) those of affine.cuh.
#include "affine.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
aff_post_packed_u_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ A, int sa,
                         const int32_t* __restrict__ B, int sb, const int32_t* __restrict__ sA,
                         const int32_t* __restrict__ sB, const int32_t* __restrict__ dinv, int sd,
                         const int32_t* __restrict__ hp, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t x1[NL], y1[NL], x2[NL], y2[NL], d[NL], x3[NL], y3[NL];
  load_signed(x1, y1, A, sa, i, sA[i] != 0, F);
  load_signed(x2, y2, B, sb, i, sB[i] != 0, F);
  fe_load(d, dinv, sd, i);
  aff_chord(x3, y3, x1, y1, x2, y2, d, F);
  bool paired = hp[i] != 0;
  fe_select(x3, paired, x3, x1);
  fe_select(y3, paired, y3, y1);
  int32_t inf1 = A[(size_t)2 * NL * sa + i];
  fe_store(out, N, i, x3);
  fe_store(out + (size_t)NL * N, N, i, y3);
  out[(size_t)2 * NL * N + i] = paired ? 0 : inf1;
}

extern "C" int msm_aff_post_packed_u(void* out, const void* A, int sa, const void* B, int sb, const void* sA,
                                     const void* sB, const void* dinv, int sd, const void* hp,
                                     const uint32_t* field, int N, void* stream) {
  if (N > 0)
    aff_post_packed_u_kernel<12><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)A, sa, (const int32_t*)B, sb, (const int32_t*)sA, (const int32_t*)sB,
        (const int32_t*)dinv, sd, (const int32_t*)hp, field_from<12>(field), N);
  return (int)cudaGetLastError();
}
