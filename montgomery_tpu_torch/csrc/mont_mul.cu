// Kernel 5: Montgomery product of two planes, lane by lane.
//
// Replaces the Pallas kernel "mont_mul" of montgomery_tpu/ops/field.py
// (FieldOps.mul, :431-448, over _mul_dot + _mont_reduce_wide). On the MSM
// path it runs every level of the batch-inversion tree (FieldOps.batch_inv),
// up and down: up to 30 launches per batched-affine add (248 per MSM at 2^20).
//
// Bound on this card: one 12-word CIOS product per lane, 288 32x32->64
// multiplies, against 96 bytes read and 48 written; at 1 M lanes that is
// 0.3 G wide multiplies (about 36 us at the 32 per SM per clock that
// csrc/rates/imad_rate.cu measures) against 144 MB (about 43 us at
// 3.35 TB/s), so the two bounds are close. Design: one
// thread per lane, coalesced limb-plane loads; each operand carries its own
// row stride, so the tree's contiguous halves (column slices of one plane)
// are read in place, with no copy, as the TPU read its halves.
#include "field.cuh"

__global__ void __launch_bounds__(LANES_PER_BLOCK)
mont_mul_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx,
                const int32_t* __restrict__ y, int sy, FieldParams F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL], b[NL], r[NL];
  fe_load(a, x, sx, i);
  fe_load(b, y, sy, i);
  fe_mul(r, a, b, F);
  fe_store(out, N, i, r);
}

extern "C" int msm_mont_mul(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field,
                            int N, void* stream) {
  FieldParams F;
  memcpy(&F, field, sizeof(F));
  if (N > 0)
    mont_mul_kernel<<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, (const int32_t*)y, sy, F, N);
  return (int)cudaGetLastError();
}
