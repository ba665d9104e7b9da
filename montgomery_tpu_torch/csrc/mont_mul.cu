// Kernel 5: Montgomery product of two planes, lane by lane.
//
// Replaces the Pallas kernel "mont_mul" of montgomery_tpu/ops/field.py
// (FieldOps.mul, :431-448, over _mul_dot + _mont_reduce_wide). On the MSM
// path it runs every level of the batch-inversion tree (FieldOps.batch_inv),
// up and down: up to 30 launches per batched-affine add (248 per MSM at 2^20).
//
// Entry points: msm_mont_mul (12 limbs, BLS12-377's base field),
// msm_mont_mul_n13 (13 limbs, BLS12-381's) and msm_mont_mul_n9 (9 limbs:
// Pallas's, and ed-on-bls12-377's, where it also runs the T = x y of the
// point ingestion, the on-curve check and the inversion tree of to_host);
// msm_mont_mul_n1, _n2 and _n3 serve the example fields small (p = 101),
// babybear (2^31 - 1) and goldilocks (2^64 - 2^32 + 1).
//
// Bound on this card: one NL-word CIOS product per lane, 2 NL^2 32x32->64
// multiplies, against 12 NL bytes moved; at NL = 12 and 1 M lanes that is
// 0.3 G wide multiplies (about 36 us at the 32 per SM per clock that
// csrc/rates/imad_rate.cu measures) against 144 MB (about 43 us at
// 3.35 TB/s), so the two bounds are close; at NL = 9 the multiplies shrink
// by (9/12)^2 and the bytes by 9/12, so memory bounds it, and at NL = 1-3
// (12 to 36 bytes against 2 to 18 products a lane) far more so. Design: one
// thread per lane, coalesced limb-plane loads; each operand carries its own
// row stride, so the tree's contiguous halves (column slices of one plane)
// are read in place, with no copy, as the TPU read its halves.
#include "field.cuh"

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
mont_mul_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, int sx,
                const int32_t* __restrict__ y, int sy, FieldParams<NL> F, int N) {
  int i = lane_index();
  if (i >= N) return;
  uint32_t a[NL], b[NL], r[NL];
  fe_load(a, x, sx, i);
  fe_load(b, y, sy, i);
  fe_mul(r, a, b, F);
  fe_store(out, N, i, r);
}

template <int NL>
static int launch(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field, int N,
                  void* stream) {
  if (N > 0)
    mont_mul_kernel<NL><<<grid_for(N), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)x, sx, (const int32_t*)y, sy, field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_mont_mul(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field,
                            int N, void* stream) {
  return launch<12>(out, x, sx, y, sy, field, N, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_mont_mul_n13(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field,
                                int N, void* stream) {
  return launch<13>(out, x, sx, y, sy, field, N, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_mont_mul_n9(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field,
                               int N, void* stream) {
  return launch<9>(out, x, sx, y, sy, field, N, stream);
}
#endif

#if MSM_AT(1)
extern "C" int msm_mont_mul_n1(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field,
                               int N, void* stream) {
  return launch<1>(out, x, sx, y, sy, field, N, stream);
}
#endif

#if MSM_AT(2)
extern "C" int msm_mont_mul_n2(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field,
                               int N, void* stream) {
  return launch<2>(out, x, sx, y, sy, field, N, stream);
}
#endif

#if MSM_AT(3)
extern "C" int msm_mont_mul_n3(void* out, const void* x, int sx, const void* y, int sy, const uint32_t* field,
                               int N, void* stream) {
  return launch<3>(out, x, sx, y, sy, field, N, stream);
}
#endif
