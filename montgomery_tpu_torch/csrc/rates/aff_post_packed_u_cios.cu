// The body of aff_post_packed_u on CIOS products (field.cuh's fe_mul and
// fe_sqr) that csrc/aff_post_packed_u.cu's carry-chain body replaced, kept
// as a probe so that chip_smoke.py can time the two in turns on one card
// and check them bit for bit. Not part of the kernels' library: it is built
// on its own, once per limb count (-DMSM_LIMBS=n), beside it.
//
// Per lane, as the kernel: the lane's inverse from the parent level's inv1
// and the partner's denominator (one CIOS product; inv1[h] or inv1[i]
// alone where the kernel takes it so), the signs folded into y, affine.cuh's
// aff_chord on CiosMul, the sum where hp != 0 and the sign-applied A where
// hp == 0; bit for bit the kernel's values. It keeps the parent's
// __launch_bounds__ minimum of resident blocks an SM, chosen for this body
// on an H100 80GB HBM3 at 700 W (5 at 12 and 9 limbs, 3 at 13). Its entry
// points take the kernel's arguments, so chip_smoke.py can put one in place
// of the kernel's behind AffineOps.post_packed_u.
#include "../affine.cuh"

__host__ __device__ constexpr int cios_min_blocks(int NL) { return NL == 13 ? 3 : 5; }

template <int NL>
__global__ void __launch_bounds__(LANES_PER_BLOCK, cios_min_blocks(NL))
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
  aff_chord<NL, CiosMul>(x3, y3, x1, y1, x2, y2, d, F);
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

#define PROBE_ENTRY(n)                                                                                         \
  extern "C" int probe_aff_post_packed_u_n##n(void* out, const void* A, int sa, const void* B, int sb,         \
                                              const void* sA, const void* sB, const void* inv1, int si,        \
                                              const void* denom, int sd, int h, const void* hp,                \
                                              const uint32_t* field, int N, void* stream) {                    \
    return launch<n>(out, A, sa, B, sb, sA, sB, inv1, si, denom, sd, h, hp, field, N, stream);                \
  }

#if MSM_AT(12)
PROBE_ENTRY(12)
#endif
#if MSM_AT(13)
PROBE_ENTRY(13)
#endif
#if MSM_AT(9)
PROBE_ENTRY(9)
#endif
