// Kernel 2: complete projective addition for a = 0 (Renes-Costello-Batina
// 2015/1060, Alg. 7): 12 products and 2 products by the constant 3b.
//
// Replaces the Pallas kernel "proj_add_rcb" of
// montgomery_tpu/curves/projective.py (ProjectiveOps._add_rcb and
// _add_rcb_formula, :153-194). Valid for every input pair of the odd-order
// subgroup, P == Q, P == -Q and the zero point (Z == 0) included.
//
// Bound on this card: 14 CIOS products per lane (about 4,000 32-bit
// multiplies). Latency first: one thread's formula is a chain of 14
// dependent products (1.75 us each at NL = 12), and the bucket reduction's
// tree levels and scans launch 10 to 20,480 lanes, which no such chain
// fills the card with. Two bodies, chosen by the wrapper from the lane
// count (ProjectiveOps.add), equal bit for bit (the same field operations
// in the same order on the same values; coop_mul equals fe_mul):
// - six threads a lane (32 lanes a block, warp r plays role r for all of
//   them): the formula's three dependent stages (6 | 2 | 6 products) run
//   their products on separate threads in one-thread CIOS, the values
//   between stages in shared memory, so the critical path is 3 one-thread
//   products and a launch of N lanes has 6 N threads to hide it. On an H100
//   it also beats one thread a lane where that fills the card (0.93 against
//   1.65 ms at 2^20 lanes, chip_smoke.py: 36 resident warps a SM against
//   the 8 that the one-thread formula's registers allowed), so it replaced
//   that body at every width;
// - few (one block of COOP_ADD_WARPS warps a lane, below the wrapper's
//   threshold): coop_add (projective.cuh), each stage's products on
//   separate warps and each product on a whole warp (coop.cuh), so the
//   critical path is 3 warp products (0.72 us each).
// The lazy sums stay below 6p, so no reduction runs between products,
// exactly as in the JAX formula.
#include "projective.cuh"

// 32 lanes a block, warp r plays role r for all of them
#define ADD_WARPS 6
#define ADD_SLOTS 12

// slot s of lane l: word k at sm[s][k][l], so a warp's 32 lanes hit 32 banks
template <int NL>
__device__ __forceinline__ void slot_get(uint32_t (&r)[NL], const uint32_t (*slot)[32], int l) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = slot[k][l];
}

template <int NL>
__device__ __forceinline__ void slot_put(uint32_t (*slot)[32], int l, const uint32_t (&a)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; k++) slot[k][l] = a[k];
}

template <int NL>
__global__ void __launch_bounds__(32 * ADD_WARPS)
proj_add_rcb_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                    const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                    const int32_t* __restrict__ Z1, const int32_t* __restrict__ X2,
                    const int32_t* __restrict__ Y2, const int32_t* __restrict__ Z2, Fe<NL> b3,
                    FieldParams<NL> F, int N) {
  // slots 0-5: stage A's products t0, t1, t2, m0, m1, m2, then stage C's
  // Xa, Xb, Ya, Yb, Za, Zb; 6-11: Z3s, t1m, Y3b, t3, t4, 3 t0
  __shared__ uint32_t sm[ADD_SLOTS][NL][32];
  int role = threadIdx.x >> 5, l = threadIdx.x & 31;
  int i = blockIdx.x * 32 + l;
  bool live = i < N;
  uint32_t a[NL], b[NL], r[NL];
  // stage A: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
  if (live) {
    const int32_t* p1 = role == 1 || role == 4 ? Y1 : role == 2 ? Z1 : X1;
    const int32_t* p2 = role == 1 || role == 4 ? Y2 : role == 2 ? Z2 : X2;
    fe_load(a, p1, N, i);
    fe_load(b, p2, N, i);
    if (role >= 3) {
      const int32_t* q1 = role == 3 ? Y1 : Z1;
      const int32_t* q2 = role == 3 ? Y2 : Z2;
      fe_load(r, q1, N, i);
      fe_add_lazy(a, a, r);
      fe_load(r, q2, N, i);
      fe_add_lazy(b, b, r);
    }
    fe_mul(r, a, b, F);
    slot_put(sm[role], l, r);
  }
  __syncthreads();
  // stage B: 3b Z1Z2 and then Z3s, t1m; 3b (X1Z2 + X2Z1); beside them the
  // cross sums t3, t4 (each + 4p) and 3 X1X2
  if (live) {
    if (role == 0) {
      slot_get(a, sm[2], l);
      fe_mul(b, a, b3.v, F);  // t2b
      slot_get(a, sm[1], l);
      fe_add_lazy(r, a, b);
      slot_put(sm[6], l, r);   // Z3s
      fe_sub_lazy(r, a, b, F);
      slot_put(sm[7], l, r);   // t1m
    } else if (role == 1) {
      slot_get(a, sm[0], l);
      slot_get(b, sm[2], l);
      fe_add_lazy(r, a, b);
      slot_get(a, sm[5], l);
      fe_sub_lazy(b, a, r, F);  // t5
      fe_mul(r, b, b3.v, F);
      slot_put(sm[8], l, r);   // Y3b
    } else if (role < 5) {
      // role 2: t3 = m0 - (t0 + t1); role 3: t4 = m1 - (t1 + t2); role 4: 3 t0
      slot_get(a, sm[role == 3 ? 1 : 0], l);
      slot_get(b, sm[role == 2 ? 1 : role == 3 ? 2 : 0], l);
      fe_add_lazy(r, a, b);
      if (role == 4) {
        fe_add_lazy(r, r, a);
      } else {
        slot_get(a, sm[role + 1], l);
        fe_sub_lazy(r, a, r, F);
      }
      slot_put(sm[7 + role], l, r);
    }
  }
  __syncthreads();
  // stage C: Xa = t3 t1m, Xb = t4 Y3b, Ya = t1m Z3s, Yb = Y3b 3t0,
  // Za = Z3s t4, Zb = 3t0 t3
  if (live) {
    // the operands' slots, nibble `role` of each word (no local array)
    slot_get(a, sm[(0xB687A9 >> (4 * role)) & 15], l);
    slot_get(b, sm[(0x9AB687 >> (4 * role)) & 15], l);
    fe_mul(r, a, b, F);
    slot_put(sm[role], l, r);
  }
  __syncthreads();
  if (live && role < 3) {
    slot_get(a, sm[2 * role], l);
    slot_get(b, sm[2 * role + 1], l);
    if (role == 0) fe_sub(r, a, b, F);
    else fe_add(r, a, b, F);
    fe_store(role == 0 ? X3 : role == 1 ? Y3 : Z3, N, i, r);
  }
}

template <int NL>
__global__ void __launch_bounds__(32 * COOP_ADD_WARPS)
proj_add_rcb_few_kernel(int32_t* __restrict__ X3, int32_t* __restrict__ Y3, int32_t* __restrict__ Z3,
                        const int32_t* __restrict__ X1, const int32_t* __restrict__ Y1,
                        const int32_t* __restrict__ Z1, const int32_t* __restrict__ X2,
                        const int32_t* __restrict__ Y2, const int32_t* __restrict__ Z2, Fe<NL> b3,
                        Fe<NL> mu, FieldParams<NL> F, int N) {
  __shared__ CoopPoint<NL> S;
  int i = blockIdx.x;
  coop_init(S, F, mu, b3);
  coop_load_point<NL>(S.X, S.Y, S.Z, X1, Y1, Z1, N, i, threadIdx.x, blockDim.x);
  coop_load_point<NL>(S.X2, S.Y2, S.Z2, X2, Y2, Z2, N, i, threadIdx.x, blockDim.x);
  __syncthreads();
  coop_add(S, F);
  coop_store_point(X3, Y3, Z3, N, i, S);
}

// few: 0 six threads a lane, 1 a block a lane
template <int NL>
static int launch(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1, const void* X2,
                  const void* Y2, const void* Z2, const uint32_t* b3, const uint32_t* mu, const uint32_t* field,
                  int N, int few, void* stream) {
  int32_t *x3 = (int32_t*)X3, *y3 = (int32_t*)Y3, *z3 = (int32_t*)Z3;
  const int32_t *x1 = (const int32_t*)X1, *y1 = (const int32_t*)Y1, *z1 = (const int32_t*)Z1;
  const int32_t *x2 = (const int32_t*)X2, *y2 = (const int32_t*)Y2, *z2 = (const int32_t*)Z2;
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && few)
    proj_add_rcb_few_kernel<NL><<<N, 32 * COOP_ADD_WARPS, 0, st>>>(
        x3, y3, z3, x1, y1, z1, x2, y2, z2, fe_from<NL>(b3), fe_from<NL>(mu), field_from<NL>(field), N);
  else if (N > 0)
    proj_add_rcb_kernel<NL><<<(N + 31) / 32, 32 * ADD_WARPS, 0, st>>>(
        x3, y3, z3, x1, y1, z1, x2, y2, z2, fe_from<NL>(b3), field_from<NL>(field), N);
  return (int)cudaGetLastError();
}

#if MSM_AT(12)
extern "C" int msm_proj_add_rcb(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1,
                                const void* X2, const void* Y2, const void* Z2, const uint32_t* b3,
                                const uint32_t* mu, const uint32_t* field, int N, int few, void* stream) {
  return launch<12>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, b3, mu, field, N, few, stream);
}
#endif

#if MSM_AT(13)
extern "C" int msm_proj_add_rcb_n13(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1,
                                    const void* Z1, const void* X2, const void* Y2, const void* Z2,
                                    const uint32_t* b3, const uint32_t* mu, const uint32_t* field, int N, int few,
                                    void* stream) {
  return launch<13>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, b3, mu, field, N, few, stream);
}
#endif

#if MSM_AT(9)
extern "C" int msm_proj_add_rcb_n9(void* X3, void* Y3, void* Z3, const void* X1, const void* Y1, const void* Z1,
                                   const void* X2, const void* Y2, const void* Z2, const uint32_t* b3,
                                   const uint32_t* mu, const uint32_t* field, int N, int few, void* stream) {
  return launch<9>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, b3, mu, field, N, few, stream);
}
#endif

// resident blocks a SM of each body (few as in msm_proj_add_rcb) at this
// entry point's limb count: with the lanes a block carries, the lanes one
// wave of a launch covers
template <int NL>
static int blocks_per_sm(int few) {
  int blocks = 0;
  if (few)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, proj_add_rcb_few_kernel<NL>, 32 * COOP_ADD_WARPS, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, proj_add_rcb_kernel<NL>, 32 * ADD_WARPS, 0);
  return blocks;
}

#if MSM_AT(12)
extern "C" int msm_proj_add_rcb_blocks_per_sm(int few) { return blocks_per_sm<12>(few); }
#endif

#if MSM_AT(13)
extern "C" int msm_proj_add_rcb_blocks_per_sm_n13(int few) { return blocks_per_sm<13>(few); }
#endif

#if MSM_AT(9)
extern "C" int msm_proj_add_rcb_blocks_per_sm_n9(int few) { return blocks_per_sm<9>(few); }
#endif
