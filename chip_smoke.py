#!/usr/bin/env python3
"""GPU smoke run of montgomery_tpu_torch on one CUDA card.

Builds the CUDA kernels from `montgomery_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version on the card, runs BLS12-377, BLS12-381 and
Pallas MSMs on every engine and ed-on-bls12-377 (Twisted Edwards) MSMs,
directly and through `serve.compute_msm`, against the bigint oracle and
against a closed form,
runs the planar batched-affine adds against the oracle and the sharded MSM
on logical meshes of the one card, generates random points of both curves
on the card by sqrt trial and runs MSMs on them, runs the micro-benchmark
with the baselines' kernels (the divstep inverse of plain values, the
Barrett product), runs the rest of the JAX package's API (host and non-GLV
MSM entries, window_chunk, the curve predicates, the example fields' ops),
runs curves with a != 0 (NIST P-256 and P-384: the general-a group law and
the safe triage kernels' a term), and times them.

    python3 chip_smoke.py

Phases, each printed as it runs:
  0. environment: torch, CUDA, nvcc, triton, card name, power limit and
     maximum SM clock, kernel build time and register counts, and the
     measured rates of the 32x32->64 and the low 32-bit multiply
     (`montgomery_tpu_torch/csrc/rates/imad_rate.cu`, built beside the
     kernels) that the operation bounds divide by; the latency of one
     dependent Montgomery product in one thread (fe_mul and the carry-chain
     fe_mul_cc of `csrc/madc.cuh`) and on one warp at 12, 13 and 9 limbs
     (`csrc/rates/mul_latency.cu`, the chains equal bit for bit), which the
     window combines' dependent-chain floors multiply; one dependent
     square's latency and the squares' throughput in three forms (CIOS-row
     fe_sqr, the carry-chain fe_sqr_cc, fe_mul_cc(a, a); `square_rates`,
     equal bit for bit), from which exp_ladder takes its square; the SASS
     opcode histograms of one product and one square (the one-thread
     chains) and of proj_dbl_rcb's wide body, ed_add_packed and the chord's
     two kernels, with the redesigned bodies' ptxas registers and spills
     (the CIOS bodies those redesigns replaced, kept under `csrc/rates/`,
     are no longer built: their turns stand in PERF.md); the latency of
     the safegcd core's 30 divsteps and matrix application in one thread
     and of a whole batch on a warp (`csrc/rates/divstep_latency.cu`),
     which the divstep inverses' floors multiply; ptxas of every
     kernel function (registers, stack frame, spill, shared memory), and
     each instantiation BLS12-381 (13 limbs) and Pallas (9 limbs) brought
     must be in the log, as must every instantiation at 1, 2 and 3 limbs
     (`phase_new_ptxas`); each of glv_digits' three instantiations must show
     no stack frame and no spill in ptxas;
  1. each kernel against its plain version on the same tensors, with
     adversarial values in the first lanes (canonical values must be equal;
     the packed adds' first lanes cover every flag class of the safe add:
     doubling, cancellation, each infinite operand, unpaired lanes, unreduced
     representatives and the order-2 point (p - 1, 0)): at 2^16 and 2^16 + 17
     lanes, and the batched-affine kernels also at the widths the main path
     gives them (the first super-round level at 2^16 and 2^20 points and its
     halves for mont_mul and both packed adds; pack_glv at 2^20 points;
     mont_sqr at 2^20 lanes, the on-curve check of compute_msm;
     divstep_inv_mont at 512, the batch-inversion root); each timed (CUDA
     events) on the tensors it was checked on, at the 2^16 path's width
     (mont_sqr at 2^20), beside its plain version's time and a lower bound
     from bytes moved or multiplies. Then the two kernels redesigned for
     this card at the main paths' shapes (`phase_redesign`): the window
     combine proj_combine_rcb for (K, c) = (10, 13) and (12, 11), 10 fresh
     inputs each with identity windows, bit for bit against the plain Horner
     and as points against the halving combine through the one-thread
     double_n (the log-depth combine it replaced, timed beside it), with
     its bound and dependent-chain floor; proj_dbl_rcb's few-lane body at
     k = 6 on 10 lanes and on 1 lane
     (10 fresh inputs, bit for bit against the plain version and the
     one-thread body), both bodies timed on 10 lanes and a doubling's time
     on one lane; the fused aff_post_packed_u at 1, 513, 835,592 (10 fresh
     inputs each) and 10,649,608 lanes, bit for bit against its plain
     version and against the full batch_inv with the plain chord, timed at
     the two widest beside the descent level it replaced; proj_add_rcb's
     two bodies (six threads a lane; a block a lane below FEW_ADD_LANES)
     at 1 lane and every width window_sums launches at 2^20 (10 to 2,560
     lanes), 10 fresh inputs each with identities, P == Q, P == -Q and
     unreduced values, bit for bit against add_plain and each other, then
     both timed (device time a launch) at 20 and 80 lanes; glv_digits
     at 2^16 and 2^20 for every c of the window table, bit for bit against
     digits_glv_plain with the edge scalars (0, 1, q - 1, q - 2, 2^252 and
     near-integer s g / 2^m) in the first lanes, BLS12-381's and Pallas's
     instantiations at 2^16, a size it lacks refused, and its device time
     at 2^20; the safegcd inverse (`redesign_divstep`, here and for
     BLS12-381 and Pallas in their phase 1): divstep_inv_mont (a warp a
     lane) at 1, 512 and every root width of the main path at 2^16 and 2^20
     (recorded from the batch-inversion tree), 10 fresh inputs each with 0,
     1, p - 1, R mod p, [p, 2p) values and the most-batches input of 2^16
     drawn in the first lanes, bit for bit; its device time at 512 lanes and
     at 1 beside inv_mont_divstep's, its bound from the batches the inputs
     need and its dependent-chain floor; divstep_inv at 512, 2^16, 2^18 and
     2^18 + 17 lanes bit for bit and timed at 2^18. Then proj_dbl_rcb's
     wide body on the carry-chain product (`redesign_dbl`, here at 12
     limbs, and for BLS12-381 and Pallas in their phase 1) at 1, 3,072,
     2^16 + 17 and 2^20 lanes for k = 1, 5 and 92 on the bench points with
     random Z, infinity and [p, 2p) values, bit for bit against the plain
     version (on every lane, or 1,024 at each end); then the cofactor stage
     of the random points at 2^20 (`profile_cofactor`), each launch's device
     time with its k, lanes and bound. Then the
     unsafe chord on carry chains (`redesign_chord`, here at 12 limbs and
     for BLS12-381 and Pallas in their phase 1): aff_post_packed_u at the
     first super-round level of the 2^16 and 2^20 paths and aff_post_unsafe
     at 2^20 lanes, flag classes and 0, 1, p - 1, [p, 2p) values in the
     first lanes, bit for bit on every lane against the plain version, both
     timed; then
     mul_const's device time at 2^20 and 2,621,456 lanes
     (`mul_const_widths`).
     Then the Twisted Edwards path's kernels
     the same way (`phase_te_kernels`): mont_mul, mul_const and
     divstep_inv_mont at 9 limbs, ed_add, ed_dbl (k = 1, 13 and the 2^20
     combine's first level before ed_combine) and ed_add_packed up to the
     first super-round level at 2^20 points, with the identity on either
     side, P + P, P + (-P), unreduced values and every sign and pair flag in
     the first lanes; then the Twisted Edwards window combine ed_combine
     (`redesign_te_combine`) at (K, c) = (20, 13) and (23, 11), 10 fresh
     inputs each with identity windows, bit for bit against the plain Horner
     and as points against the halving combine it replaced (ed_dbl and
     ed_add a level), timed beside it (events, and the profiler's device ms
     with the host ms), with its bound and dependent-chain floor; ed_add and
     ed_dbl (k = 1 and 6) on both bodies (one thread a lane; the
     narrow-launch body below EdwardsOps.FEW_ADD_LANES / FEW_DBL_LANES) at
     1 to 2^20 lanes (`redesign_ed_add`), bit for bit against the plain
     version; and ed_add_packed on the carry-chain product
     (`redesign_ed_packed`) at 1 lane, bit for bit against the plain
     version, and timed at the 2^20 path's first level (10,813,448 lanes).
     Then
     the sqrt slice's kernels (`phase_sqrt_kernels`) at 12 and 9 limbs:
     exp_ladder (e = p - 2 and (q - 1) / 2), sqr_n (m = 1, 42, 43 and every
     chain) and every sqrt_win window of one whole sqrt, bit for bit, at
     1, 2^16 and 2^16 + 17 lanes with 0, 1, p - 1, [p, 2p) values, known
     squares and known non-squares in the first lanes, and sqrt_win at every
     window and the whole sqrt at the 2,621,456 candidates of a 2^20-point
     generation (1,024 sampled lanes against pow() and Euler's criterion);
     inv against inv_root; each timed at 2,621,456 lanes; exp_ladder (the
     sliding window on carry chains, `ladder_checks`; here and for
     BLS12-381 and Pallas at 2^20 in their phase 1) at e = (q - 1) / 2 and
     p - 2 on 1, 17, 2^16 + 17 lanes and the path's width, bit for bit
     against its plain version, timed at the path's width with the new and
     the old bound. Then the
     planar adds' kernels (`planar_kernels`: aff_pre, aff_post,
     aff_pre_unsafe with and without its validity mask, aff_post_unsafe)
     bit for bit at 2^16, 2^16 + 17 and 2^20 lanes, every flag class in the
     first lanes, each timed at 2^20. Then the baselines' kernels
     (`phase_alt_kernels`): divstep_inv and barrett_mul bit for bit at
     2^18, 2^18 + 17 and 512 (divstep_inv) or 2^20 (barrett_mul) lanes of
     canonical values with 0, 1, 2, p - 1, p - 2 and the squares nearest p^2
     in the first lanes, 1,024 lanes against Python's ints, barrett_mul
     against the Montgomery route on every lane, at 9 limbs too (2^16), and
     at 13, 1, 2 and 3 limbs (BLS12-381's field, small, babybear,
     goldilocks) at 2^18 and 2^16 + 17 with the same checks, each launch
     counted at its limb count; each timed at 2^18 (9 limbs: 2^16; the new
     counts also by the profiler, and beside barrett_mul the int64
     x y % p where p < 2^31);
  2. the MSM at N = 16 and N = 2^9 against the bigint oracle: the projective
     and the safe batched-affine engine with zero scalars, duplicate and
     negated duplicate points and the point at infinity; the unsafe engine
     (affine=True, unsafe=True) on distinct random points with zero scalars;
     the affine engines at the default c (a pair round first) and at c = 4
     (the 8-way super-round first); serve.compute_msm from ints and from
     bytes, and its ValueError on an off-curve point, misaligned bytes and a
     length mismatch. Then the planar adds (`phase_planar_oracle`):
     batch_add and batch_add_unsafe (masked too) on the lanes of
     tests/test_curve_ops.py and the 640-lane grids of
     tests/test_grid_combine.py against the oracle, and at 2^20 lanes on
     1,024 sampled lanes, with launch counts and times. Then the same as
     above for the Twisted Edwards engine (EdwardsMsm, 9 limbs; the
     identity in place of infinity) and compute_msm(curve="ed-on-bls12-377");
  3. per path (affine-unsafe, affine-safe and projective) and size (N = 2^16,
     2^20, c from window_size) on random_points_fast(seed=42) points: launch
     counts of a run with the counts set to 0 just before it (every kernel of
     the path must launch, no kernel of another add or curve may, and every
     launch must be at the path's limb count; on the main path, affine-unsafe
     at 2^20, the redesigned kernels' counts are MAIN_PATH_LAUNCHES), the
     check at full N against
     S = sum_t (sum_i s_i (idx[t, i] + 3) mod q) B_t, median of 5 runs,
     phase split, peak memory and the round plan (affine-unsafe at 2^20, the
     main path, also its device time by kernel under torch.profiler, the
     device's busy share, and each proj_add_rcb launch's device time with
     its lane count and body); the unsafe and the safe
     add timed in turns at both sizes; then the safe engine at 2^16 on 2^12
     bench points each used 16 times under one scalar, some negated, some
     infinite, some scalars 0 (against the projective engine and the closed
     form); then serve.compute_msm at 2^20 from packed bytes with the
     on-curve check, against the closed form, with its ingestion and
     on-curve check timed apart. Then the Twisted Edwards MSM the same way at
     2^16 and 2^20 on random_points_fast_edwards(seed=42) points (msm_full,
     so to_host's kernels count too; at 2^20 ed_combine, ed_dbl and ed_add
     launch 1, 1 and 37 times, and the device time by kernel is profiled
     with the halving combine and with ed_combine), and compute_msm(curve=
     "ed-on-bls12-377") at 2^20 from packed bytes; then the Twisted Edwards
     MSM at 2^20 profiled on either ed_add_packed body
     (`profile_te_packed`: each launch's device time, lanes and bound), and
     on ed_add's and ed_dbl's bodies (`profile_te_add`: each of the 37
     ed_add and the ed_dbl launch's device time, lanes and body, summed
     beside the bound and dependent-chain floor);
  4. random_points_weierstrass (BLS12-377) and random_points_edwards
     (ed-on-bls12-377) at 2^20 points (`phase_points`): launch counts of one
     generation (exp_ladder 1, sqr_n 11, sqrt_win 12, every launch at the
     curve's limb count), the median of 3 generations split into host draw,
     solve, compaction, cofactor and normalisation, peak memory; every point
     on the curve and not infinite, success flags against Euler's criterion
     and sampled points against the bigint oracle's rebuild from the same
     draw, q P = 0; then MSMs on those points: BLS12-377's three engines
     agree at 2^20, the Twisted Edwards one at two window sizes, and both
     equal the oracle at N = 512;
  5. (run before phase 4, while the bench points are on the card) the
     sharded MSM (`phase_sharded`): msm_full_sharded on logical meshes of
     1, 2, 4 and 8 shards of the card, every engine, against the oracle at
     N = 512 (a zero scalar, one point under one scalar in two shards), and
     at 2^16 and 2^20 against the closed form and the single-device engine,
     with launch counts at 8 shards and the median of 3 at 2^20; then
     msm_sharded with the Twisted Edwards adapter at 2 shards and 2^16.
     Every MSM path, sharded ones included, must launch none of the planar
     adds' kernels;
  7. (after phase 5) the rest of the JAX package's API (`phase_api`,
     `phase_example_fields`), each run's launches counted: the non-GLV
     engines at 2^20 (msm_device on signed_digits_device digits, c = 13),
     window_chunk 4 on the affine-unsafe msm_device_full and 5 on the
     Twisted Edwards msm_device at 2^20 beside no chunking, msm, msm_glv and
     EdwardsMsm.msm at 2^16 from Python ints and the size sweep at
     2^12 -+ 17 (safe and unsafe, msm_full and msm), all against the
     closed form with medians of 5 and peak memory where timed;
     is_on_curve and is_in_subgroup at 2^20 lanes with 18 adversarial
     lanes (BLS12-377's order-2 point (p - 1, 0), points without cofactor
     clearing, infinity; on Twisted Edwards the order-2 and order-4 points)
     against the oracle; the thirteen example fields of 1, 2, 3, 9, 12 and
     13 limbs at 2^20 lanes (mul, square, add_no_reduce, sub_positive,
     left_shift, inv, batch_inv, sqrt: each kernel bit for bit with its
     plain version on 2^16 lanes, every op against Python's ints on 1,024
     lanes, each op's launches at the field's limb count, each timed); at
     1-3 limbs each field kernel also timed on its own (`small_field_times`:
     device time a launch, bound, share; mont_mul, mont_sqr and mul_const
     at 2^24 lanes too, and the int64 x y % p beside mont_mul where
     p < 2^31); then a 5-limb field (2^127 - 1) must raise
     NotImplementedError on the card in every kernel op;
  6. (last) the micro-benchmark (`phase_micro`): micro_bench.main with every
     section at 2^18 lanes, the Barrett chain against the plain chain, and
     inv_divstep and inv_mont_divstep at 2^18 against the Fermat ladder on
     every lane (the ladder run outside the counted run), timed, the two multiply chains' device time a launch
     (torch.profiler), with launch counts (run "micro_2^18": divstep_inv
     and barrett_mul must launch, no curve kernel may) and the memory
     report. No other path may launch divstep_inv or barrett_mul.
Between phases 4 and 6, BLS12-381 and Pallas (`phase_new_curves`), each on
  its own 2^20 bench points: phase 1, every kernel at the curve's limb count bit
  for bit with its plain version at 1, 17, 40, 640, 2^16 and 2^16 + 17
  lanes on adversarial inputs (sqrt_win and the whole sqrt also at 2^20
  lanes), and timed (events, the profiler's device
  time, bound, share) at the 12-limb table's widths; phase 2, every engine
  and compute_msm against the oracle at N = 16 and 512; phase 3, every
  engine at 2^16 and 2^20 (BLS12-381's unsafe one also at 2^18) against
  the closed form, every launch at the curve's limb count and none at 12,
  with the main path's profile, and compute_msm at 2^20 from bytes; phase
  4, random_points_weierstrass at 2^16.
  8. (after them, before phase 6) curves with a != 0 (`phase_general_a`,
     montgomery_tpu_torch/testing/curves.py): the a = 0 instantiation of
     aff_pre and aff_pre_packed must keep the parent's ptxas registers at
     9, 12 and 13 limbs (the turns against the parent's body stand in
     PERF.md); both kernels with the a term bit for bit with their plain
     versions at 1, 17, 640, 2^16 and 2^16 + 17 lanes (every flag class
     first) and timed at 9 (P-256) and 13 (P-384) limbs; P-256's engines
     through msm (host digits) against the bigint oracle at N = 16 and 512
     (duplicates, negations, infinity, zero scalars; the unsafe one on
     distinct points), and through msm_device on signed_digits_device
     digits at 2^16 and 2^20 on random_points_fast(seed=42) points against
     the closed form (no RCB kernel may launch; medians of 5, peak memory
     and the stages' split at 2^20); the adversarial safe set at 2^16; the
     projective predicates at 2^16 lanes with off-curve and infinite
     lanes; the planar batch_add and batch_double at 2^20 lanes (1,024
     sampled lanes against the oracle); random_points_weierstrass at 2^16
     (`phase_points`). P-384: the engines at 2^16 and the oracle at N = 16.
The last lines are a JSON object of per-kernel details, the JSON object of
per-kernel results (13- and 9-limb measurements under "n13" and "n9" or
"n9_weierstrass"), the card's name and power limit, and a JSON object
{"ok": true, "device": {...}}. Any failure raises; without a CUDA device the
script exits 1 before printing a result.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import random
import re
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED_POINTS = 42
SEED_SCALARS = 7
KERNEL_LANES = (1 << 16, (1 << 16) + 17)  # main-path width, and a ragged edge
ROOT_LANES = 512  # FieldOps.BATCH_INV_STOP: the width of every divstep root
MSM_LOG2N = (16, 20)
PATHS = ("affine_unsafe", "affine_safe", "projective")
KERNEL_REPS = 200  # back-to-back launches per kernel timing (tens of ms on the card)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
RATE_SRC = ROOT / "montgomery_tpu_torch" / "csrc" / "rates" / "imad_rate.cu"
LATENCY_SRC = ROOT / "montgomery_tpu_torch" / "csrc" / "rates" / "mul_latency.cu"
DIVSTEP_LATENCY_SRC = ROOT / "montgomery_tpu_torch" / "csrc" / "rates" / "divstep_latency.cu"
CHORD_TURN_REPS = 10  # launches a turn of the chord's two kernels (CUDA events, then the profiler)
CHORD_PLANAR_LANES = 1 << 20  # aff_post_unsafe's checks and turns
MUL_CONST_WIDTHS = (1 << 20, 2_621_456)  # mul_const's widths on its paths at 12 limbs: expand, points
# kernels each path must launch (the affine paths' bucket reduction is
# projective), and those of the other packed add, which it must not
_AFFINE = {"glv_digits", "pack_glv", "mont_mul", "divstep_inv_mont", "proj_add_rcb", "proj_dbl_rcb",
           "proj_combine_rcb"}
_UNSAFE, _SAFE = {"aff_pre_packed_u", "aff_post_packed_u"}, {"aff_pre_packed", "aff_post_packed"}
_EDWARDS = {"ed_add", "ed_dbl", "ed_add_packed", "ed_combine"}
_WEIERSTRASS = _AFFINE | _UNSAFE | _SAFE | {"mont_sqr"}
# the planar adds' kernels: launched by AffineOps.batch_add / batch_add_unsafe,
# never by an MSM path (sharded ones included)
_PLANAR = {"aff_pre", "aff_post", "aff_pre_unsafe", "aff_post_unsafe"}
PATH_KERNELS = {
    "projective": {"mul_const", "proj_add_rcb", "proj_dbl_rcb", "proj_combine_rcb", "glv_digits"},
    "affine_unsafe": _AFFINE | _UNSAFE,
    "affine_safe": _AFFINE | _SAFE,
    "serve": _AFFINE | _SAFE | {"mul_const", "mont_sqr"},
    # msm_full: the MSM, then to_host (a batch inversion of Z and a product)
    "te": _EDWARDS | {"mont_mul", "divstep_inv_mont"},
    "te_serve": _EDWARDS | {"mont_mul", "divstep_inv_mont", "mul_const"},
}
PATH_FORBIDDEN = {"projective": _UNSAFE | _SAFE | _EDWARDS, "affine_unsafe": _SAFE | _EDWARDS,
                  "affine_safe": _UNSAFE | _EDWARDS, "serve": _UNSAFE | _EDWARDS,
                  "te": _WEIERSTRASS - {"mont_mul", "divstep_inv_mont"},
                  "te_serve": _WEIERSTRASS - {"mont_mul", "divstep_inv_mont", "mul_const"}}
# the random-points phase: sqrt-trial generation of 2^GEN_LOG2N points a curve
_SOLVE = {"mul_const", "mont_mul", "divstep_inv_mont", "exp_ladder", "sqr_n", "sqrt_win"}
PATH_KERNELS["points"] = _SOLVE | {"proj_add_rcb", "proj_dbl_rcb"}
PATH_KERNELS["te_points"] = _SOLVE | {"ed_dbl"}
PATH_FORBIDDEN["points"] = _UNSAFE | _SAFE | _EDWARDS | {"glv_digits", "pack_glv", "mont_sqr",
                                                         "proj_combine_rcb"}
PATH_FORBIDDEN["te_points"] = (_WEIERSTRASS - _SOLVE) | {"ed_add", "ed_add_packed", "ed_combine"}
# the baselines' kernels: launched by inv_divstep, inv_mont_divstep and the
# micro-bench's altmul section, never by an MSM or generation path
_ALT = {"divstep_inv", "barrett_mul"}
for _path in PATH_FORBIDDEN:
    PATH_FORBIDDEN[_path] |= _PLANAR | _ALT
# the planar adds at 2^20 lanes: the batch inversion's kernels and their own
PATH_KERNELS["planar_safe"] = {"aff_pre", "aff_post", "mont_mul", "divstep_inv_mont"}
PATH_KERNELS["planar_unsafe"] = {"aff_pre_unsafe", "aff_post_unsafe", "mont_mul", "divstep_inv_mont"}
for _path in ("planar_safe", "planar_unsafe"):
    PATH_FORBIDDEN[_path] = (_WEIERSTRASS | _EDWARDS | _SOLVE | _PLANAR | _ALT) - PATH_KERNELS[_path]
# the micro phase: micro_bench.main (every section) and the two divstep
# inverses (the Fermat references run outside the counted run)
PATH_KERNELS["micro"] = {"mont_mul", "mont_sqr", "mul_const", "divstep_inv_mont", "divstep_inv",
                         "barrett_mul"}
PATH_FORBIDDEN["micro"] = (_WEIERSTRASS | _EDWARDS | _SOLVE | _PLANAR) - PATH_KERNELS["micro"]
PATH_KERNELS["alt"] = _ALT  # phase_alt_kernels: one of them a run
PATH_FORBIDDEN["alt"] = _WEIERSTRASS | _EDWARDS | _SOLVE | _PLANAR
ALT_LANES = (1 << 18, (1 << 18) + 17)  # the micro-bench's width, and a ragged edge
ALT_SAMPLE = 1024  # lanes of divstep_inv and barrett_mul checked against Python's ints
MICRO_LOG2N = 18
PLANAR_LANES = (*KERNEL_LANES, 1 << 20)  # the planar kernels' checks; timed at the last
PLANAR_SAMPLE = 1024  # lanes of the 2^20-lane planar adds checked against the oracle
GRID_W = 640  # tests/test_grid_combine.py's grid: wider than the 512-lane inversion stop
SHARD_D = (1, 2, 4, 8)  # logical shards on the one card
SHARD_ORACLE_N = 512
GEN_LOG2N = 20
GEN_SEED = 3
GEN_OVERSAMPLE = 2.5
GEN_SAMPLE_POINTS = 1024  # output lanes rebuilt with the bigint oracle
GEN_SAMPLE_CANDIDATES = 4096  # candidates whose success flag meets Euler's criterion
GEN_ORACLE_N = 512  # MSM on the generated points against the bigint oracle
SQRT_CHAINS = (1, 42, 43)  # sqr_n's m: the shortest chain, and the first of each curve
# the sqrt slice's widths: the kernels bit for bit at 1 lane and at
# KERNEL_LANES, sqrt_win and the whole sqrt also at the candidates of a 2^20
# generation (SQRT_SAMPLE sampled lanes against pow()); sqrt_win timed there
SQRT_LANES = (1, *KERNEL_LANES)
SQRT_WIDE = int(GEN_OVERSAMPLE * (1 << GEN_LOG2N)) + 16
SQRT_SAMPLE = 1024
# exp_ladder: its check widths below the path's (one lane, a ragged warp, a
# ragged 2^16), back-to-back calls a timing (about 40-70 ms each)
LADDER_LANES = (1, 17, (1 << 16) + 17)
LADDER_TURN_REPS = 3
# lanes of the path's width that exp_ladder at e = p - 2 is held on against
# its plain version (e = (q - 1) / 2 is held on every lane and timed there)
LADDER_SLICE = 1 << 16
TE_CURVE = "ed-on-bls12-377"
TE_LIMBS = 9  # every launch of the Twisted Edwards paths, and none of the others'
TE_COMBINE_K = 208  # ed_dbl's k on the halving combine's first level at 2^20: c 16 = 13 x 16
# the Edwards combine's (K, c) at 2^20 and 2^16, and the Twisted Edwards
# path's launches at 2^20 of the kernels the combine changed
TE_COMBINE_CASES = ((20, 13), (23, 11))
TE_PATH_LAUNCHES = {"ed_combine": 1, "ed_dbl": 1, "ed_add": 37}
# ed_add's and ed_dbl's bodies: checked at these widths (one lane, the
# window sums' launches at 2^20 from 20 to 40,960 lanes, the kernel table's
# 2^16 and the cofactor scale's 2^20), the doubling at k of ED_DBL_K (6: the
# window sums' k = log2 S)
ED_WIDTHS = (1, 20, 640, 1280, 5120, 20480, 40960, 1 << 16, 1 << 20)
ED_DBL_K = (1, 6)
# the redesigned kernels at the main paths' shapes: the combine's (K, c) at
# 2^20 and 2^16; window_sums' doublings at 2^20 (k = log2 S = 6 on K = 10
# lanes); fresh-input checks of the combine and the fused post (the widest
# post checked once)
COMBINE_CASES = ((10, 13), (12, 11))
FEW_DBL = (6, 10)
DBL_CHAIN = 600  # doublings on one lane, for the time of one
REDESIGN_REPS = 10
# proj_add_rcb's bodies: checked at the widths window_sums launches at 2^20
# (the tree levels and scans of 640 lanes and below, the row and column
# trees' 1,280 and 2,560) and at 1 lane; timed at one width each side of
# FEW_ADD_LANES (the threshold's sweep from 1 to 2^20 lanes is in PERF.md)
ADD_CHECK_LANES = (1, 10, 20, 40, 80, 160, 320, 640, 1280, 2560)
ADD_SWEEP_LANES = (20, 80)
ADD_SWEEP_REPS = 20  # launches of each body at each width, under the profiler
# glv_digits: (log2 N, c) of the main paths at 2^16 and 2^20; every c of
# the window table is checked at both
GLV_CASES = ((16, 11), (20, 13))
# the safegcd inverse: draws for the input that needs the most batches;
# divstep_inv's check widths (timed at the third, the micro-bench's);
# launches a device timing
DIVSTEP_DRAW = 1 << 16
DIVSTEP_INV_LANES = (ROOT_LANES, 1 << 16, 1 << 18, (1 << 18) + 17)
DIVSTEP_TIMING_REPS = 20
# proj_dbl_rcb's wide body: checked at these widths (3,072 above the
# few-lane threshold, 2^20 the cofactor stage's) and k (92 the cofactor stage's
# longest launch), against the plain version on every lane up to 2
# DBL_PLAIN_LANES lanes and on that many at each end beyond
DBL_CHECK_LANES = (1, 3072, (1 << 16) + 17, 1 << 20)
DBL_CHECK_K = (1, 5, 92)
DBL_PLAIN_LANES = 1024
# the main path's launches (affine-unsafe at 2^20) of the kernels this
# script's redesign phase holds to their new shapes
MAIN_PATH_LAUNCHES = {"proj_combine_rcb": 1, "proj_dbl_rcb": 1, "proj_add_rcb": 37, "mont_mul": 236,
                      "aff_post_packed_u": 12, "glv_digits": 1, "divstep_inv_mont": 12}


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "nvidia-smi unavailable"


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timed_once(fn):
    """(fn(), its device time in ms by CUDA events): one run timed, so that
    a slow plain version checked against its kernel is not run again to be
    timed."""
    import torch

    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def device_times(fn, trace: str | None = None) -> tuple[dict, float, float, dict, list]:
    """fn() under torch.profiler's CUDA activity, after one warm-up run
    under the profiler (its schedule's warm-up step: kernels launched right
    after a bare start can go unrecorded): ({kernel: (launches, device ms)}
    for this package's kernels, device ms of every kernel and copy, host ms
    of the recorded run, {trace key: (launches, device ms)} of PyTorch's own
    kernels and copies, and (kernel name, device ms) of each launch of the
    recorded run whose kernel name matches the regex `trace`, in launch
    order).
    Device times are self times, so no range counts its kernels twice; the
    kernels are `<name>_kernel` in the trace (`<name>_few_kernel` for a
    few-lane body)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from montgomery_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    traces, launches = [], []

    def ready(p):
        traces.append(p.key_averages())
        if trace:
            evs = [e for e in p.events() if e.device_type != DeviceType.CPU and re.search(trace, e.name)]
            launches[:] = [(e.name, e.time_range.elapsed_us() / 1e3)
                           for e in sorted(evs, key=lambda e: e.time_range.start)]

    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    per, others, busy = {}, {}, 0.0
    for e in traces[-1] if traces else ():
        if not e.self_device_time_total:
            continue
        busy += e.self_device_time_total / 1e3
        m = re.search(r"\b(\w+?)(?:_few)?_kernel\b", e.key)  # a few-lane body too
        name = m.group(1) if m and m.group(1) in kernels.REGISTRY else None
        into = per if name else others
        c, t = into.get(name or e.key, (0, 0.0))
        into[name or e.key] = (c + e.count, t + e.self_device_time_total / 1e3)
    return per, busy, wall * 1e3, others, launches


def device_times_whole(fn, whole, trace: str | None = None, tries: int = 3):
    """`device_times` again, up to `tries` runs, until whole(result) holds:
    the profiler now and then drops a run's kernel events (a run whose
    glv_digits launches all went unrecorded, one that kept 18 of 20 of a
    kernel's). Returns the last result."""
    for _ in range(tries):
        res = device_times(fn, trace)
        if whole(res):
            break
        say("  (the profiler dropped kernel events of this run; profiling it again)")
    return res


def say_device_times(label: str, per: dict, busy: float, wall: float, others: dict) -> None:
    if not busy:
        say(f"{label}: the profiler saw no device time (not measured)")
        return
    say(f"{label}: device busy {busy:.3f} ms of {wall:.3f} ms host ({busy / wall:.3f}); the "
        f"package's kernels {sum(t for _, t in per.values()):.3f} ms:")
    for name, (count, t) in sorted(per.items(), key=lambda kv: -kv[1][1]):
        say(f"  {name}: {count} launches, {t:.4f} ms, {t / count * 1e3:.2f} us a launch")
    say(f"  PyTorch's own kernels and copies: {sum(c for c, _ in others.values())} launches, "
        f"{sum(t for _, t in others.values()):.3f} ms; the largest:")
    for key, (count, t) in sorted(others.items(), key=lambda kv: -kv[1][1])[:8]:
        say(f"    {key[:90]}: {count} launches, {t:.4f} ms")


# ----------------------------------------------------------------- phase 0


def start_probe_build(src: Path):
    """Start nvcc on a probe (a multiply-rate or latency microbenchmark),
    which is built apart from the kernels' library; returns (process or
    None if built, path)."""
    from montgomery_tpu_torch.ops import kernels

    text = b"".join(p.read_bytes() for p in (src, *sorted(kernels.CSRC.glob("*.cuh"))))
    key = hashlib.sha256(text).hexdigest()[:16]
    out = ROOT / "build" / "rates" / key
    lib = out / f"lib{src.stem}.so"
    if lib.exists():
        return None, lib
    out.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I",
           str(kernels.CSRC), "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def multiply_rates(lib_path: Path, clock_hz: float) -> dict:
    """Multiplies per second of mad.wide.u32 and mad.lo.u32 on the card,
    each timed over 10 launches that fill every SM; prints each per SM per
    clock at the maximum SM clock and the SASS opcodes they compiled to."""
    import torch

    from montgomery_tpu_torch.ops import kernels

    lib = ctypes.CDLL(str(lib_path))
    fn = lib.imad_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chains, threads = lib.imad_rate_chains(), lib.imad_rate_threads()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 8192
    out = torch.empty(blocks * threads, dtype=torch.int64, device="cuda")
    rates = {}
    for key, wide in (("wide", 1), ("lo", 0)):
        def launch():
            rc = fn(wide, blocks, iters, ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"imad_rate launch failed, CUDA error {rc}")

        ms = cuda_time_ms(launch, 10)
        rates[key] = blocks * threads * chains * iters / (ms * 1e-3)
        say(f"multiply rate {key}: {rates[key]:.4e} /s, {rates[key] / (sms * clock_hz):.2f} per SM "
            f"per clock at the max clock ({ms:.3f} ms a launch, {sms} SMs)")
    for name, ops in sass_histograms(lib_path).items():
        say(f"  sass {name}: {ops}")
    return rates


def sass_histograms(lib_path: Path, only: str = ".", names: list | None = None) -> dict:
    """{function: {SASS opcode: count}, most frequent first} of the
    functions of a built library whose mangled name matches the regex
    `only` (cuobjdump -sass; only the functions `names` where given and
    cuobjdump takes them, else all); {} where cuobjdump is missing."""
    from montgomery_tpu_torch.ops import kernels

    cmd = [str(Path(kernels._nvcc()).parent / "cuobjdump"), "-sass", str(lib_path)]
    dump = subprocess.run(cmd[:2] + ["-fun", ",".join(names)] + cmd[2:] if names else cmd,
                          capture_output=True, text=True)
    if names and (dump.returncode or "Function : " not in dump.stdout):
        dump = subprocess.run(cmd, capture_output=True, text=True)
    if dump.returncode:
        say("  cuobjdump unavailable:", dump.stderr.strip()[-200:])
    out = {}
    for sec in dump.stdout.split("Function : ")[1:]:
        name = sec.split()[0]
        if not re.search(only, name):
            continue
        ops: dict[str, int] = {}
        for op in re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sec):
            ops[op] = ops.get(op, 0) + 1
        out[name] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return out


def say_sass_mix(label: str, ops: dict) -> None:
    """A histogram with its 32x32 multiplies (IMAD.WIDE*, IMAD.HI*, IMAD
    and IMAD.U32, on either datapath; not the IMAD forms that only add or
    move) counted apart from the rest."""
    mul = sum(c for op, c in ops.items()
              if op.lstrip("U").startswith(("IMAD.WIDE", "IMAD.HI")) or op.lstrip("U") in ("IMAD", "IMAD.U32"))
    rest = sum(ops.values()) - mul
    say(f"  sass {label}: {mul} multiplies, {rest} other ({rest / max(mul, 1):.3f} a multiply): {ops}")


def phase_env() -> dict:
    """Returns the measured multiply rates."""
    import torch

    from montgomery_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    say("== phase 0: environment")
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    nv = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True)
    say("nvcc:", nv.stdout.strip().splitlines()[-1] if nv.stdout else nv.stderr.strip())
    try:
        import triton  # noqa: F401

        say(f"triton importable ({triton.__version__})")
    except ImportError:
        say("triton not importable")
    say("card:", smi_line())
    clock = max_sm_clock_hz()
    say(f"max SM clock: {clock / 1e6:.0f} MHz")
    probes = {src: start_probe_build(src) for src in (RATE_SRC, LATENCY_SRC, DIVSTEP_LATENCY_SRC)}
    kernels.LIBRARY.get()
    say(f"kernel build: {kernels.LIBRARY.build_seconds:.1f} s -> {kernels.LIBRARY.path}")
    jobs = re.findall(r"^== (.+) \(ended ([\d.]+) s, ran ([\d.]+) s\)$", kernels.LIBRARY.build_log, re.M)
    say(f"  {len(jobs)} nvcc processes (end, run time s), the last first: "
        + ", ".join(f"{name} {end}, {ran}" for name, end, ran in sorted(jobs, key=lambda j: -float(j[1]))))
    funcs = ptxas_functions(kernels.LIBRARY.build_log)
    say("ptxas, each kernel function (registers, stack frame, spill stores, spill loads, shared memory "
        "bytes):")
    for (name, nl), v in sorted(ptxas_by_limbs(kernels.LIBRARY.build_log).items()):
        say(f"  {name} n={nl}: {v}")
    glv = {k: v[1:4] for k, v in funcs.items() if "glv_digits_kernel" in k}
    say(f"glv_digits instantiations (stack frame, spill stores, spill loads in bytes): {glv}")
    if len(glv) != 3 or any(any(v) for v in glv.values()):
        raise AssertionError("each of glv_digits' three instantiations must have no stack frame and no spill")
    for src, (proc, _) in probes.items():
        if proc is not None:
            log, _ = proc.communicate()
            name = src.name
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas ({name}):", line.strip())
    say(f"[{time.perf_counter() - t0:.1f} s] probes built")
    redesigned_ptxas(ptxas_by_limbs(kernels.LIBRARY.build_log))
    redesigned_sass(probes)
    say(f"[{time.perf_counter() - t0:.1f} s] SASS read")
    rates = multiply_rates(probes[RATE_SRC][1], clock)
    rates.update(product_latency(probes[LATENCY_SRC][1]))
    rates.update(square_rates(probes[LATENCY_SRC][1]))
    rates.update(divstep_latency(probes[DIVSTEP_LATENCY_SRC][1]))
    return rates


def redesigned_ptxas(new: dict) -> None:
    """ptxas (registers, stack frame, spill stores, spill loads, shared
    memory bytes) of the bodies redesigned on the carry-chain product. The
    CIOS bodies they replaced are no longer built: PERF.md keeps their
    numbers."""
    say("ptxas of the redesigned bodies (registers, stack, spill stores, spill loads, smem)")
    for name, nl in (("proj_dbl_rcb", 12), ("proj_dbl_rcb", 13), ("proj_dbl_rcb", 9), ("ed_add_packed", 9),
                     ("exp_ladder", 12), ("exp_ladder", 13), ("exp_ladder", 9), ("aff_post_packed_u", 12),
                     ("aff_post_packed_u", 13), ("aff_post_packed_u", 9), ("aff_post_unsafe", 12),
                     ("aff_post_unsafe", 13), ("aff_post_unsafe", 9)):
        say(f"  {name} n={nl}: {new.get((name, nl))}")
    for name in ("ed_add", "ed_dbl"):
        say(f"  {name} n=9: wide {new.get((name, 9))}, narrow {new.get((name + '_few', 9))}")


def redesigned_sass(probes: dict) -> None:
    """The SASS mix of one product, fe_mul against fe_mul_cc (the one-thread
    chains of csrc/rates/mul_latency.cu, whose loop body is one product),
    and of the redesigned bodies, from the built libraries."""
    from montgomery_tpu_torch.ops import kernels

    chains = sass_histograms(probes[LATENCY_SRC][1], r"one_thread_chain|cc_chain|sqr_chain")
    squares = ("fe_sqr", "fe_sqr_cc", "fe_mul_cc(a, a)")
    for name, ops in sorted(chains.items()):
        m = re.search(r"sqr_chainILi\d+ELi(\d)E", name)
        label = squares[int(m.group(1))] if m else "fe_mul_cc" if "cc_chain" in name else "fe_mul"
        say_sass_mix(f"{label} chain {name}", ops)
    only = r"proj_dbl_rcb_kernel|ed_add_packed_kernel|aff_post_packed_u_kernelILi12|aff_post_unsafe_kernelILi12"
    names = [f for f in ptxas_functions(kernels.LIBRARY.build_log) if re.search(only, f)]
    for name, ops in sorted(sass_histograms(kernels.LIBRARY.path, only, names).items()):
        say_sass_mix(f"new {name}", ops)


def ptxas_functions(log: str) -> dict:
    """{kernel function (mangled): (registers, stack frame, spill stores,
    spill loads, shared memory bytes)} from ptxas -v output."""
    out, name, frame = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and frame is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = (int(m.group(1)), *frame, int(smem.group(1)) if smem else 0)
            name = None
    return out


def ptxas_by_limbs(log: str) -> dict:
    """`ptxas_functions` of every kernel template instantiated over the limb
    count NL, as {(kernel, NL): ...} (a few-lane body is "<kernel>_few")."""
    out = {}
    for name, v in ptxas_functions(log).items():
        m = re.match(r"_Z\d+(\w+?)_kernelILi(\d+)E", name)
        if m:
            out[m.group(1), int(m.group(2))] = v
    return out


def product_latency(lib_path: Path) -> dict:
    """Latency (s) of one dependent Montgomery product on the card: a chain
    of products in one thread (fe_mul), on one warp (coop_mul) and in one
    thread on carry chains (fe_mul_cc), each one launch of a single block,
    at BLS12-377's 12 limbs ("lat_thread", "lat_warp", "lat_cc"),
    BLS12-381's 13 ("_n13") and ed-on-bls12-377's 9 ("_n9"); the chains'
    last products must agree bit for bit."""
    import torch

    from montgomery_tpu_torch.concrete import BLS12_377, BLS12_381, ED_ON_BLS12_377
    from montgomery_tpu_torch.ops import kernels
    from montgomery_tpu_torch.ops.field import create_field_ops
    from montgomery_tpu_torch.ops.limbs import to_words

    lib = ctypes.CDLL(str(lib_path))
    fn = lib.mul_latency
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_uint32)] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lat = {}
    for p, tag in ((BLS12_377.modulus, ""), (BLS12_381.modulus, "_n13"), (ED_ON_BLS12_377.modulus, "_n9")):
        f = create_field_ops(p)
        x, y = (kernels.words(to_words(v * f.R % f.p, f.n)) for v in (3, 5))
        mu = kernels.words(to_words(-pow(f.p, -1, f.R) % f.R, f.n))
        field = kernels.words(to_words(f.p, f.n) + to_words(2 * f.p, f.n) + to_words(4 * f.p, f.n) + [f.mu])
        outs = {w: torch.empty(f.n, dtype=torch.int32, device="cuda") for w in (0, 1, 2)}

        def launch(warp, iters, f=f, x=x, y=y, mu=mu, field=field, outs=outs):
            rc = fn(f.n, warp, iters, x, y, mu, field, ctypes.c_void_p(outs[warp].data_ptr()),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"mul_latency launch failed, CUDA error {rc}")

        for warp, key, iters in ((0, "lat_thread", 500), (1, "lat_warp", 4000), (2, "lat_cc", 500)):
            lat[key + tag] = cuda_time_ms(lambda: launch(warp, iters), 5) * 1e-3 / iters
        for warp in (0, 1, 2):
            launch(warp, 333)
        if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])):
            raise AssertionError(f"the product chains differ at {f.n} limbs")
        say(f"dependent product latency at {f.n} limbs: one thread {lat['lat_thread' + tag] * 1e6:.3f} us "
            f"(carry chains {lat['lat_cc' + tag] * 1e6:.3f} us), one warp {lat['lat_warp' + tag] * 1e6:.3f} us "
            f"(chains of 500, 500 and 4000 products; equal bit for bit)")
    return lat


SQUARES = ("fe_sqr", "fe_sqr_cc", "fe_mul_cc(a, a)")  # csrc/rates/mul_latency.cu sqr_rate's `which`


def square_rates(lib_path: Path) -> dict:
    """One square's latency (s, a chain of 2,000 dependent squares in one
    thread) and the squares' throughput (squares/s, 100 dependent squares in
    each of 1,024 threads a SM) in the three forms of
    csrc/rates/mul_latency.cu (field.cuh's CIOS-row fe_sqr, madc.cuh's
    fe_sqr_cc, fe_mul_cc(a, a)) at 12, 13 and 9 limbs; the three chains'
    last squares must agree bit for bit. Keys "sqr_lat_<i>" and
    "sqr_rate_<i>" with the limb tag, i the form's index in SQUARES."""
    import torch

    from montgomery_tpu_torch.concrete import BLS12_377, BLS12_381, ED_ON_BLS12_377
    from montgomery_tpu_torch.ops import kernels
    from montgomery_tpu_torch.ops.field import create_field_ops
    from montgomery_tpu_torch.ops.limbs import to_words

    fn = ctypes.CDLL(str(lib_path)).sqr_rate
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_uint32)] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    threads = 1024 * torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for p, tag in ((BLS12_377.modulus, ""), (BLS12_381.modulus, "_n13"), (ED_ON_BLS12_377.modulus, "_n9")):
        f = create_field_ops(p)
        x = kernels.words(to_words(3 * f.R % p, f.n))
        field = kernels.words(to_words(p, f.n) + to_words(2 * p, f.n) + to_words(4 * p, f.n) + [f.mu])
        buf = torch.empty(threads * f.n, dtype=torch.int32, device="cuda")

        def launch(which, nthreads, iters, f=f, x=x, field=field, buf=buf):
            rc = fn(f.n, which, nthreads, iters, x, field, ctypes.c_void_p(buf.data_ptr()),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"sqr_rate launch failed, CUDA error {rc}")

        ends = []
        for which in range(len(SQUARES)):
            out[f"sqr_lat_{which}{tag}"] = cuda_time_ms(lambda: launch(which, 1, 2000), 3) * 1e-3 / 2000
            out[f"sqr_rate_{which}{tag}"] = threads * 100 / (cuda_time_ms(lambda: launch(which, threads, 100), 3)
                                                             * 1e-3)
            launch(which, 4096, 333)
            ends.append(buf[:4096 * f.n].clone())
        if not all(torch.equal(ends[0], e) for e in ends[1:]):
            raise AssertionError(f"the square chains differ at {f.n} limbs")
        say(f"square at {f.n} limbs (a dependent chain of 2,000 in one thread; throughput over {threads} threads, "
            f"100 each; equal bit for bit): " + "; ".join(
                f"{name} {out[f'sqr_lat_{i}{tag}'] * 1e6:.4f} us, {out[f'sqr_rate_{i}{tag}']:.4e} /s"
                for i, name in enumerate(SQUARES)))
    return out


def divstep_latency(lib_path: Path) -> dict:
    """Latency (s) of the safegcd core's steps on the card at BLS12-377
    (`csrc/rates/divstep_latency.cu`): one batch of 30 divsteps (constant
    and variable time) and one matrix application (f, g, d, e), each in one
    thread, and one whole batch on a warp with its exit vote as
    divstep_inv_mont runs it; each a chain of dependent steps in one launch
    of a single warp."""
    import torch

    from montgomery_tpu_torch.concrete import BLS12_377
    from montgomery_tpu_torch.ops import kernels
    from montgomery_tpu_torch.ops.field import create_field_ops
    from montgomery_tpu_torch.ops.limbs import to_words

    f = create_field_ops(BLS12_377.modulus)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.divstep_latency
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = kernels.words(to_words(pow(3, 1000, f.p), f.n))
    out = torch.empty(32, dtype=torch.int32, device="cuda")
    lat = {}
    for which, key, iters in ((0, "lat_divsteps", 4000), (3, "lat_divsteps_var", 4000),
                              (1, "lat_apply_thread", 1000), (2, "lat_batch_warp", 4000)):
        def launch(which=which, iters=iters):
            rc = fn(which, iters, g, f.inv_params.kernel_words, ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"divstep_latency launch failed, CUDA error {rc}")

        lat[key] = cuda_time_ms(launch, 5) * 1e-3 / iters
    ends = []
    for which in (0, 3):
        if fn(which, 333, g, f.inv_params.kernel_words, ctypes.c_void_p(out.data_ptr()),
              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)):
            raise RuntimeError("divstep_latency launch failed")
        ends.append(out[:3].clone())
    if not torch.equal(*ends):
        raise AssertionError("the variable-time divsteps differ from the constant-time ones")
    say(f"safegcd core latency (BLS12-377, 13 limbs): 30 divsteps {lat['lat_divsteps'] * 1e6:.4f} us "
        f"(variable time {lat['lat_divsteps_var'] * 1e6:.4f} us), one matrix application in one thread "
        f"{lat['lat_apply_thread'] * 1e6:.4f} us, one batch on a warp with its exit vote "
        f"{lat['lat_batch_warp'] * 1e6:.4f} us (chains of 4000, 4000, 1000 and 4000; the two divstep "
        f"chains end equal)")
    return lat


# ------------------------------------------------------- bounds per kernel


def kernel_work(ctx, name: str, batches: float | None = None, k: int = 1) -> tuple[int, int, int]:
    """(bytes, wide multiplies, low multiplies) per lane of one call: each
    input read once, each output written once; the multiplies the formula
    needs. A wide multiply is one 32x32->64 product (a product of two
    factors below 2^32 in magnitude); one n-word CIOS Montgomery product
    needs 2 n^2 of them and n low 32-bit products (the quotient digits).
    The divstep kernels' loop ends once g = 0: `batches` is the mean over
    the call's lanes of the batches its inputs need (`divstep_batches`).
    proj_dbl_rcb and ed_dbl run k doublings on the point they read and
    write once."""
    from montgomery_tpu_torch.ops import divstep

    n = ctx.fops.n
    W = 4 * n

    def products(k):
        return k * 2 * n * n, k * n

    # a square shares its cross terms: n (n + 1) / 2 products, then the
    # n-row reduction; a packed column is 2n + 1 words
    sqr = (n * (n + 1) // 2 + n * n, n)
    col = 2 * W + 4

    # per scalar, at c = 13 (the timed call); a product of two 13-bit limbs
    # is one low 32-bit multiply
    if name == "glv_digits":
        gd = ctx.glv_dev
        ng = len(gd.g1_limbs)
        msb = sum(1 for a in range(gd.ns) for j in range(ng) if gd.k0 <= a + j < gd.khi)
        res = sum(1 for q in (*gd.coef0, *gd.coef1) if q
                  for a in range(gd.nu) for j in range(-(-abs(q).bit_length() // gd.w))
                  if a + j < gd.nw)
        return 4 * gd.ns + 8 * gd.num_windows(13), 0, 2 * msb + res
    # per batch of divsteps: 10 products a 30-bit limb, each of two int32
    # factors, so one wide multiply each, and the 2 low products of the
    # quotient digits md, me; the 30 serial divsteps' ALU work is left out
    # of the bound (the dependent-chain floor of the redesign phase holds it)
    if name in ("divstep_inv_mont", "divstep_inv") and batches is None:
        raise ValueError(f"{name}'s work depends on its inputs: pass the batches they need")
    dsb, wide_b, lo_b = batches or 0, 10 * divstep.kernel_limbs(n), 2
    wide, lo = products(2)
    return {
        "mul_const": (2 * W, *products(1)),
        "mont_mul": (3 * W, *products(1)),
        "proj_add_rcb": (9 * W, *products(14)),
        # a doubling: 7 products (3b Z^2 among them: 3b is a whole field
        # element in Montgomery form, and the result's representative is the
        # product's) and the 2 squares Y^2, Z^2
        "proj_dbl_rcb": (6 * W, k * (products(7)[0] + 2 * sqr[0]), k * 9 * n),
        "divstep_inv_mont": (2 * W, wide + dsb * wide_b, lo + dsb * lo_b),
        "pack_glv": (2 * W + 1 + 2 * (2 * W + 4), *products(1)),  # per point: 2 packed columns out
        "aff_pre_packed_u": (2 * W + 4 + W, 0, 0),
        # fused with the last descent level: A (x, y, inf), B (x, y), two
        # signs, hp, half a parent inverse and the partner's denominator in,
        # one packed column out; the lane's inverse is one more product
        "aff_post_packed_u": (2 * W + 4 + 2 * W + 12 + W // 2 + W + 2 * W + 4,
                              products(3)[0] + sqr[0], products(3)[1] + sqr[1]),
        "mont_sqr": (2 * W, *sqr),
        # in: A, B, two signs, hp; out: denom, numer, flags
        "aff_pre_packed": (2 * col + 12 + 2 * W + 4, *sqr),
        # in: A, B, two signs, dinv, numer, flags, hp; out: one packed column
        "aff_post_packed": (2 * col + 8 + 2 * W + 8 + col, wide + sqr[0], lo + sqr[1]),
        # Twisted Edwards (8 products and 1 by k = 2d per add): 8 points
        # moved by the add, 2 by k = 1 doublings, and for the packed add two
        # packed columns, two signs and hp in, one column out
        "ed_add": (12 * W, *products(9)),
        "ed_dbl": (8 * W, *products(9 * k)),
        "ed_add_packed": (2 * 4 * W + 12 + 4 * W, *products(9)),
        # the planar adds: x1, y1, x2, y2 and two bool infinity bytes in;
        # pre: denom, numer, flags out; post: dinv, numer, flags in too, x3,
        # y3 and a bool out; the unsafe pre (timed with its validity byte):
        # two x in, denom out; the unsafe post: five planes in, two out
        "aff_pre": (4 * W + 2 + 2 * W + 4, *sqr),
        "aff_post": (6 * W + 4 + 2 + 2 * W + 1, wide + sqr[0], lo + sqr[1]),
        "aff_pre_unsafe": (2 * W + 1 + W, 0, 0),
        "aff_post_unsafe": (5 * W + 2 * W, wide + sqr[0], lo + sqr[1]),
        # the baselines: the divsteps alone; the schoolbook x y, the whole
        # q1 mu and the low words of q p
        "divstep_inv": (2 * W, dsb * wide_b, dsb * lo_b),
        "barrett_mul": (3 * W, 2 * n * n + n * (n + 1) // 2, 0),
    }[name]


def bound(ctx, name: str, lanes: int, rates: dict, batches: float | None = None,
          k: int = 1) -> tuple[float, str]:
    """Least time (ms) for `lanes` lanes: bytes over the memory rate, or
    the multiplies over the card's measured multiply rates, whichever is
    larger (`batches`, k: as in `kernel_work`)."""
    return bound_of(*kernel_work(ctx, name, batches, k), lanes, rates)


def divstep_batches(f, x, mont: bool = True) -> tuple[float, int]:
    """(mean, most) batches the lanes of (n, M) planes x need before g = 0
    in divstep_inv_mont (x Montgomery forms in [0, 2p)) or divstep_inv
    (mont=False: canonical values), from the plain version on x's device."""
    from montgomery_tpu_torch.ops import divstep

    t = f.reduce(f.mul_const_plain(x, 1)) if mont else x
    b = divstep.batches_needed(f.inv_params, t)
    return float(b.double().mean()), int(b.max())


def bound_of(nbytes: float, wide: float, lo: float, lanes: int, rates: dict) -> tuple[float, str]:
    """As `bound`, from the work of one lane."""
    t_bytes = nbytes * lanes / HBM_BYTES_PER_S
    t_ops = (wide / rates["wide"] + lo / rates["lo"]) * lanes
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def first_level_width(ctx, log2n: int) -> int:
    """Lanes of the first add level of a packed path's super-round at
    N = 2^log2n (window_size c): 4 (M0 / 8 + G + 2), G = K 2^(c-1), with
    M0 = K 2N on the GLV-expanded affine path and K N on the Edwards one."""
    N = 1 << log2n
    c = ctx.default_c(N)
    if hasattr(ctx, "glv_dev"):
        K = ctx.glv_dev.num_windows(c)
        M0 = K * 2 * N
    else:
        K = ctx.num_windows(c)
        M0 = K * N
    return 4 * (M0 // 8 + K * (1 << (c - 1)) + 2)


# ----------------------------------------------------------------- phase 1


def _canon(f, t):
    """Canonical values (reduced mod p) of int32 planes, as int64 words."""
    import torch

    return f.reduce(t).to(torch.int64) & 0xFFFFFFFF


def _field_inputs(f, N: int, rng: random.Random) -> list[int]:
    p = f.p
    adv = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p, f.R2]
    return adv + [rng.randrange(2 * p) for _ in range(N - len(adv))]


def _point_inputs(ctx, pts, N: int, rng: random.Random):
    """Two projective batches (P, Q) in Montgomery form with random Z and
    adversarial lanes: P == Q, P == -Q, zero operands, unreduced [p, 2p)."""
    f = ctx.fops
    p, R = f.p, f.R
    cols = ([], [], []), ([], [], [])
    for i in range(N):
        a, b = pts[i % len(pts)], pts[(7 * i + 3) % len(pts)]
        k = i % 512
        if k < 64:
            b = a
        for side, pt in enumerate((a, b)):
            z = rng.randrange(1, p)
            X, Y, Z = pt.x * z % p, pt.y * z % p, z
            if side == 1 and 64 <= k < 128:
                Y = (-Y) % p  # Q = -P
            if (side == 0 and 128 <= k < 192) or (side == 1 and 192 <= k < 256) or 256 <= k < 288:
                X, Y, Z = 0, 1, 0  # point at infinity
            vals = [v * R % p for v in (X, Y, Z)]
            if 288 <= k < 400:  # unreduced representatives in [p, 2p)
                vals = [v + p for v in vals]
            for c in range(3):
                cols[side][c].append(vals[c])
    from montgomery_tpu_torch.curves.projective import ProjectiveBatch

    dev = ctx.device
    return [ProjectiveBatch(*[f.pack_raw(c, dev) for c in side]) for side in cols]


def _scalar_inputs(q: int, N: int, rng: random.Random) -> list[int]:
    adv = [0, 1, 2, q - 1, q - 2, (q - 1) // 2] + [(1 << k) % q for k in (63, 127, 128, 200, 252)]
    return adv + [rng.randrange(q) for _ in range(N - len(adv))]


def phase_kernels(ctx, pts, rates: dict):
    import torch

    from montgomery_tpu_torch.scalar.device import digits_glv_plain

    say("== phase 1: kernels against their plain versions")
    f, proj = ctx.fops, ctx.proj
    rng = random.Random(1)
    results = {}

    def record(name, err, ms=None, plain_ms=None, lanes=KERNEL_LANES[0], **extra):
        r = results.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r.update(ms=ms, plain_ms=plain_ms, lanes=lanes, **extra)

    def diff(a, b):
        return int((a - b).abs().max()) if a.numel() else 0

    for N in KERNEL_LANES:
        timed = N == KERNEL_LANES[0]
        # kernel 1: mul_const by beta, R^2, 1 and 3b
        x = f.pack_raw(_field_inputs(f, N, rng), ctx.device)
        for name, cst in (("beta", proj.beta_mont), ("R^2", f.R2), ("1", 1), ("3b", proj.b3_mont)):
            k_out = _canon(f, f.mul_const(x, cst))
            p_out = _canon(f, f.mul_const_plain(x, cst))
            err = diff(k_out, p_out)
            say(f"mul_const[{name}] N={N}: max_abs_err {err}")
            if err:
                raise AssertionError(f"mul_const[{name}] disagrees with its plain version")
        ms = cuda_time_ms(lambda: f.mul_const(x, proj.beta_mont), KERNEL_REPS) if timed else None
        pms = cuda_time_ms(lambda: f.mul_const_plain(x, proj.beta_mont), 5, 1) if timed else None
        record("mul_const", 0, ms, pms)

        # kernel 2: RCB add
        P, Q = _point_inputs(ctx, pts, N, rng)
        k_out = proj.add(P, Q)
        p_out = proj.add_plain(P, Q)
        err = max(diff(_canon(f, a), _canon(f, b)) for a, b in zip(k_out, p_out))
        say(f"proj_add_rcb N={N}: max_abs_err {err}")
        if err:
            raise AssertionError("proj_add_rcb disagrees with its plain version")
        ms = cuda_time_ms(lambda: proj.add(P, Q), KERNEL_REPS) if timed else None
        pms = cuda_time_ms(lambda: proj.add_plain(P, Q), 3, 1) if timed else None
        record("proj_add_rcb", err, ms, pms)

        # kernel 3: k doublings, k = 1 (double) and k = 13 (a combine level)
        for k in (1, 13):
            k_out = proj.double_n(P, k)
            p_out = proj.double_n_plain(P, k)
            err = max(diff(_canon(f, a), _canon(f, b)) for a, b in zip(k_out, p_out))
            say(f"proj_dbl_rcb k={k} N={N}: max_abs_err {err}")
            if err:
                raise AssertionError(f"proj_dbl_rcb k={k} disagrees with its plain version")
            record("proj_dbl_rcb", err)
        if timed:
            record("proj_dbl_rcb", 0, cuda_time_ms(lambda: proj.double_n(P, 1), KERNEL_REPS),
                   cuda_time_ms(lambda: proj.double_n_plain(P, 1), 3, 1))

        # kernel 4: GLV digits at the main path's window sizes
        sl = ctx.scalars_to_limbs(_scalar_inputs(ctx.params.order, N, rng))
        for c in (11, 13):
            k_out = ctx.digits_device(sl, c)
            p_out = digits_glv_plain(ctx.glv_dev, sl, c)
            err = diff(k_out.to(torch.int64), p_out.to(torch.int64))
            say(f"glv_digits c={c} N={N}: shape {tuple(k_out.shape)} max_abs_err {err}")
            if err or k_out.shape != p_out.shape:
                raise AssertionError(f"glv_digits c={c} disagrees with its plain version")
            record("glv_digits", err)
        if timed:
            record("glv_digits", 0, cuda_time_ms(lambda: ctx.digits_device(sl, 13), KERNEL_REPS),
                   cuda_time_ms(lambda: digits_glv_plain(ctx.glv_dev, sl, 13), 3, 1))

    affine_kernels(ctx, pts, record, diff)
    torch.cuda.empty_cache()
    planar_kernels(ctx, pts, record, diff)
    torch.cuda.empty_cache()
    for name, r in results.items():
        r["bound_ms"], r["bound_by"] = bound(ctx, name, r["lanes"], rates, r.get("batches"))
        say(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) per call at {r['lanes']} lanes")
    return results


def _packed_err(f, a, b, diff) -> int:
    """Largest difference of canonical x and y rows and of the inf row."""
    n = f.n
    return max(diff(_canon(f, a[:n]), _canon(f, b[:n])),
               diff(_canon(f, a[n:2 * n]), _canon(f, b[n:2 * n])),
               diff(a[2 * n:].long(), b[2 * n:].long()))


def _random_planes(f, rows: int, M: int, gen):
    """Random int32 rows on the card, each n-row field block below
    2^bits(p) (< 2p): word k of a field element keeps bits(p) - 32 k bits
    (25 of the top word at BLS12-377's 12 limbs; 29 of word 7 and none of
    word 8 at ed-on-bls12-377's 9)."""
    import torch

    t = torch.randint(-(1 << 31), 1 << 31, (rows, M), dtype=torch.int32, device=gen.device,
                      generator=gen)
    bits = f.p.bit_length()
    for r in range(rows):
        keep = bits - 32 * (r % f.n)
        if keep < 32:
            t[r] &= (1 << max(keep, 0)) - 1
    return t


def _field_plane(f, M: int, gen, adv: list[int]):
    """(n, M) field values on the card: `adv` in the first lanes, then
    random values below 2^377."""
    t = _random_planes(f, f.n, M, gen)
    k = min(len(adv), M)
    t[:, :k] = f.pack_raw(adv[:k], gen.device)
    return t


# flag classes of the safe packed add, cycled over the first lanes of its
# kernels' inputs; T = (p - 1, 0) is the point of order 2 (y = 0), and an
# "unreduced" lane's B holds the representative v + p of A's value v
FLAG_CLASSES = ("ordinary", "double", "cancel", "inf_a", "inf_b", "inf_both", "unpaired",
                "t_double", "t_minus_t", "unpaired_same", "double_unreduced", "cancel_unreduced")


def _flag_lanes(ctx, pts, K: int):
    """K packed columns A and B (Montgomery form) and their sign and pair
    planes on the card, lane i of class FLAG_CLASSES[i % 12], A's sign
    alternating between the cycles."""
    import torch

    f = ctx.fops
    p, R = f.p, f.R
    xa, ya, ia, xb, yb, ib, sa, sb, hp = ([] for _ in range(9))
    for i in range(K):
        cls = FLAG_CLASSES[i % len(FLAG_CLASSES)]
        a, b = pts[i % len(pts)], pts[(7 * i + 3) % len(pts)]
        (ax, ay), (bx, by) = (a.x, a.y), (b.x, b.y)
        s1 = (i // len(FLAG_CLASSES)) % 2
        s2 = 1 - s1
        if cls in ("double", "unpaired_same", "double_unreduced"):
            bx, by, s2 = ax, ay, s1
        elif cls in ("cancel", "cancel_unreduced"):
            bx, by = ax, ay
        elif cls in ("t_double", "t_minus_t"):
            ax, ay = bx, by = p - 1, 0
            s2 = s1 if cls == "t_double" else s2
        up = p if cls.endswith("unreduced") else 0
        xa.append(ax * R % p)
        ya.append(ay * R % p)
        xb.append(bx * R % p + up)
        yb.append(by * R % p + up)
        ia.append(int(cls in ("inf_a", "inf_both")))
        ib.append(int(cls in ("inf_b", "inf_both")))
        sa.append(s1)
        sb.append(s2)
        hp.append(0 if cls.startswith("unpaired") else 1)
    dev = ctx.device

    def rows(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    A = torch.cat([f.pack_raw(xa, dev), f.pack_raw(ya, dev), rows(ia)])
    B = torch.cat([f.pack_raw(xb, dev), f.pack_raw(yb, dev), rows(ib)])
    return A, B, rows(sa), rows(sb), rows(hp)


def affine_kernels(ctx, pts, record, diff):
    """Kernels 5-12 of the batched-affine paths against their plain versions
    on the same tensors, with adversarial field values in the first lanes
    (and, for the packed adds, the flag classes of `_flag_lanes` on oracle
    points `pts`): at 2^16 and 2^16 + 17 lanes, and at the widths the main
    path gives them (the first super-round level at 2^16 and 2^20 points and
    its halves for mont_mul and both packed adds; 2^20 points for pack_glv;
    2^20 lanes for mont_sqr; the 512-lane root for divstep_inv_mont). The
    operands are column slices of wider planes, as the engine passes them.
    Each kernel is then timed on the tensors it was checked on, at the 2^16
    path's width (pack_glv at 2^16 points, mont_sqr at 2^20 lanes)."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch
    from montgomery_tpu_torch.ops import divstep

    f, aff, dev = ctx.fops, ctx.affine, ctx.device
    gen = torch.Generator(device=dev).manual_seed(3)
    p = f.p
    adv = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p, f.R2]
    level = {"mont_mul", "aff_pre_packed_u", "aff_post_packed_u", "aff_pre_packed",
             "aff_post_packed"}
    every = level | {"divstep_inv_mont", "pack_glv", "mont_sqr"}
    W16, W20 = first_level_width(ctx, 16), first_level_width(ctx, 20)
    plan = ((KERNEL_LANES[0], every, {"pack_glv"}), (KERNEL_LANES[1], every, set()),
            (ROOT_LANES, {"divstep_inv_mont"}, {"divstep_inv_mont"}),
            (1 << 20, {"mont_sqr"}, {"mont_sqr"}),
            (W16, level, level), (W20, level | {"pack_glv"}, set()))

    def canon_err(a, b):
        return diff(_canon(f, a), _canon(f, b))

    def packed_err(a, b):
        return _packed_err(f, a, b, diff)

    def pre_err(a, b):  # (denom, numer, flags)
        return max(canon_err(a[0], b[0]), canon_err(a[1], b[1]), diff(a[2].long(), b[2].long()))

    def flags(*shape):
        return torch.randint(0, 2, shape, dtype=torch.int32, device=dev, generator=gen)

    for M, names, timed in plan:
        x, y = _field_plane(f, M, gen, adv), _field_plane(f, M, gen, adv[::-1])
        cases = {}
        if "divstep_inv_mont" in names:  # bit for bit
            cases["divstep_inv_mont"] = (M, lambda: f.inv_root(x),
                                         lambda: divstep.inv_mont_plain(f, x), lambda a, b: _raw_err([a], [b]))
        if "mont_sqr" in names:
            xs = x[:, 5:]  # a column slice
            cases["mont_sqr"] = (M, lambda: f.square(x), lambda: f.square_plain(x), canon_err)
            cases["mont_sqr slice"] = (M - 5, lambda: f.square(xs), lambda: f.square_plain(xs),
                                       canon_err)
        if "mont_mul" in names:
            h = M // 2
            lo, hi = x[:, :h], x[:, h:2 * h]  # the tree's contiguous halves
            cases["mont_mul"] = (M, lambda: f.mul(x, y), lambda: f.mul_plain(x, y), canon_err)
            cases["mont_mul halves"] = (h, lambda: f.mul(lo, hi), lambda: f.mul_plain(lo, hi),
                                        canon_err)
        if "pack_glv" in names:
            npts = min(M, 1 << max(MSM_LOG2N))
            inf = torch.randint(0, 8, (npts,), device=dev, generator=gen) == 0
            pts_ = AffineBatch(x[:, :npts].contiguous(), y[:, :npts].contiguous(), inf)
            cases["pack_glv"] = (npts, lambda: aff.pack_rows_glv(pts_),
                                 lambda: aff.pack_rows_glv_plain(pts_), packed_err)
        if names & level:
            inf = torch.randint(0, 8, (M,), device=dev, generator=gen) == 0
            inf2 = torch.cat([inf, inf.flip(0)]).to(torch.int32)[None]
            C = torch.cat([torch.cat([x, y], dim=-1), torch.cat([y, x], dim=-1), inf2])
            sg, hp = flags(1, 2 * M), flags(1, M)
            K = min(M, 1200)
            FA, FB, fsa, fsb, fhp = _flag_lanes(ctx, pts, K)
            C[:, :K], C[:, M:M + K] = FA, FB
            sg[:, :K], sg[:, M:M + K], hp[:, :K] = fsa, fsb, fhp
            A, B = C[:, :M], C[:, M:]  # a level's two halves
            sA, sB = sg[:, :M], sg[:, M:]
            dinv = _field_plane(f, M, gen, adv)
            denom = aff.pre_packed_u(A, B, hp)
            inv1, h1 = f.batch_inv_parent(denom)
            cases["aff_pre_packed_u"] = (M, lambda: aff.pre_packed_u(A, B, hp),
                                         lambda: aff.pre_packed_u_plain(A, B, hp), canon_err)
            cases["aff_post_packed_u"] = (
                M, lambda: aff.post_packed_u(A, B, sA, sB, inv1, denom, h1, hp),
                lambda: aff.post_packed_u_plain(A, B, sA, sB, inv1, denom, h1, hp), packed_err)
            h = M // 2
            for tag, ops in (("", (A, B, sA, sB, hp)),
                             (" halves", (A[:, :h], B[:, :h], sA[:, :h], sB[:, :h], hp[:, :h]))):
                lanes = ops[0].shape[-1]
                _, numer, fl = aff.pre_packed(*ops)
                d = dinv[:, :lanes]
                cases["aff_pre_packed" + tag] = (lanes, lambda o=ops: aff.pre_packed(*o),
                                                 lambda o=ops: aff.pre_packed_plain(*o), pre_err)
                cases["aff_post_packed" + tag] = (
                    lanes, lambda o=ops, d=d, u=numer, g=fl: aff.post_packed(*o[:4], d, u, g, o[4]),
                    lambda o=ops, d=d, u=numer, g=fl: aff.post_packed_plain(*o[:4], d, u, g, o[4]),
                    packed_err)
        for label, (lanes, kern, plain, err_of) in cases.items():
            err = err_of(kern(), plain())
            say(f"{label} N={lanes}: max_abs_err {err}")
            if err:
                raise AssertionError(f"{label} at {lanes} lanes disagrees with its plain version")
            if label in timed:
                extra = {"batches": divstep_batches(f, x)[0]} if label == "divstep_inv_mont" else {}
                record(label, err, cuda_time_ms(kern, KERNEL_REPS), cuda_time_ms(plain, 3, 1), lanes, **extra)
            else:
                record(label.split()[0], err)
        del cases


def planar_kernels(ctx, pts, record, diff):
    """The planar adds' kernels (aff_pre, aff_post, aff_pre_unsafe with and
    without its validity mask, aff_post_unsafe) against their plain versions
    on the same tensors, bit for bit (raw planes, flags and masks), at 2^16,
    2^16 + 17 and 2^20 lanes. The operands are column slices of wider
    planes; the first lanes hold every flag class of `_flag_lanes` (the
    signs folded into y: doubling, cancellation, each operand infinite, both,
    the order-2 point (p - 1, 0) doubled, unreduced representatives), the
    rest random values below 2^bits(p) with one lane in 8 infinite; the
    masked pre kernel's unpaired classes are invalid lanes, the rest random.
    Each kernel is timed at 2^20 lanes (aff_pre_unsafe with its mask)."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch

    f, aff, dev = ctx.fops, ctx.affine, ctx.device
    n = f.n
    gen = torch.Generator(device=dev).manual_seed(5)

    def raw_err(a, b):
        a, b = (t if isinstance(t, tuple) else (t,) for t in (a, b))
        return max(diff(x.long(), y.long()) for x, y in zip(a, b))

    for M in PLANAR_LANES:
        X, Y = _random_planes(f, n, 2 * M, gen), _random_planes(f, n, 2 * M, gen)
        inf = torch.randint(0, 8, (2 * M,), device=dev, generator=gen) == 0
        K = min(M, 1200)
        FA, FB, fsa, fsb, fhp = _flag_lanes(ctx, pts, K)
        for off, F, sg in ((0, FA, fsa), (M, FB, fsb)):
            X[:, off:off + K] = F[:n]
            Y[:, off:off + K] = torch.where(sg != 0, f.neg(F[n:2 * n]), F[n:2 * n])
            inf[off:off + K] = F[2 * n] != 0
        G = AffineBatch(X[:, :M], Y[:, :M], inf[:M])
        H = AffineBatch(X[:, M:], Y[:, M:], inf[M:])
        valid = torch.randint(0, 2, (M,), device=dev, generator=gen) == 1
        valid[:K] = fhp[0] != 0
        dinv = _random_planes(f, n, M, gen)
        _, numer, flags = aff.pre(G, H)
        cases = {
            "aff_pre": (lambda: aff.pre(G, H), lambda: aff.pre_plain(G, H)),
            "aff_post": (lambda: aff.post(G, H, dinv, numer, flags),
                         lambda: aff.post_plain(G, H, dinv, numer, flags)),
            "aff_pre_unsafe": (lambda: aff.pre_unsafe(G.x, H.x, valid),
                               lambda: aff.pre_unsafe_plain(G.x, H.x, valid)),
            "aff_pre_unsafe without mask": (lambda: aff.pre_unsafe(G.x, H.x),
                                            lambda: aff.pre_unsafe_plain(G.x, H.x)),
            "aff_post_unsafe": (lambda: aff.post_unsafe(G, H, dinv),
                                lambda: aff.post_unsafe_plain(G, H, dinv)),
        }
        for label, (kern, plain) in cases.items():
            err = raw_err(kern(), plain())
            say(f"{label} N={M}: max_abs_err {err} (raw planes)")
            if err:
                raise AssertionError(f"{label} at {M} lanes disagrees with its plain version")
            if M == PLANAR_LANES[-1] and " " not in label:
                record(label, err, cuda_time_ms(kern, KERNEL_REPS), cuda_time_ms(plain, 3, 1), M)
            else:
                record(label.split()[0], err)
        del cases, X, Y


def _window_sums(ctx, pts, K: int, rng: random.Random, lanes: int = 1):
    """K window sums of `lanes` combines as projective planes (n, lanes, K)
    on the card: oracle points with random Z, a coordinate in 4 unreduced
    (+p), and the identity (0 : 1 : 0) in two windows of each lane (the top
    one among them in about half the lanes); returns (planes, the points on
    the host, lane by lane)."""
    from montgomery_tpu_torch.bigint.weierstrass import AffinePoint
    from montgomery_tpu_torch.curves.projective import ProjectiveBatch

    f = ctx.fops
    p, R = f.p, f.R
    cols, host = ([], [], []), []
    for i in range(lanes * K):
        if i % K == 0:
            ident = {rng.randrange(K), K - 1 if rng.random() < 0.5 else rng.randrange(K)}
        pt = AffinePoint.zero() if i % K in ident else pts[rng.randrange(len(pts))]
        z = rng.randrange(1, p)
        xyz = (0, 1, 0) if pt.is_zero else (pt.x * z % p, pt.y * z % p, z)
        for col, v in zip(cols, xyz):
            col.append(v * R % p + (p if rng.random() < 0.25 else 0))
        host.append(pt)
    W = ProjectiveBatch(*[f.pack_raw(col, ctx.device).reshape(f.n, lanes, K) for col in cols])
    return W, host


def _raw_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0 for x, y in zip(a, b))


class OneThreadDoublings:
    """The projective adapter with every double_n on proj_dbl_rcb's
    one-thread body: the halving combine over it is the window combine as
    it ran before proj_combine_rcb."""

    def __init__(self, adapter):
        self._adapter = adapter

    def __getattr__(self, name):
        return getattr(self._adapter, name)

    def double_n(self, P, k: int):
        return self._adapter.proj.double_n(P, k, few=False)


def phase_redesign(ctx, pts, pts_full, rates: dict) -> dict:
    """The kernels redesigned for this card, at the main paths' shapes.

    - proj_combine_rcb for (K, c) = COMBINE_CASES, one launch on one lane
      for each of REDESIGN_REPS fresh inputs (identities among the windows,
      unreduced values): bit for bit against the plain Horner
      (`combine_plain`, one run over all the inputs), and as affine
      points against the halving combine through the one-thread double_n
      (`combine_halving` over `OneThreadDoublings`: the log-depth combine it
      replaced) and against Python's ints for the first input; timed beside
      both, with its bound and the dependent-chain floor (serial warp
      products x the latency of one, phase 0).
    - proj_dbl_rcb's few-lane body at k = 6 on 10 lanes (window_sums' at
      2^20) and 1 lane, bit for bit against the plain version and the wide
      body; both bodies timed on 10 lanes, and a doubling's time on one
      lane. (The one-thread body's wide launches are timed in the kernel
      table's k = 1 row, on 65,536 lanes.)
    - the fused aff_post_packed_u at 1, 513, 835,592 and 10,649,608 lanes
      (column slices of wider arrays, random signs and pairs, distinct x),
      REDESIGN_REPS fresh inputs below 10^7 lanes and one at the widest: bit
      for bit against its plain version (`post_packed_u_plain`) and against
      the full `batch_inv` with the plain chord; timed at the two widest,
      beside the descent level it replaces (`FieldOps._descend`).

    - proj_add_rcb's two bodies (`redesign_add`), glv_digits
      (`redesign_glv`) and the safegcd inverse (`redesign_divstep`, on the
      2^20 bench points `pts_full`).

    Returns per-kernel results: proj_combine_rcb's row, and the main-path
    rows ("main_path") of proj_dbl_rcb, aff_post_packed_u, proj_add_rcb,
    glv_digits and divstep_inv_mont (with divstep_inv's)."""
    import torch

    from montgomery_tpu_torch.bigint import WeierstrassCurve
    from montgomery_tpu_torch.curves.projective import ADD_MULS, DBL_MULS, ProjectiveBatch
    from montgomery_tpu_torch.msm.pippenger import combine_halving

    say("== phase 1: the redesigned kernels at the main paths' shapes")
    f, proj, aff, dev = ctx.fops, ctx.proj, ctx.affine, ctx.device
    n, W = f.n, 4 * f.n
    E = WeierstrassCurve(ctx.params)
    rng = random.Random(9)
    out = {}

    one_thread = OneThreadDoublings(ctx.adapter)
    # -- the window combine: REDESIGN_REPS fresh inputs, one launch each,
    # against one plain Horner over all of them (lane r of planes (n, reps, K))
    combine = {}
    for K, c in COMBINE_CASES:
        Wall, host = _window_sums(ctx, pts, K, rng, lanes=REDESIGN_REPS)
        want, plain_ms = timed_once(lambda: proj.combine_plain(Wall, c))  # the inputs in one run
        err = 0
        for rep in range(REDESIGN_REPS):
            Wk = ProjectiveBatch(*[a[:, rep:rep + 1].contiguous() for a in Wall])
            got = proj.combine(Wk, c)
            err = max(err, _raw_err(got, ProjectiveBatch(*[a[:, rep:rep + 1] for a in want])))
            flat = ProjectiveBatch(*[a.reshape(n, K) for a in Wk])
            halving = combine_halving(one_thread, flat, c, K)
            a, b = proj.to_host(got)[0], proj.to_host(halving)[0]
            if err or not E.equal(a, b):
                raise AssertionError(f"proj_combine_rcb K={K} c={c} disagrees (rep {rep}, raw err {err})")
            if rep == 0:
                expect = E.scale(0, E.generator)
                for k, pt in enumerate(host[:K]):
                    expect = E.add(expect, E.scale(1 << (c * k), pt))
                if not E.equal(a, expect):
                    raise AssertionError(f"proj_combine_rcb K={K} c={c} differs from Python's ints")
        ms = cuda_time_ms(lambda: proj.combine(Wk, c), 20)
        half_ms = cuda_time_ms(lambda: combine_halving(one_thread, flat, c, K), 10)
        products = (K - 1) * (c * DBL_MULS + ADD_MULS)
        bms, by = bound_of((K + 1) * 3 * W, products * 2 * n * n, products * n, 1, rates)
        serial = 3 * (K - 1) * (c + 1)  # warp products on the critical path
        floor = serial * rates["lat_warp"] * 1e3
        combine[(K, c)] = dict(ms=ms, plain_ms=plain_ms, halving_ms=half_ms, bound_ms=bms, bound_by=by,
                               floor_ms=floor, serial_products=serial, max_abs_err=err)
        say(f"proj_combine_rcb K={K} c={c}: {REDESIGN_REPS} fresh inputs bit for bit with the plain "
            f"Horner and equal to the halving combine; kernel {ms:.4f} ms, halving (one-thread "
            f"double_n) {half_ms:.4f} ms, plain {plain_ms:.1f} ms (the {REDESIGN_REPS} inputs in one run); "
            f"bound {bms * 1e3:.3f} us "
            f"({by}, share {bms / ms:.4f}); floor {serial} x {rates['lat_warp'] * 1e6:.3f} us = "
            f"{floor:.4f} ms (share {floor / ms:.3f})")
    main = combine[COMBINE_CASES[0]]
    out["proj_combine_rcb"] = dict(main, lanes=1, call=f"K={COMBINE_CASES[0][0]}, c={COMBINE_CASES[0][1]}",
                                   main_path={f"K={K}, c={c}": v for (K, c), v in combine.items()})

    # -- few-lane doublings
    k, lanes = FEW_DBL
    err = 0
    for N in (lanes, 1):
        for rep in range(REDESIGN_REPS):
            Wk, host = _window_sums(ctx, pts, lanes, rng)
            keep = [i for i, pt in enumerate(host) if N == lanes or not pt.is_zero][:N]
            P = ProjectiveBatch(*[a.reshape(n, lanes)[:, keep].contiguous() for a in Wk])
            got = proj.double_n(P, k)
            err = max(err, _raw_err(got, proj.double_n_plain(P, k)),
                      _raw_err(got, proj.double_n(P, k, few=False)))
            if err:
                raise AssertionError(f"proj_dbl_rcb few-lane k={k} N={N} disagrees (rep {rep})")
    P1 = P  # the last one-lane input (no identity)
    Wk, _ = _window_sums(ctx, pts, lanes, rng)
    P = ProjectiveBatch(*[a.reshape(n, lanes) for a in Wk])
    few_ms = cuda_time_ms(lambda: proj.double_n(P, k), 50)
    wide_ms = cuda_time_ms(lambda: proj.double_n(P, k, few=False), 20)
    bms, by = bound_of(6 * W, k * DBL_MULS * 2 * n * n, k * DBL_MULS * n, lanes, rates)
    per_dbl = cuda_time_ms(lambda: proj.double_n(P1, DBL_CHAIN), 5) * 1e3 / DBL_CHAIN
    chain = DBL_CHAIN // 10  # the one-thread body takes about 10x longer a doubling
    per_dbl_wide = cuda_time_ms(lambda: proj.double_n(P1, chain, few=False), 5) * 1e3 / chain
    say(f"proj_dbl_rcb few-lane body k={k}: {REDESIGN_REPS} fresh inputs at {lanes} and 1 lanes bit "
        f"for bit with the plain version and the one-thread body; {lanes} lanes: {few_ms:.4f} ms "
        f"(one-thread body {wide_ms:.4f} ms), bound {bms * 1e3:.3f} us ({by}); one lane: "
        f"{per_dbl:.3f} us a doubling (one-thread body {per_dbl_wide:.3f} us)")
    out["proj_dbl_rcb"] = dict(main_path=dict(
        k=k, lanes=lanes, ms=few_ms, one_thread_ms=wide_ms, bound_ms=bms, bound_by=by,
        us_a_doubling=per_dbl, us_a_doubling_one_thread=per_dbl_wide, max_abs_err=err,
        few_lanes=proj.FEW_LANES), carry_chain=redesign_dbl(ctx, pts_full, rates))

    # -- the fused post
    gen = torch.Generator(device=dev).manual_seed(11)
    post = {}
    widths = (1, 513, first_level_width(ctx, 16), first_level_width(ctx, 20))
    for M in widths:
        reps = 1 if M == widths[-1] else REDESIGN_REPS
        err = 0
        for rep in range(reps):
            # A and B: column slices of one array of 2M + 3 random columns
            C = _random_planes(f, 2 * n + 1, 2 * M + 3, gen)
            C[2 * n] = 0
            A, B = C[:, 1:M + 1], C[:, M + 3:]
            sA, sB, hp = (torch.randint(0, 2, (1, M), dtype=torch.int32, device=dev, generator=gen)
                          for _ in range(3))
            denom = aff.pre_packed_u(A, B, hp)
            inv1, h = f.batch_inv_parent(denom)
            got = aff.post_packed_u(A, B, sA, sB, inv1, denom, h, hp)
            old = aff.post_packed_u_plain(A, B, sA, sB, f.batch_inv(denom), denom, 0, hp)
            err = max(err, _raw_err(got, aff.post_packed_u_plain(A, B, sA, sB, inv1, denom, h, hp)),
                      _raw_err(got, old))
            if err:
                raise AssertionError(f"aff_post_packed_u at {M} lanes disagrees (rep {rep})")
            del old
        row = dict(max_abs_err=err, checks=reps, h=h)
        if M >= widths[-2]:
            row["ms"] = cuda_time_ms(lambda: aff.post_packed_u(A, B, sA, sB, inv1, denom, h, hp), 20)
            row["descent_level_ms"] = cuda_time_ms(lambda: f._descend(denom, inv1), 20)
            row["bound_ms"], row["bound_by"] = bound(ctx, "aff_post_packed_u", M, rates)
            if M == widths[-2]:
                row["plain_ms"] = cuda_time_ms(
                    lambda: aff.post_packed_u_plain(A, B, sA, sB, inv1, denom, h, hp), 3, 1)
            say(f"aff_post_packed_u N={M}: kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}, share {row['bound_ms'] / row['ms']:.3f}); the descent level it "
                f"replaces {row['descent_level_ms']:.4f} ms")
        say(f"aff_post_packed_u N={M} (h={h}): {reps} fresh inputs bit for bit with the plain version "
            f"and with batch_inv + the plain chord")
        post[str(M)] = row
        del C, A, B, denom, inv1, got
        torch.cuda.empty_cache()
    out["aff_post_packed_u"] = dict(main_path=post)
    out["proj_add_rcb"] = redesign_add(ctx, pts, rng)
    out["glv_digits"] = redesign_glv(ctx, rates)
    out["divstep_inv_mont"] = dict(main_path=redesign_divstep(ctx, pts_full, rates))
    return out


def _add_inputs(ctx, pts, N: int, rng: random.Random):
    """Two projective batches (P, Q) of N lanes, each lane one of: distinct
    points, P == Q, P == -Q, P = 0, Q = 0, both 0 (the identity (0 : 1 :
    0)); random Z and a quarter of the coordinates unreduced (+p)."""
    from montgomery_tpu_torch.curves.projective import ProjectiveBatch

    f = ctx.fops
    p, R = f.p, f.R
    cols = ([], [], []), ([], [], [])
    for _ in range(N):
        kind = rng.randrange(6)
        a = pts[rng.randrange(len(pts))]
        b = a if kind in (1, 2) else pts[rng.randrange(len(pts))]
        for side, pt in enumerate((a, b)):
            z = rng.randrange(1, p)
            xyz = (pt.x * z % p, (-1 if side and kind == 2 else 1) * pt.y * z % p, z)
            if kind == 5 or kind == 3 + side:
                xyz = (0, 1, 0)
            for col, v in zip(cols[side], xyz):
                col.append(v * R % p + (p if rng.random() < 0.25 else 0))
    return [ProjectiveBatch(*[f.pack_raw(c, ctx.device) for c in side]) for side in cols]


def redesign_add(ctx, pts, rng: random.Random) -> dict:
    """proj_add_rcb's two bodies: at every width of ADD_CHECK_LANES,
    REDESIGN_REPS fresh inputs (`_add_inputs`), each body bit for bit
    against add_plain and against the other, and the body `add` picks;
    then the sweep: each body's device time a launch (torch.profiler) at
    every width of ADD_SWEEP_LANES on random planes, with the lanes one wave
    of its blocks covers."""
    import torch

    from montgomery_tpu_torch.curves.projective import ProjectiveBatch
    from montgomery_tpu_torch.ops import kernels

    proj = ctx.proj
    bodies = {"six": False, "few": True}  # the six-threads-a-lane body and the few-lane one
    err = 0
    for N in ADD_CHECK_LANES:
        for rep in range(REDESIGN_REPS):
            P, Q = _add_inputs(ctx, pts, N, rng)
            got = proj.add(P, Q)
            err = max(err, _raw_err(got, proj.add_plain(P, Q)),
                      *[_raw_err(proj.add(P, Q, few=few), got) for few in bodies.values()])
            if err:
                raise AssertionError(f"proj_add_rcb disagrees at {N} lanes (rep {rep}, raw err {err})")
    say(f"proj_add_rcb: {REDESIGN_REPS} fresh inputs at each of {ADD_CHECK_LANES} lanes (identities, "
        f"P == Q, P == -Q, unreduced values), both bodies bit for bit with add_plain and with each other")
    lib = kernels.LIBRARY.get()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = getattr(lib, kernels.symbols("proj_add_rcb_blocks_per_sm", proj.f.n)[proj.f.n])
    wave = {b: per_sm(int(few)) * (1 if few else 32) * sms for b, few in bodies.items()}
    say(f"proj_add_rcb lanes a wave ({sms} SMs; resident blocks a SM x lanes a block x SMs): {wave}")
    gen = torch.Generator(device=ctx.device).manual_seed(12)
    n, sweep = ctx.fops.n, {}
    for N in ADD_SWEEP_LANES:  # values below 2p: the bodies' times do not depend on them
        P, Q = (ProjectiveBatch(*_random_planes(ctx.fops, 3 * n, N, gen).split(n)) for _ in range(2))

        def launches():
            for few in bodies.values():
                for _ in range(ADD_SWEEP_REPS):
                    proj.add(P, Q, few=few)

        traced = device_times_whole(launches, lambda r: len(r[4]) == 2 * ADD_SWEEP_REPS,
                                    r"proj_add_rcb(_few)?_kernel")[4]
        seen = {b: [] for b in bodies}
        for name, ms in traced:
            seen["few" if "_few_" in name else "six"].append(ms * 1e3)
        if not all(seen.values()):  # the profiler may drop a few events, not a body's every one
            raise AssertionError(f"the profiler saw {[len(v) for v in seen.values()]} launches a body")
        row = {b: sum(v) / len(v) for b, v in seen.items()}
        sweep[N] = row
        say(f"proj_add_rcb sweep {N} lanes (device us a launch, mean of the traced of "
            f"{ADD_SWEEP_REPS}): " + ", ".join(f"{b} {row[b]:.2f} ({len(v)})" for b, v in seen.items())
            + f"; picked: {'few' if N < proj.FEW_ADD_LANES else 'six'}")
    return dict(main_path=dict(check_lanes=list(ADD_CHECK_LANES), max_abs_err=err, lanes_a_wave=wave,
                               sweep_us=sweep, few_add_lanes=proj.FEW_ADD_LANES))


def redesign_glv(ctx, rates: dict) -> dict:
    """glv_digits at the main paths' (N, c) = GLV_CASES and at every c of
    the window table, bit for bit against digits_glv_plain, the edge
    scalars (`glv_edge_scalars`: 0, 1, q - 1, q - 2, 2^252 and near-integer
    s g / 2^m) in the first lanes; BLS12-381's and Pallas's instantiations
    the same way at 2^16; a GlvConst of sizes no instantiation has must be
    refused; device time (torch.profiler) and bound at 2^20, c = 13, on
    all three curves (BLS12-381's and Pallas's on random scalars)."""
    import numpy as np
    import torch

    from montgomery_tpu_torch.concrete import BLS12_381, PALLAS
    from montgomery_tpu_torch.msm.pippenger import window_size
    from montgomery_tpu_torch.ops import kernels
    from montgomery_tpu_torch.scalar.device import (GLV_DIGITS, GLV_SHAPES, digits_glv_device,
                                                    digits_glv_plain, glv_device, ints_to_limbs_np)
    from montgomery_tpu_torch.scalar.glv import glv_params
    from montgomery_tpu_torch.testing.generators import glv_edge_scalars

    cs = sorted({window_size(k) for k in range(10, 22)})

    def check(gd, q, log2n: int, cases, label: str):
        """N = 2^log2n scalars (the bench scalars on BLS12-377), the edge
        scalars first, for every c of `cases`; returns the limbs."""
        def limbs(vals):
            return torch.from_numpy(ints_to_limbs_np(vals, q.bit_length(), gd.w, gd.ns)).to(ctx.device)

        N = 1 << log2n
        if gd is ctx.glv_dev:
            sl = ctx.scalars_to_limbs(bench_scalars(q, N))
        else:
            rnd = np.random.default_rng(log2n)
            sl = limbs([int.from_bytes(rnd.bytes(32), "little") % q for _ in range(N)])
        edge = glv_edge_scalars(gd, q)
        sl[:, :len(edge)] = limbs(edge)
        for c in cases:
            got = digits_glv_device(gd, sl, c)
            want = digits_glv_plain(gd, sl, c)
            err = _raw_err([got], [want]) if got.shape == want.shape else -1
            if err:
                raise AssertionError(f"glv_digits {label} N=2^{log2n} c={c} disagrees (err {err})")
        say(f"glv_digits {label} N=2^{log2n}: c in {list(cases)} bit for bit with digits_glv_plain "
            f"({len(edge)} edge scalars first)")
        return sl

    def device_row(gd, sl, c, label):
        """Device time a launch (profiler), events, plain and bound of one
        call at sl's width."""
        N = sl.shape[1]
        per = device_times_whole(lambda: [digits_glv_device(gd, sl, c) for _ in range(ADD_SWEEP_REPS)],
                                 lambda r: r[0].get("glv_digits", (0,))[0] == ADD_SWEEP_REPS)[0]
        count, dev_ms = per.get("glv_digits", (0, 0.0))
        dev = dev_ms / count if count else None  # None: the profiler kept none of the launches
        ms = cuda_time_ms(lambda: digits_glv_device(gd, sl, c), 20)
        plain_ms = cuda_time_ms(lambda: digits_glv_plain(gd, sl, c), 3, 1)
        bms, by = bound(types.SimpleNamespace(glv_dev=gd, fops=ctx.fops), "glv_digits", N, rates)
        say(f"glv_digits {label} N={N} c={c}: device "
            + (f"{dev:.4f} ms a launch (profiler, share of the bound {bms / dev:.3f})" if dev else "not measured")
            + f", {ms:.4f} ms (events), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
        return dict(lanes=N, c=c, device_ms=dev, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    q = ctx.params.order
    for log2n, c in GLV_CASES:
        sl = check(ctx.glv_dev, q, log2n, sorted({c, *cs}), "BLS12-377")
    others = {}
    log2n, c = GLV_CASES[-1]
    for C in (BLS12_381, PALLAS):
        gd = glv_device(glv_params(C.order, C.endomorphism.lam), w=ctx.glv_dev.w)
        label = GLV_SHAPES[gd.kernel_shape]
        check(gd, C.order, 16, cs, label)
        # the main path's call on this curve: 2^20 scalars
        rnd = np.random.default_rng(log2n)
        sl_c = torch.from_numpy(ints_to_limbs_np([int.from_bytes(rnd.bytes(32), "little") % C.order
                                                  for _ in range(1 << log2n)], C.order.bit_length(), gd.w,
                                                 gd.ns)).to(ctx.device)
        others[label] = device_row(gd, sl_c, c, label)
        del sl_c
    words = ctx.glv_dev.kernel_words(13)
    words[3] += 1  # nu: no instantiation has it
    try:
        out = torch.empty((int(words[8]), 2), dtype=torch.int32, device=ctx.device)  # K rows
        GLV_DIGITS.launch(kernels.ptr(out), kernels.ptr(sl), words.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), 1, device=out.device)
    except RuntimeError as e:
        say(f"glv_digits refuses a shape it lacks: {e}")
    else:
        raise AssertionError("glv_digits launched on sizes it has no instantiation for")
    rows = dict(device_row(ctx.glv_dev, sl, c, "BLS12-377"), window_cs=cs, **others)
    return dict(main_path=rows)


def root_widths(ctx, pts_full) -> dict:
    """{log2 N: lane counts of the main path's divstep_inv_mont launches, in
    launch order} for affine-unsafe at N = 2^16 and 2^20 on the bench
    scalars, recorded from the batch-inversion tree of one run each."""
    from montgomery_tpu_torch.curves.projective import AffineBatch

    f, seen, out = ctx.fops, [], {}
    inv_root = f.inv_root
    f.inv_root = lambda x: (seen.append(x.shape[-1]), inv_root(x))[1]
    try:
        for log2n in MSM_LOG2N:
            N = 1 << log2n
            seen.clear()
            ctx.msm_device_full(AffineBatch(*[a[..., :N] for a in pts_full]),
                                ctx.scalars_to_limbs(bench_scalars(ctx.params.order, N)), ctx.default_c(N),
                                affine=True, unsafe=True)
            out[log2n] = list(seen)
    finally:
        del f.inv_root
    return out


def redesign_divstep(ctx, pts_full, rates: dict) -> dict:
    """The safegcd inverse redesigned for this card, at the curve's limb
    count (12, 13 or 9), at the main paths' shapes.

    - divstep_inv_mont (one warp a lane) at 1 lane, 512 and every root width
      the main path (affine-unsafe) gives it at 2^16 and 2^20 (`root_widths`),
      REDESIGN_REPS fresh inputs each, bit for bit against the plain version
      (one run over all of them); the first lanes 0, 1, p - 1, R mod p, p,
      p + 1, 2p - 1 and the Montgomery forms (canonical and + p) of the
      input that needs the most batches among DIVSTEP_DRAW drawn, rotated by
      one lane each input (so one lane sees each). Device time a launch
      (torch.profiler) at 512 lanes and at 1, beside inv_mont_divstep (the
      one-thread divstep_inv between two mul_const, where divstep_inv is
      instantiated); its bound from the batches its inputs need, and the
      dependent-chain floor (most batches x a warp batch's latency + two
      warp products, phase 0).
    - divstep_inv (one thread a lane), where instantiated (12 and 9 limbs):
      at 512, 2^16, 2^18 and 2^18 + 17 lanes bit for bit against its plain
      version, the same first lanes (canonical); device time at 2^18, bound
      and floor (most batches x (30 divsteps + one application in a thread)).
    - ptxas of both (registers, stack frame, spill stores and loads).
    Returns the rows (divstep_inv's under "divstep_inv")."""
    import torch

    from montgomery_tpu_torch.ops import divstep, kernels
    from montgomery_tpu_torch.ops import limbs as codec

    f, dev = ctx.fops, ctx.device
    n, p, dp = f.n, f.p, f.inv_params
    t0 = time.perf_counter()
    say(f"== phase 1: the safegcd inverse at {n} limbs ({ctx.params.label}) at the main paths' shapes")
    gen = torch.Generator(device=dev).manual_seed(21)
    roots = root_widths(ctx, pts_full)
    draw = _canonical_plane(f, DIVSTEP_DRAW, gen, [])
    b = divstep.batches_needed(dp, draw)
    i = int(torch.argmax(b))
    most, most_b = codec.unpack(draw[:, i:i + 1])[0], int(b[i])
    adv = [0, 1, p - 1, f.R_mod_p, p, p + 1, 2 * p - 1, most * f.R % p, most * f.R % p + p]
    widths = sorted({1, ROOT_LANES, *[w for ws in roots.values() for w in ws]})
    err = 0
    for M in widths:
        xs = [_field_plane(f, M, gen, adv[r % len(adv):] + adv[:r % len(adv)]) for r in range(REDESIGN_REPS)]
        want = divstep.inv_mont_plain(f, torch.cat(xs, dim=1))
        for r, x in enumerate(xs):
            err = max(err, _raw_err([f.inv_root(x)], [want[:, r * M:(r + 1) * M]]))
        if err:
            raise AssertionError(f"divstep_inv_mont at {n} limbs and {M} lanes disagrees (raw err {err})")
    say(f"divstep_inv_mont n={n}: {REDESIGN_REPS} fresh inputs at each of {widths} lanes bit for bit with "
        f"the plain version (root widths by launch: "
        + "; ".join(f"2^{k} {v}" for k, v in roots.items()) + "; the most-batches "
        f"input of {DIVSTEP_DRAW} drawn needs {most_b} of {dp.n_batches})")

    def dev_ms(fn, names, reps=DIVSTEP_TIMING_REPS):
        """Device ms a call of fn (the sum of `names`' kernels), None where
        the profiler kept none of its launches."""
        per = device_times_whole(lambda: [fn() for _ in range(reps)],
                                 lambda r: all(r[0].get(k, (0,))[0] >= reps for k in names))[0]
        if not all(per.get(k, (0,))[0] for k in names):
            return None
        return sum(per[k][1] / per[k][0] * (2 if k == "mul_const" else 1) for k in names)

    x512 = _field_plane(f, ROOT_LANES, gen, adv)
    x1 = _field_plane(f, 1, gen, adv[7:8])  # the most-batches input alone
    mean_b, most512 = divstep_batches(f, x512)
    bms, by = bound(ctx, "divstep_inv_mont", ROOT_LANES, rates, mean_b)
    floor = (most512 * rates["lat_batch_warp"] + 2 * rates["lat_warp"]) * 1e3
    row = dict(lanes=ROOT_LANES, widths=widths, root_widths={str(k): v for k, v in roots.items()},
               max_abs_err=err, most_batches_drawn=most_b, n_batches=dp.n_batches,
               device_ms=dev_ms(lambda: f.inv_root(x512), ["divstep_inv_mont"]),
               ms=cuda_time_ms(lambda: f.inv_root(x512), DIVSTEP_TIMING_REPS),
               plain_ms=cuda_time_ms(lambda: divstep.inv_mont_plain(f, x512), 1, 0),
               device_ms_1_lane=dev_ms(lambda: f.inv_root(x1), ["divstep_inv_mont"]),
               batches_mean=mean_b, batches_most=most512, bound_ms=bms, bound_by=by, floor_ms=floor)
    if n in divstep.DIVSTEP_INV.symbols:
        row["inv_mont_divstep_device_ms"] = dev_ms(lambda: divstep.inv_mont_divstep(dp, x512),
                                                   ["mul_const", "divstep_inv"])
    ptx = ptxas_by_limbs(kernels.LIBRARY.build_log)
    row["ptxas"] = ptx.get(("divstep_inv_mont", n))
    dm, d1 = row["device_ms"], row["device_ms_1_lane"]
    say(f"divstep_inv_mont n={n} at {ROOT_LANES} lanes: device "
        + (f"{dm * 1e3:.2f} us a launch (share of the bound {bms / dm:.4f}, of the floor {floor / dm:.3f})"
           if dm else "not measured")
        + f", events {row['ms'] * 1e3:.2f} us, plain {row['plain_ms']:.2f} ms; 1 lane: device "
        + (f"{d1 * 1e3:.2f} us" if d1 else "not measured")
        + f"; batches mean {mean_b:.3f}, most {most512}; bound {bms * 1e3:.4f} us ({by}); floor "
        f"{most512} x {rates['lat_batch_warp'] * 1e6:.4f} + 2 x {rates['lat_warp'] * 1e6:.4f} us = "
        f"{floor * 1e3:.3f} us; ptxas {row['ptxas']}"
        + (f"; inv_mont_divstep (mul_const, divstep_inv, mul_const) device "
           + (f"{row['inv_mont_divstep_device_ms'] * 1e3:.2f} us" if row["inv_mont_divstep_device_ms"]
              else "not measured") if "inv_mont_divstep_device_ms" in row else ""))
    if n in divstep.DIVSTEP_INV.symbols:
        canon = [0, 1, 2, p - 1, p - 2, f.R_mod_p, most]
        for M in DIVSTEP_INV_LANES:
            x = _canonical_plane(f, M, gen, canon)
            e = _raw_err([divstep.inv_divstep(dp, x)], [divstep.inv_plain(dp, x)])
            if e:
                raise AssertionError(f"divstep_inv at {n} limbs and {M} lanes disagrees (raw err {e})")
        M = DIVSTEP_INV_LANES[2]
        x = _canonical_plane(f, M, gen, canon)
        mean_b, most_b = divstep_batches(f, x, mont=False)
        bms, by = bound(ctx, "divstep_inv", M, rates, mean_b)
        dm = dev_ms(lambda: divstep.inv_divstep(dp, x), ["divstep_inv"], 5)
        inv_row = dict(lanes=M, widths=list(DIVSTEP_INV_LANES), max_abs_err=0, device_ms=dm,
                       ms=cuda_time_ms(lambda: divstep.inv_divstep(dp, x), 5),
                       plain_ms=cuda_time_ms(lambda: divstep.inv_plain(dp, x), 1, 0),
                       batches_mean=mean_b, batches_most=most_b, bound_ms=bms, bound_by=by,
                       floor_ms=most_b * (rates["lat_divsteps_var"] + rates["lat_apply_thread"]) * 1e3,
                       ptxas=ptx.get(("divstep_inv", n)))
        row["divstep_inv"] = inv_row
        say(f"divstep_inv n={n}: bit for bit with the plain version at {list(DIVSTEP_INV_LANES)} lanes; at "
            f"{M} lanes device " + (f"{dm:.4f} ms a launch (share of the bound {bms / dm:.3f})" if dm
                                    else "not measured")
            + f", events {inv_row['ms']:.4f} ms, plain {inv_row['plain_ms']:.2f} ms, bound {bms:.4f} ms "
            f"({by}), floor {inv_row['floor_ms'] * 1e3:.2f} us; batches mean {mean_b:.3f}, most {most_b}; "
            f"ptxas {inv_row['ptxas']}")
    say(f"safegcd redesign phase at {n} limbs: {time.perf_counter() - t0:.1f} s")
    return row


# ------------------------------ the carry-chain product: the redesigned
# bodies (proj_dbl_rcb's wide body, ed_add_packed), each timed in turns


def in_turns(kernel, run, reps: int) -> dict:
    """run() timed in two turns (the redesigns' parents, which ran in turns
    with the new bodies, are gone: their turns stand in PERF.md). A turn is
    the CUDA-event mean of `reps` back-to-back runs and the profiler's
    device time a launch of `kernel` over `reps` more. Returns {"new":
    {"ms": [...], "device_ms": [...]}}, one value a turn."""
    out = {"ms": [], "device_ms": []}
    for _ in range(2):
        out["ms"].append(cuda_time_ms(run, reps, 1))
        per = device_times_whole(lambda: [run() for _ in range(reps)],
                                 lambda r: r[0].get(kernel.name, (0,))[0] == reps)[0]
        count, ms = per.get(kernel.name, (0, 0.0))
        out["device_ms"].append(ms / count if count else None)
    return {"new": out}


def say_turns(label: str, turns: dict, bound_ms: float, by: str) -> None:
    for body, t in turns.items():
        dev = [v for v in t["device_ms"] if v]
        say(f"{label} {body}: events " + " / ".join(f"{v:.4f}" for v in t["ms"]) + " ms, device "
            + (" / ".join(f"{v:.4f}" for v in dev) + f" ms (share of the bound {bound_ms / min(dev):.3f})"
               if dev else "not measured"))
    say(f"{label}: bound {bound_ms:.4f} ms ({by})")


def _dbl_inputs(ctx, pts_full, N: int, gen):
    """N projective points on the card from the 2^20 bench points (lane i
    holds point i mod 2^20), each scaled by a random z; lanes i = 3 mod 7
    the point at infinity (0 : z : 0), lanes i = 1 mod 5 canonical values
    plus p (in [p, 2p))."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch, ProjectiveBatch

    f, proj, dev = ctx.fops, ctx.proj, ctx.device
    lane = torch.arange(N, device=dev)
    idx = lane % pts_full.x.shape[-1]
    P = proj.from_affine(AffineBatch(pts_full.x[:, idx], pts_full.y[:, idx], pts_full.inf[idx]))
    z = _random_planes(f, f.n, N, gen)
    X, Y, Z = f.mul_list([(P.X, z), (P.Y, z), (P.Z, z)])
    inf = lane % 7 == 3
    X, Y, Z = (torch.where(inf, torch.zeros_like(X), X), torch.where(inf, z, Y),
               torch.where(inf, torch.zeros_like(Z), Z))
    up = lane % 5 == 1
    p = f.const_plane(f.p, X)
    return ProjectiveBatch(*[torch.where(up, f.add_lazy(f.reduce(a), p), a).contiguous() for a in (X, Y, Z)])


def redesign_dbl(ctx, pts_full, rates: dict) -> dict:
    """proj_dbl_rcb's wide body (few=False) at the curve's limb count: at
    every width of DBL_CHECK_LANES and k of DBL_CHECK_K, on `_dbl_inputs`,
    bit for bit against the plain version on every lane up to 2
    DBL_PLAIN_LANES lanes, else on the first and the last DBL_PLAIN_LANES.
    (The turns against the parent's CIOS body and the few-lane threshold's
    sweep of the finished redesign are in PERF.md.)"""
    import torch

    from montgomery_tpu_torch.curves.projective import ProjectiveBatch

    proj, n = ctx.proj, ctx.fops.n
    t0 = time.perf_counter()
    gen = torch.Generator(device=ctx.device).manual_seed(14)
    err = 0
    for N in DBL_CHECK_LANES:
        P = _dbl_inputs(ctx, pts_full, N, gen)
        if N <= 2 * DBL_PLAIN_LANES:
            sel = torch.arange(N, device=ctx.device)
        else:
            sel = torch.cat([torch.arange(DBL_PLAIN_LANES), torch.arange(N - DBL_PLAIN_LANES, N)]).to(ctx.device)
        Ps = ProjectiveBatch(*[a[:, sel] for a in P])
        for k in DBL_CHECK_K:
            got = proj.double_n(P, k, few=False)
            err = max(err, _raw_err([a[:, sel] for a in got], proj.double_n_plain(Ps, k)))
            say(f"proj_dbl_rcb wide body n={n} k={k} N={N}: raw err {err} (plain: {len(sel)} lanes)")
            if err:
                raise AssertionError(f"proj_dbl_rcb's wide body disagrees at {n} limbs, k={k}, N={N}")
        del P, Ps, got
    row = {"checks": dict(lanes=list(DBL_CHECK_LANES), k=list(DBL_CHECK_K), max_abs_err=err)}
    torch.cuda.empty_cache()
    say(f"proj_dbl_rcb redesign checks at {n} limbs: {time.perf_counter() - t0:.1f} s")
    return row


def scale_launches(k: int) -> list[tuple[str, int]]:
    """The launches of `scale_by` for the constant k, in order: ("dbl", its
    doublings) and ("add", 1)."""
    out, run = [], 0
    for bit in bin(k)[3:]:
        run += 1
        if bit == "1":
            out += [("dbl", run), ("add", 1)]
            run = 0
    return out + ([("dbl", run)] if run else [])


def profile_cofactor(ctx, pts_full, rates: dict) -> dict:
    """The cofactor stage of random_points_weierstrass at 2^20 points
    (ProjectiveOps.scale by the cofactor, as curves/random.py runs it) on
    the bench points: each launch's device time (torch.profiler) beside its k, its lanes and
    its bound, the device time by kernel and the host ms of one stage
    (median of 3)."""
    import statistics

    import torch

    proj, n = ctx.proj, ctx.fops.n
    P = proj.from_affine(pts_full)
    N, h = P.X.shape[-1], ctx.params.cofactor
    plan = scale_launches(h)

    def run():
        return proj.scale(h, P)

    out = {}
    for label in ("new",):
        per, busy, wall, others, traced = device_times_whole(
            run, lambda r: len(r[4]) == len(plan), r"proj_(dbl|add)_rcb(_few)?_kernel")
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        say_device_times(f"cofactor stage n={n} ({label} doubling body), 2^20 points", per, busy, wall, others)
        say(f"  host ms of the stage: median {statistics.median(host):.2f} of {['%.2f' % v for v in host]}")
        out[label] = dict(host_ms=host, busy_ms=busy, per_kernel={k: list(v) for k, v in per.items()})
        if len(traced) != len(plan):  # a partial trace would pair launches with the wrong k
            say(f"  by launch: not measured (the profiler kept {len(traced)} of {len(plan)} launches in "
                f"every try)")
            continue
        rows = []
        for (kind, k), (_, ms) in zip(plan, traced):
            bms = (bound(ctx, "proj_dbl_rcb", N, rates, k=k) if kind == "dbl"
                   else bound(ctx, "proj_add_rcb", N, rates))[0]
            rows.append(dict(kernel=kind, k=k, lanes=N, device_ms=ms, bound_ms=bms))
        for kind in ("dbl", "add"):
            sel = [r for r in rows if r["kernel"] == kind]
            dev, bnd = sum(r["device_ms"] for r in sel), sum(r["bound_ms"] for r in sel)
            say(f"  {kind}: {len(sel)} launches, device {dev:.4f} ms, bound {bnd:.4f} ms (share {bnd / dev:.3f}); "
                + ", ".join((f"k={r['k']} " if kind == "dbl" else "") + f"{r['device_ms']:.3f}" for r in sel))
        out[label]["launches"] = rows
    return out


def redesign_ed_packed(te, host, rates: dict) -> dict:
    """ed_add_packed at 1 lane and at the first super-round level of the
    2^20 path (first_level_width), on `_te_flag_lanes`' classes in the first
    lanes (oracle points `host`; every sign and pair flag, the identity on
    either side, P + P,
    P + (-P), unreduced values) and random planes after them, bit for bit
    against the plain version (1 lane); then timed at the level's width
    (`in_turns`, one body). Its 2^16 + 17 and 847,880-lane checks against
    the plain version are phase_te_kernels'."""
    import torch

    from montgomery_tpu_torch.curves.edwards import ED_ADD_PACKED

    f, ed, dev = te.fops, te.ed, te.device
    gen = torch.Generator(device=dev).manual_seed(15)
    rng = random.Random(15)
    out, err = {}, 0
    for M in (1, first_level_width(te, 20)):
        C = _random_planes(f, 4 * f.n, 2 * M, gen)
        sg = torch.randint(0, 2, (1, 2 * M), dtype=torch.int32, device=dev, generator=gen)
        hp = torch.randint(0, 2, (1, M), dtype=torch.int32, device=dev, generator=gen)
        K = min(M, 1200)
        FA, FB, fsa, fsb, fhp = _te_flag_lanes(te, host, K, rng)
        C[:, :K], C[:, M:M + K] = FA, FB
        sg[:, :K], sg[:, M:M + K], hp[:, :K] = fsa, fsb, fhp
        ops = (C[:, :M], C[:, M:], sg[:, :M], sg[:, M:], hp)
        got = ed.add_packed(*ops)
        if M == 1:
            err = max(err, _raw_err([got], [ed.add_packed_plain(*ops)]))
            say(f"ed_add_packed N={M}: raw err {err} against the plain version")
        if err:
            raise AssertionError(f"ed_add_packed disagrees at {M} lanes")
    turns = in_turns(ED_ADD_PACKED, lambda: ed.add_packed(*ops), 10)
    bms, by = bound(te, "ed_add_packed", M, rates)
    say_turns(f"ed_add_packed N={M}", turns, bms, by)
    out["turns"] = dict(turns, bound_ms=bms, bound_by=by, lanes=M, max_abs_err=err)
    del C, sg, hp, ops, got
    torch.cuda.empty_cache()
    return out


def _chord_adversarial(f, t, rows: list[int], start: int, adv: list[int]) -> None:
    """Writes the field values `adv` (Montgomery-form words, below 2p) into
    lanes start, start + 1, ... of each n-row block of t that begins at a
    row of `rows`, rotated by one value from block to block."""
    k = len(adv)
    for j, r in enumerate(rows):
        t[r:r + f.n, start:start + k] = f.pack_raw(adv[j % k:] + adv[:j % k], t.device)


def redesign_chord(ctx, pts, rates: dict) -> dict:
    """aff_post_packed_u and aff_post_unsafe on the carry-chain chord at the
    curve's limb count, against their plain versions on every lane, bit
    for bit, then timed (`in_turns`, one body).

    - aff_post_packed_u at the first super-round level of the 2^16 and the
      2^20 path (first_level_width): A and B column slices of one random
      array, `_flag_lanes`' classes (oracle points `pts`) in the first
      1,200 lanes with their signs and pairs, then 0, 1, p - 1, p, p + 1,
      2p - 1 and R mod p in x and y of both operands, and y2 = y1 lanes;
      inv1 (h = M // 2) and denom random with the same values first.
    - aff_post_unsafe at CHORD_PLANAR_LANES (2^20): the same flag classes
      (signs folded into y) and values in the planes and in dinv.

    Returns {kernel: {lanes: {turns, bound_ms, bound_by, max_abs_err}}}."""
    import torch

    from montgomery_tpu_torch.curves.affine import AFF_POST_PACKED_U, AFF_POST_UNSAFE
    from montgomery_tpu_torch.curves.projective import AffineBatch

    f, aff, dev, n, p = ctx.fops, ctx.affine, ctx.device, ctx.fops.n, ctx.fops.p
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)
    adv = [0, 1, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p]
    out = {"aff_post_packed_u": {}, "aff_post_unsafe": {}}

    def bits(M):
        return torch.randint(0, 2, (1, M), dtype=torch.int32, device=dev, generator=gen)

    def check(kernel, label, run, plain):
        def planes(r):
            return r if isinstance(r, tuple) else (r,)

        err = _raw_err(planes(run()), planes(plain()))
        say(f"{label}: raw err {err} against the plain version (every lane)")
        if err:
            raise AssertionError(f"{label} disagrees")
        return err

    def timed(kernel, label, M, run):
        turns = in_turns(kernel, run, CHORD_TURN_REPS)
        bms, by = bound(ctx, kernel.name, M, rates)
        say_turns(label, turns, bms, by)
        return dict(turns, bound_ms=bms, bound_by=by)

    for log2n in (16, 20):
        M = first_level_width(ctx, log2n)
        K = min(M, 1200)
        C = _random_planes(f, 2 * n + 1, 2 * M, gen)
        C[2 * n] = 0
        sg, hp = bits(2 * M), bits(M)
        FA, FB, fsa, fsb, fhp = _flag_lanes(ctx, pts, K)
        C[:, :K], C[:, M:M + K] = FA, FB
        sg[:, :K], sg[:, M:M + K], hp[:, :K] = fsa, fsb, fhp
        k = len(adv)
        _chord_adversarial(f, C, [0, n], K, adv)  # A's x and y
        _chord_adversarial(f, C, [0, n], M + K + k, adv[2:] + adv[:2])  # B's, in the next lanes
        lo = K + 2 * k  # then y2 = y1 (same sign), x2 random
        C[n:2 * n, M + lo:M + lo + k] = C[n:2 * n, lo:lo + k]
        sg[:, M + lo:M + lo + k] = sg[:, lo:lo + k]
        hp[:, K:K + 3 * k] = 1
        A, B = C[:, :M], C[:, M:]
        h = M // 2
        inv1 = _random_planes(f, n, (M + 1) // 2, gen)
        denom = _random_planes(f, n, M, gen)
        _chord_adversarial(f, inv1, [0], 0, adv)  # lane i < h: inv1[i] denom[i + h]
        _chord_adversarial(f, denom, [0], h, adv[::-1])
        ops = (A, B, sg[:, :M], sg[:, M:], inv1, denom, h, hp)
        label = f"aff_post_packed_u n={n} N={M}"
        err = check(AFF_POST_PACKED_U, label, lambda: aff.post_packed_u(*ops), lambda: aff.post_packed_u_plain(*ops))
        out["aff_post_packed_u"][str(M)] = dict(timed(AFF_POST_PACKED_U, label, M, lambda: aff.post_packed_u(*ops)),
                                                lanes=M, max_abs_err=err)
        del C, sg, hp, A, B, inv1, denom, ops
        torch.cuda.empty_cache()

    M, K = CHORD_PLANAR_LANES, 1200
    X, Y = _random_planes(f, n, 2 * M, gen), _random_planes(f, n, 2 * M, gen)
    FA, FB, fsa, fsb, _ = _flag_lanes(ctx, pts, K)
    for off, F, sgn in ((0, FA, fsa), (M, FB, fsb)):
        X[:, off:off + K] = F[:n]
        Y[:, off:off + K] = torch.where(sgn != 0, f.neg(F[n:2 * n]), F[n:2 * n])
    _chord_adversarial(f, X, [0], K, adv)
    _chord_adversarial(f, Y, [0], K, adv[::-1])
    Y[:, M + K:M + K + len(adv)] = Y[:, K:K + len(adv)]  # y2 = y1
    inf = torch.zeros(M, dtype=torch.bool, device=dev)
    G, H = AffineBatch(X[:, :M], Y[:, :M], inf), AffineBatch(X[:, M:], Y[:, M:], inf)
    dinv = _field_plane(f, M, gen, adv)
    label = f"aff_post_unsafe n={n} N={M}"
    err = check(AFF_POST_UNSAFE, label, lambda: aff.post_unsafe(G, H, dinv), lambda: aff.post_unsafe_plain(G, H, dinv))
    out["aff_post_unsafe"][str(M)] = dict(timed(AFF_POST_UNSAFE, label, M, lambda: aff.post_unsafe(G, H, dinv)),
                                          lanes=M, max_abs_err=err)
    del X, Y, G, H, dinv
    torch.cuda.empty_cache()
    say(f"the chord's redesign checks and turns at {n} limbs: {time.perf_counter() - t0:.1f} s")
    return out


def mul_const_widths(ctx, rates: dict) -> dict:
    """mul_const's device time a launch (the profiler, NEW_TIMING_REPS
    launches) at the curve's limb count on random planes at each width of
    MUL_CONST_WIDTHS, with its bound and share; checked bit for bit with the
    plain version first."""
    import torch

    f = ctx.fops
    gen = torch.Generator(device=ctx.device).manual_seed(18)
    c = ctx.proj.beta_mont
    out = {}
    for W in MUL_CONST_WIDTHS:
        x = _random_planes(f, f.n, W, gen)
        if _raw_err([f.mul_const(x, c)], [f.mul_const_plain(x, c)]):
            raise AssertionError(f"mul_const at {W} lanes disagrees with its plain version")
        per = device_times_whole(lambda: [f.mul_const(x, c) for _ in range(NEW_TIMING_REPS)],
                                 lambda r: r[0].get("mul_const", (0,))[0] == NEW_TIMING_REPS)[0]
        count, ms = per.get("mul_const", (0, 0.0))
        dev_ms = ms / count if count else None
        bms, by = bound(ctx, "mul_const", W, rates)
        out[str(W)] = dict(device_ms=dev_ms, bound_ms=bms, bound_by=by, share=bms / dev_ms if dev_ms else None)
        say(f"mul_const n={f.n} at {W} lanes: device " + (f"{dev_ms:.5f} ms" if dev_ms else "not measured")
            + f", bound {bms:.5f} ms ({by})" + (f", share {bms / dev_ms:.3f}" if dev_ms else ""))
        del x
    torch.cuda.empty_cache()
    return out


def redesign_ed_add(te, host, rates: dict) -> dict:
    """ed_add and ed_dbl (k = 1, and 6, the window sums' doubling) on both
    bodies (`few=False`: one thread a lane; `few=True`: the narrow-launch
    body) at every width of ED_WIDTHS, on `_te_flag_lanes`' classes in the
    first lanes and random planes after them, bit for bit against the plain
    version. (The bodies' sweep against the parent's CIOS body, a finished
    redesign, is in PERF.md.) Returns {"ed_add": ..., "ed_dbl": ...}, each
    {"max_abs_err", "widths"}."""
    import torch

    from montgomery_tpu_torch.curves.edwards import EdwardsBatch

    f, ed, dev = te.fops, te.ed, te.device
    n = f.n
    gen = torch.Generator(device=dev).manual_seed(16)
    rng = random.Random(16)
    out = {name: {"max_abs_err": 0, "widths": list(ED_WIDTHS)} for name in ("ed_add", "ed_dbl")}
    for M in ED_WIDTHS:
        C = _random_planes(f, 4 * n, 2 * M, gen)
        K = min(M, 1200)
        FA, FB, _, _, _ = _te_flag_lanes(te, host, K, rng)
        C[:, :K], C[:, M:M + K] = FA, FB
        PA, PB = (EdwardsBatch(*[a.contiguous() for a in ed.unpack_rows(t)]) for t in (C[:, :M], C[:, M:]))
        del C
        cases = {"ed_add": (lambda few: ed.add(PA, PB, few=few), lambda: ed.add_plain(PA, PB))}
        for k in ED_DBL_K:
            cases[f"ed_dbl k={k}"] = (lambda few, k=k: ed.double_n(PA, k, few=few),
                                      lambda k=k: ed.double_n_plain(PA, k))
        for label, (kern, plain) in cases.items():
            want = plain()
            got = {"wide": kern(False), "narrow": kern(True)}
            err = max(_raw_err(list(g), list(want)) for g in got.values())
            if err:
                raise AssertionError(f"{label} at {M} lanes: a body differs from the plain version "
                                     f"({ {b: _raw_err(list(g), list(want)) for b, g in got.items()} })")
            del want, got
        say(f"ed_add, ed_dbl k={ED_DBL_K} N={M}: both bodies bit for bit with the plain version")
        del PA, PB
        torch.cuda.empty_cache()
    return out


def profile_te_add(te, pts_full, rates: dict) -> dict:
    """The Twisted Edwards MSM at 2^20 (msm_device_full) with ed_add's and
    ed_dbl's bodies: each launch's device time (the profiler) beside its
    lanes and body (recorded at the wrapper), summed, with the summed bound
    and dependent-chain floor."""
    from montgomery_tpu_torch.curves.edwards import EdwardsBatch

    N = 1 << max(MSM_LOG2N)
    c = te.default_c(N)
    P = EdwardsBatch(*[a[..., :N] for a in pts_full])
    limbs = te.scalars_to_limbs(bench_scalars(te.params.order, N))
    ed, widths = te.ed, []
    own_add, own_dbl = ed.add, ed.double_n

    def add(A, B, few=None):
        widths.append(("ed_add", A.X.reshape(A.X.shape[0], -1).shape[-1], 1))
        return own_add(A, B, few=few)

    def dbl(A, k, few=None):
        if k > 0:
            widths.append(("ed_dbl", A.X.reshape(A.X.shape[0], -1).shape[-1], k))
        return own_dbl(A, k, few=few)

    def run():
        widths.clear()
        return te.msm_device_full(P, limbs, c)

    out = {"new": []}
    ed.add, ed.double_n = add, dbl
    try:
        for label in ("new",):
            per, busy, wall, others, traced = device_times_whole(
                run, lambda r: len(r[4]) == len(widths), r"ed_(add|dbl)(_few)?_kernel\b")
            if len(traced) != len(widths):
                say(f"  Twisted Edwards MSM 2^20 ({label} ed_add/ed_dbl bodies) by launch: not measured (the "
                    f"profiler kept {len(traced)} of {len(widths)} launches in every try)")
                continue
            turn = {"launches": [], "busy_ms": busy}
            for (name, M, k), (kname, ms) in zip(widths, traced):
                if not kname.split("<")[0].split()[-1].startswith(name):
                    raise AssertionError(f"launch order: {name} recorded, {kname} traced")
                body = "narrow" if "_few_kernel" in kname else "wide"
                turn["launches"].append((name, M, k, body, ms))
            for name in ("ed_add", "ed_dbl"):
                ls = [x for x in turn["launches"] if x[0] == name]
                dev = sum(x[4] for x in ls)
                bnd = sum(bound(te, name, M, rates, k=k)[0] for _, M, k, _, _ in ls)
                flo = sum((9 if b == "wide" else 3) * k * rates["lat_cc_n9"] for _, _, k, b, _ in ls) * 1e3
                turn[name] = dict(count=len(ls), device_ms=dev, bound_ms=bnd, floor_ms=flo)
                say(f"  TE MSM 2^20 ({label}): {name} {len(ls)} launches, device {dev:.4f} ms, bound summed "
                    f"{bnd:.5f} ms, dependent-chain floor summed {flo:.4f} ms; lanes, body, us: " + ", ".join(
                        f"{M}{'' if k == 1 else f' k={k}'} {b[0]} {ms * 1e3:.1f}" for _, M, k, b, ms in ls))
            out[label].append(turn)
    finally:
        del ed.add, ed.double_n
    return out


def profile_te_packed(te, pts_full, rates: dict) -> dict:
    """The Twisted Edwards MSM at 2^20 (msm_device_full) with ed_add_packed's
    body: each ed_add_packed launch's device time
    (torch.profiler) beside its lanes (recorded at the wrapper) and its
    bound, summed, and the device time by kernel."""
    from montgomery_tpu_torch.curves.edwards import EdwardsBatch

    N = 1 << max(MSM_LOG2N)
    c = te.default_c(N)
    P = EdwardsBatch(*[a[..., :N] for a in pts_full])
    limbs = te.scalars_to_limbs(bench_scalars(te.params.order, N))
    ed, widths = te.ed, []
    own = ed.add_packed

    def recorded(A, *rest):
        widths.append(A.shape[-1])
        return own(A, *rest)

    def run():
        widths.clear()
        return te.msm_device_full(P, limbs, c)

    out = {}
    ed.add_packed = recorded
    try:
        for label in ("new",):
            per, busy, wall, others, traced = device_times_whole(
                run, lambda r: len(r[4]) == len(widths), r"ed_add_packed_kernel")
            say_device_times(f"Twisted Edwards MSM 2^20 ({label} ed_add_packed body)", per, busy, wall, others)
            out[label] = dict(busy_ms=busy, per_kernel={k: list(v) for k, v in per.items()})
            if len(traced) != len(widths):  # a partial trace would pair launches with the wrong widths
                say(f"  ed_add_packed by launch: not measured (the profiler kept {len(traced)} of "
                    f"{len(widths)} launches in every try)")
                continue
            dev = sum(ms for _, ms in traced)
            bnd = sum(bound(te, "ed_add_packed", M, rates)[0] for M in widths)
            say(f"  ed_add_packed: {len(traced)} launches, device {dev:.4f} ms, bound summed over their "
                f"widths {bnd:.4f} ms (share {bnd / dev:.3f}); lanes " + ", ".join(
                    f"{M} {ms:.4f}" for M, (_, ms) in zip(widths, traced)))
            out[label].update(lanes=list(widths), device_ms=[ms for _, ms in traced], bound_ms=bnd)
    finally:
        del ed.add_packed
    return out


# ----------------------------------------------------------------- phase 2


def _adversarial_inputs(E, base, N: int, rng: random.Random):
    """Points with duplicates (equal scalars on (P, P) pairs, so a bucket
    doubles), negated duplicates ((P, -P) under one scalar, so it cancels),
    the zero point (infinity, or the Edwards identity), and scalars 0, 1
    and q - 1."""
    q = E.params.order
    pts = [base[(5 * i) % len(base)] for i in range(N)]
    sc = [rng.randrange(q) for _ in range(N)]
    for i in range(8, N, 4):
        pts[i + 1], sc[i + 1] = (pts[i] if i % 8 else E.neg(pts[i])), sc[i]
    pts[1] = pts[6] = type(base[0]).zero()
    sc[0] = sc[3] = 0
    sc[2], sc[4] = 1, q - 1
    return pts, sc


def phase_oracle(ctx, pts, curve: str = "bls12-377"):
    """Every engine at N = 16 and 512 on adversarial inputs against the
    bigint oracle, and serve.compute_msm(curve=curve) from ints and bytes
    with its ValueErrors; `pts` are distinct oracle points of the curve."""
    from montgomery_tpu_torch import serve
    from montgomery_tpu_torch.bigint import WeierstrassCurve, msm as oracle_msm

    say(f"== phase 2: {ctx.params.label} MSM against the bigint oracle")
    E = WeierstrassCurve(ctx.params)
    q = ctx.params.order
    rng = random.Random(2)
    base = [E.random_point(rng) for _ in range(24)]
    for N, c, first in ((16, None, "pair"), (1 << 9, 4, "super")):
        pts_adv, sc = _adversarial_inputs(E, base, N, rng)
        want = oracle_msm(E, sc, pts_adv)
        for engine, kw in (("projective", dict(affine=False)), ("affine-safe", {})):
            t0 = time.perf_counter()
            got = ctx.msm_full(sc, pts_adv, c=c, **kw)
            dt = time.perf_counter() - t0
            if not E.equal(got, want):
                raise AssertionError(f"{engine} MSM at N={N} differs from the oracle")
            note = ""
            if engine == "affine-safe":
                rounds = list(ctx.aff_adapter.rounds)
                if rounds[0][0] != first:
                    raise AssertionError(f"affine-safe MSM at N={N}: first round {rounds[0]}")
                note = f", first round {rounds[0]}"
            say(f"{engine} N={N} c={c or ctx.default_c(N)} (duplicates, negations, infinity, "
                f"zero scalars): equal to the oracle{note} ({dt:.2f} s incl. first calls)")
    # the unsafe engine's contract: distinct random points, no infinity
    for N, c, first in ((16, None, "pair"), (1 << 9, 4, "super")):
        sc = [rng.randrange(q) for _ in range(N)]
        sc[0] = sc[3] = 0
        sc[2], sc[4] = 1, q - 1
        t0 = time.perf_counter()
        got = ctx.msm_full(sc, pts[:N], c=c, affine=True, unsafe=True)
        dt = time.perf_counter() - t0
        rounds = list(ctx.aff_adapter_unsafe.rounds)
        if rounds[0][0] != first:
            raise AssertionError(f"affine MSM at N={N}: first round {rounds[0]}, expected {first}")
        if not E.equal(got, oracle_msm(E, sc, pts[:N])):
            raise AssertionError(f"affine-unsafe MSM at N={N} differs from the oracle")
        say(f"affine-unsafe N={N} c={c or ctx.default_c(N)}: equal to the oracle, first round "
            f"{rounds[0]} ({dt:.2f} s incl. first calls)")
    # serve.compute_msm on the card, from ints and from bytes
    pts_adv, sc = _adversarial_inputs(E, base, 16, rng)
    want = oracle_msm(E, sc, pts_adv)
    want = (0, 0) if want.is_zero else (want.x, want.y)
    xy = [(0, 0) if P.is_zero else (P.x, P.y) for P in pts_adv]
    nb = -(-ctx.fops.p.bit_length() // 8)
    pbytes = b"".join(x.to_bytes(nb, "little") + y.to_bytes(nb, "little") for x, y in xy)
    sbytes = b"".join((s + q if s + q < 1 << 256 else s).to_bytes(32, "little") for s in sc)
    for label, args in (("ints", (xy, sc)), ("bytes", (pbytes, sbytes))):
        if serve.compute_msm(*args, curve=curve) != want:
            raise AssertionError(f"compute_msm({curve!r}) from {label} differs from the oracle")
        say(f"serve.compute_msm({curve!r}) from {label}, N=16: equal to the oracle")
    bad_xy = list(xy)
    bad_xy[3] = (xy[3][0], (xy[3][1] + 1) % ctx.fops.p)
    for label, args, match in (("off-curve point", (bad_xy, sc), "not on curve"),
                               ("misaligned point bytes", (pbytes[:-1], sbytes), "multiple"),
                               ("misaligned scalar bytes", (pbytes, sbytes[:-1]), "multiple"),
                               ("length mismatch", (xy, sc[:-1]), "length mismatch")):
        try:
            serve.compute_msm(*args, curve=curve)
        except ValueError as e:
            if match not in str(e):
                raise AssertionError(f"compute_msm({curve!r}) on a {label}: {e}") from e
            say(f"serve.compute_msm({curve!r}) on a {label}: ValueError ({e})")
        else:
            raise AssertionError(f"compute_msm({curve!r}) accepted a {label}")


def _grid_lanes(E, rng: random.Random):
    """tests/test_grid_combine.py's two GRID_W-lane grids: empty + empty,
    empty + P, P + empty, P + P, two cancellations, then generic pairs."""
    from montgomery_tpu_torch.bigint import AffinePoint

    zero = AffinePoint.zero()
    base = [E.scale(rng.randrange(1, 1 << 62), E.generator) for _ in range(8)]
    g = [zero, zero, base[1], base[2], base[3], base[4]]
    h = [zero, base[0], zero, base[2], E.neg(base[3]), E.neg(base[4])]
    while len(g) < GRID_W:
        k = rng.randrange(1, 1 << 30)
        g.append(E.scale(k, base[len(g) % 8]))
        h.append(E.scale(k + 1, base[(len(g) + 3) % 8]))
    return g, h


def phase_planar_oracle(ctx, pts_full):
    """The planar adds (AffineOps.batch_add, batch_add_unsafe) against the
    bigint oracle: tests/test_curve_ops.py's lanes with the order-2 point T
    = (p - 1, 0) (T + T, T + Q); the unsafe add on distinct points, and
    masked with one doubling lane excluded and passed through; the 640-lane
    grids of tests/test_grid_combine.py, safe and masked; then at 2^20 lanes
    on the bench points (H = the points 12,345 lanes on, with a doubling, a
    cancellation and infinite operands planted in the first lanes) with
    PLANAR_SAMPLE lanes against the oracle, each add's launch counts from a
    run with the counts set to 0 just before it, and the median of 3.
    Returns the two runs' launch counts."""
    import statistics

    import torch

    from montgomery_tpu_torch.bigint import AffinePoint, WeierstrassCurve
    from montgomery_tpu_torch.curves.projective import AffineBatch

    say("== phase 2: planar batched-affine adds against the bigint oracle")
    E = WeierstrassCurve(ctx.params)
    aff, dev, f = ctx.affine, ctx.device, ctx.fops
    rng = random.Random(4)

    def check(label, out, want):
        got = ctx.proj.affine_to_host(out)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if not E.equal(g, w)]
        if bad or len(got) != len(want):
            raise AssertionError(f"{label}: lanes {bad[:8]} differ from the oracle")
        say(f"{label}: {len(want)} lanes equal to the oracle")

    P, Q, R, S, *rest = [E.random_point(rng) for _ in range(8)]
    Z0, T = AffinePoint.zero(), AffinePoint(f.p - 1, 0)
    lhs, rhs = [P, Q, P, P, Z0, P, Z0, R, T, T, Q], [Q, R, P, E.neg(P), Q, Z0, Z0, S, T, Q, T]
    G, H = ctx.affine_to_device(lhs), ctx.affine_to_device(rhs)
    check("batch_add on test_curve_ops' lanes", aff.batch_add(G, H), [E.add(a, b) for a, b in zip(lhs, rhs)])
    ul, ur = [P, Q, R, S, P], rest + [P]
    UG, UH = ctx.affine_to_device(ul), ctx.affine_to_device(ur)
    keep = torch.tensor([True] * 4 + [False], device=dev)
    sums = [E.add(a, b) for a, b in zip(ul, ur)]
    check("batch_add_unsafe on distinct points", aff.batch_add_unsafe(*[AffineBatch(*[a[..., :4] for a in B])
                                                                        for B in (UG, UH)]), sums[:4])
    check("batch_add_unsafe masked (P + P excluded, passed through)",
          aff.select(keep, aff.batch_add_unsafe(UG, UH, valid=keep), UG), sums[:4] + [P])

    g, h = _grid_lanes(E, rng)
    G, H = ctx.affine_to_device(g), ctx.affine_to_device(h)
    sums = [E.add(a, b) for a, b in zip(g, h)]
    check(f"batch_add on the {GRID_W}-lane grid", aff.batch_add(G, H), sums)
    valid = torch.ones(GRID_W, dtype=torch.bool, device=dev)
    valid[:6] = False
    check(f"batch_add_unsafe masked on the {GRID_W}-lane grid (hazard lanes passed through)",
          aff.select(valid, aff.batch_add_unsafe(G, H, valid=valid), G), g[:6] + sums[6:])

    N = pts_full.count
    G = pts_full
    shift = (torch.arange(N, device=dev) + 12345) % N
    H = AffineBatch(*[a.index_select(a.dim() - 1, shift) for a in G])
    hx, hy, hinf = H.x.clone(), H.y.clone(), H.inf.clone()
    hx[:, 0], hy[:, 0] = G.x[:, 0], G.y[:, 0]  # doubling
    hx[:, 1], hy[:, 1] = G.x[:, 1], f.neg(G.y[:, 1:2])[:, 0]  # cancellation
    ginf = G.inf.clone()
    ginf[2] = ginf[4] = True  # G infinite; both infinite
    hinf[3] = hinf[4] = True  # H infinite
    G, H = AffineBatch(G.x, G.y, ginf), AffineBatch(hx, hy, hinf)
    lanes = sorted({*range(8), *random.Random(9).sample(range(N), PLANAR_SAMPLE - 8)})
    sel = torch.tensor(lanes, device=dev)

    def sampled(B):
        return AffineBatch(*[a.index_select(a.dim() - 1, sel) for a in B])

    hg, hh = (ctx.proj.affine_to_host(sampled(B)) for B in (G, H))
    valid = torch.rand(N, device=dev, generator=torch.Generator(device=dev).manual_seed(8)) < 0.9
    valid[:5] = False  # the planted hazard lanes
    runs = {"planar_safe": (lambda: aff.batch_add(G, H), [E.add(a, b) for a, b in zip(hg, hh)]),
            "planar_unsafe": (lambda: aff.select(valid, aff.batch_add_unsafe(G, H, valid=valid), G),
                              [E.add(a, b) if v else a for a, b, v in zip(hg, hh, valid[sel].tolist())])}
    launches = {}
    for path, (run, want) in runs.items():
        counts, first, out = counted(run, path)
        check(f"{path} at {N} lanes ({len(lanes)} sampled, hazards in the first lanes)", sampled(out), want)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        say(f"{path} launches: {counts}; median {statistics.median(times):.6f} s over 3 runs "
            f"{['%.6f' % t for t in times]} (first run {first:.3f} s)")
        launches[f"{path}_2^{N.bit_length() - 1}"] = counts
    return launches


def phase_sharded(ctx, te, pts_full, te_full, host_pts, expected) -> dict:
    """msm_full_sharded on logical meshes of D = 1, 2, 4 and 8 shards on the
    one card, every engine: at SHARD_ORACLE_N points (c = 4) against the
    bigint oracle, with a zero scalar and one point under one scalar in two
    shards (the unsafe engine at D = 1 on distinct points: one shard would
    hold the duplicate, against its contract); at 2^16 and 2^20 on the bench
    points and scalars against the closed form and the single-device
    engine's result, launch counts at D = 8 and 2^20, and the median of 3 at
    2^20 (logical shards on one card: the shards run one after another, so
    the times are no scaling evidence); then msm_sharded with the Twisted
    Edwards adapter at D = 2 and 2^16 against the closed form. Returns the
    counted runs' launch counts."""
    from montgomery_tpu_torch.bigint import WeierstrassCurve, msm as oracle_msm
    from montgomery_tpu_torch.curves.projective import AffineBatch
    from montgomery_tpu_torch.parallel import make_mesh, msm_full_sharded, msm_sharded, shard_points
    from montgomery_tpu_torch.utils.timing import timeit

    dev = ctx.device
    E, q = WeierstrassCurve(ctx.params), ctx.params.order
    meshes = {D: make_mesh(D, devices=[dev] * D) for D in SHARD_D}
    engines = {"affine_safe": dict(affine=True), "affine_unsafe": dict(affine=True, unsafe=True),
               "projective": dict(affine=False)}
    say(f"== phase 5: msm_full_sharded on logical meshes of {list(SHARD_D)} shards on one card")
    N, c = SHARD_ORACLE_N, 4
    rng = random.Random(6)
    pts = host_pts[:N]
    sc = [rng.randrange(q) for _ in range(N)]
    sc[0] = 0
    dup, dsc = list(pts), list(sc)
    dup[N // 2 + 1], dsc[N // 2 + 1] = pts[1], sc[1]
    cases = {"hazards": (dup, dsc, oracle_msm(E, dsc, dup)), "distinct": (pts, sc, oracle_msm(E, sc, pts))}
    for D, mesh in meshes.items():
        for engine, kw in engines.items():
            case = "distinct" if D == 1 and engine == "affine_unsafe" else "hazards"
            p_, s_, want = cases[case]
            A, L = shard_points(ctx.affine_to_device(p_), ctx.scalars_to_limbs(s_), mesh)
            got = ctx.proj.to_host(msm_full_sharded(ctx, A, L, c, mesh, **kw))[0]
            if not E.equal(got, want):
                raise AssertionError(f"msm_full_sharded {engine} D={D} N={N} differs from the oracle")
        say(f"D={D}: msm_full_sharded at N={N}, c={c}, every engine: equal to the oracle "
            f"(zero scalar; point 1 and its scalar again at {N // 2 + 1})")
    launches = {}
    top = max(MSM_LOG2N)
    for log2n in MSM_LOG2N:
        N = 1 << log2n
        c = ctx.default_c(N)
        A = AffineBatch(*[a[..., :N] for a in pts_full])
        limbs = ctx.scalars_to_limbs(bench_scalars(q, N))
        want = expected_sum(expected, ctx.params, N, pts_full.count)
        for engine, kw in engines.items():
            single = ctx.proj.to_host(ctx.msm_device_full(A, limbs, c, **kw))[0]
            if not E.equal(single, want):
                raise AssertionError(f"single-device {engine} at N=2^{log2n} differs from the closed form")
            for D, mesh in meshes.items():
                As, Ls = shard_points(A, limbs, mesh)

                def run(As=As, Ls=Ls, mesh=mesh, kw=kw):
                    return msm_full_sharded(ctx, As, Ls, c, mesh, **kw)

                if log2n == top and D == max(SHARD_D):
                    counts, _, S = counted(run, engine)
                    launches[f"sharded_{engine}_D{D}_2^{log2n}"] = counts
                else:
                    S = run()
                got = ctx.proj.to_host(S)[0]
                if not (E.equal(got, want) and E.equal(got, single)):
                    raise AssertionError(f"msm_full_sharded {engine} D={D} at N=2^{log2n} differs")
                note = ""
                if log2n == top:
                    med, times = timeit(run, device=dev, reps=3, warmup=1)
                    note = f"; median {med:.6f} s over 3 runs {['%.6f' % t for t in times]}"
                say(f"msm_full_sharded {engine} D={D} N=2^{log2n} c={c}: equal to the closed form "
                    f"and the single-device engine{note}")
    say("(times of logical shards on one card: the shards run one after another; no scaling evidence)")
    N = 1 << min(MSM_LOG2N)
    c = te.default_c(N)
    P = type(te_full)(*[a[..., :N] for a in te_full])
    digits = te.digits_device(te.scalars_to_limbs(bench_scalars(te.params.order, N)), c)
    mesh = meshes[2]
    Ps, ds = shard_points(P, digits, mesh)
    counts, secs, got = counted(lambda: te.ed.to_host(msm_sharded(te.adapter, Ps, ds, c, mesh)), "te",
                                te.fops.n)
    if not oracle_curve(te.params).equal(got[0], expected_sum(expected, te.params, N, te_full.count)):
        raise AssertionError(f"msm_sharded (Twisted Edwards) D=2 N=2^{min(MSM_LOG2N)} differs")
    say(f"msm_sharded Twisted Edwards D=2 N={N} c={c}: equal to the closed form ({secs:.3f} s)")
    launches[f"te_sharded_D2_2^{min(MSM_LOG2N)}"] = counts
    return launches


# ----------------------------------------------------------------- phase 3


def oracle_curve(params):
    from montgomery_tpu_torch.bigint import EdwardsParams, TwistedEdwardsCurve, WeierstrassCurve

    return TwistedEdwardsCurve(params) if isinstance(params, EdwardsParams) else WeierstrassCurve(params)


def closed_form(params, scalars, seed: int, n_drawn: int):
    """sum_t (sum_i s_i (idx[t, i] + 3) mod q) B_t with Python ints, for the
    first len(scalars) of n_drawn points of random_points_fast(seed) or
    random_points_fast_edwards(seed)."""
    from montgomery_tpu_torch.curves.random import table_bases, table_indices

    E = oracle_curve(params)
    q = params.order
    idx = table_indices(seed, n_drawn)[:, :len(scalars)]
    acc = E.scale(0, E.generator)
    for t, B in enumerate(table_bases(params, seed)):
        per = [0] * 512
        for s, j in zip(scalars, idx[t].tolist()):
            per[j] += s
        coef = sum(v * (j + 3) for j, v in enumerate(per)) % q
        acc = E.add(acc, E.scale(coef, B))
    return acc


def expected_sum(expected: dict, params, N: int, n_drawn: int):
    """The closed form of the bench scalars' MSM on the first N of n_drawn
    bench points, computed once per curve and N."""
    key = (params.label, N)
    if key not in expected:
        expected[key] = closed_form(params, bench_scalars(params.order, N), SEED_POINTS, n_drawn)
    return expected[key]


def bench_scalars(q: int, N: int) -> list[int]:
    import numpy as np

    raw = np.random.default_rng(SEED_SCALARS).integers(0, 256, size=N * 32, dtype=np.uint8).tobytes()
    return [int.from_bytes(raw[32 * i: 32 * (i + 1)], "little") % q for i in range(N)]


def counted(fn, path: str, limbs: int = 12, kernels_of: set | None = None):
    """Run fn once with every launch count set to 0 just before it; check
    that each kernel of `path` (or of `kernels_of`) launched, none of its
    forbidden ones did, and every launch was at `limbs` limbs (glv_digits,
    which has no limb count, aside). Returns (counts, seconds, result)."""
    import torch

    from montgomery_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    missing = [k for k in (PATH_KERNELS[path] if kernels_of is None else kernels_of) if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} were not launched on the {path} path")
    stray = [k for k in PATH_FORBIDDEN[path] if counts.get(k)]
    if stray:
        raise AssertionError(f"kernels {stray} were launched on the {path} path")
    by_n = kernels.launch_counts_by_n()
    wrong = {k: v for k, v in by_n.items() if set(v) - {limbs, None}}
    if wrong:
        raise AssertionError(f"launches at another limb count than {limbs} on the {path} path: {wrong}")
    say(f"{path} launches by limb count: {by_n}")
    return counts, seconds, out


def phase_msm(ctx, log2n: int, pts_full, path: str, expected: dict, profile: bool | None = None):
    """One path at N = 2^log2n: launch counts of a run with the counts set
    to 0 just before it (every launch at the curve's limb count), the full-N
    check, 5 timed runs, peak memory and the phase split; with `profile`
    (by default on the main path: affine-unsafe at the largest size), its
    device time by kernel. Returns the launch counts."""
    import torch

    from montgomery_tpu_torch.bigint import WeierstrassCurve
    from montgomery_tpu_torch.curves.projective import AffineBatch
    from montgomery_tpu_torch.utils.timing import timeit

    N = 1 << log2n
    c = ctx.default_c(N)
    K = ctx.glv_dev.num_windows(c)
    affine, unsafe = path != "projective", path == "affine_unsafe"
    adapter = ctx.aff_adapter_unsafe if unsafe else ctx.aff_adapter
    say(f"== phase 3: {ctx.params.label} MSM N=2^{log2n}, c={c}, K={K} (GLV halves), path {path}, "
        f"n={ctx.fops.n} limbs of 32 bits")
    A = AffineBatch(*[a[..., :N] for a in pts_full])
    scalars = bench_scalars(ctx.params.order, N)
    limbs = ctx.scalars_to_limbs(scalars)
    dev = ctx.device

    def run():
        return ctx.msm_device_full(A, limbs, c, affine=affine, unsafe=unsafe)

    counts, first, S = counted(run, path, ctx.fops.n)
    say(f"{path} launches: {counts} (first run {first:.3f} s)")
    main = path == PATHS[0] and log2n == max(MSM_LOG2N)
    if main and ctx.fops.n == 12:
        wrong = {k: (counts[k], v) for k, v in MAIN_PATH_LAUNCHES.items() if counts[k] != v}
        if wrong:
            raise AssertionError(f"main path launches (got, expected): {wrong}")
    if affine:
        say(f"rounds: {adapter.rounds}")
    got = ctx.proj.to_host(S)[0]
    E = WeierstrassCurve(ctx.params)
    t0 = time.perf_counter()
    if got.is_zero or not E.equal(got, expected_sum(expected, ctx.params, N, pts_full.count)):
        raise AssertionError(f"{path} MSM at N=2^{log2n} differs from the closed form")
    say(f"full-N check: equal to the closed form ({time.perf_counter() - t0:.1f} s on the host)")

    med, times = timeit(run, device=dev, reps=5, warmup=1)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    _, log = ctx.msm_phases(A, limbs, c, affine=affine, unsafe=unsafe)
    say(f"msm {path} N=2^{log2n}: median {med:.6f} s over 5 runs {['%.6f' % t for t in times]}; "
        f"peak memory {peak / 2**20:.1f} MiB")
    say("phase split:\n" + log.report())
    if (main if profile is None else profile):  # where its device time goes
        expect = {k: counts[k] for k in MAIN_PATH_LAUNCHES}
        profile_main_path(ctx, run, f"profiled {ctx.params.label} {path} N=2^{log2n}", expect)
    return counts


def profile_main_path(ctx, run, label: str, expect: dict) -> None:
    """The main path's device time by kernel (`device_times`; profiled
    again until the trace holds `expect`'s launches of each kernel in it),
    and each proj_add_rcb launch's device time beside its lane count and
    body (the lane counts recorded by a wrapper around ProjectiveOps.add for
    the profiled run alone)."""
    proj, lanes = ctx.proj, []
    add = proj.add

    def recording_add(P, Q, **kw):
        lanes.append(P.X[0].numel())
        return add(P, Q, **kw)

    def traced():
        lanes.clear()
        return run()

    proj.add = recording_add
    try:
        per, busy, wall, others, adds = device_times_whole(
            traced, lambda r: len(r[4]) == len(lanes) and all(r[0].get(k, (0,))[0] == v
                                                             for k, v in expect.items()),
            r"proj_add_rcb(_few)?_kernel")
    finally:
        del proj.add
    say_device_times(label, per, busy, wall, others)
    if len(adds) != len(lanes):
        say(f"proj_add_rcb by launch: not measured ({len(adds)} traced launches, {len(lanes)} adds)")
        return
    say(f"proj_add_rcb by launch on the main path (lanes, body: device us), FEW_ADD_LANES "
        f"{proj.FEW_ADD_LANES}:")
    rows, by_body = [], {}
    for N, (name, ms) in zip(lanes, adds):
        body = "few" if "_few_" in name else "six"
        rows.append(f"{N}, {body}: {ms * 1e3:.2f}")
        c, t = by_body.get(body, (0, 0.0))
        by_body[body] = (c + 1, t + ms)
    for i in range(0, len(rows), 6):
        say("  " + "; ".join(rows[i:i + 6]))
    say("  by body (launches, device ms): " + ", ".join(f"{b} {c}, {t:.4f}" for b, (c, t) in by_body.items()))


def phase_ab(ctx, pts_full, log2n: int, turns: int = 5):
    """The unsafe and the safe add on the same inputs at N = 2^log2n, timed
    in turns (unsafe, safe, safe, unsafe) so that drift on the card falls on
    both; prints each one's median of 2 * turns runs."""
    import statistics

    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch

    N = 1 << log2n
    c = ctx.default_c(N)
    A = AffineBatch(*[a[..., :N] for a in pts_full])
    limbs = ctx.scalars_to_limbs(bench_scalars(ctx.params.order, N))
    times = {True: [], False: []}
    for _ in range(turns):
        for unsafe in (True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx.msm_device_full(A, limbs, c, affine=True, unsafe=unsafe)
            torch.cuda.synchronize()
            times[unsafe].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in times.items()}
    say(f"== phase 3: unsafe vs safe add at N=2^{log2n}, in turns: median unsafe {med[True]:.6f} s, "
        f"safe {med[False]:.6f} s (safe / unsafe {med[False] / med[True]:.3f}); "
        f"unsafe {['%.6f' % t for t in times[True]]}, safe {['%.6f' % t for t in times[False]]}")


def phase_adversarial(ctx, pts_full, log2n: int = 16, log2base: int = 12):
    """The safe engine at N = 2^log2n on 2^log2base bench points, each used
    2^(log2n - log2base) times under one scalar: copy k of point j is
    negated where (j + k) % 5 == 1 and infinite where (j + k) % 7 == 3, and
    point j's scalar is 0 where j % 11 == 0. Equal to the projective engine
    and to the closed form with point j's coefficient sum_k sign_k s_j."""
    import torch

    from montgomery_tpu_torch.bigint import WeierstrassCurve
    from montgomery_tpu_torch.curves.projective import AffineBatch

    N, nb = 1 << log2n, 1 << log2base
    c = ctx.default_c(N)
    q = ctx.params.order
    say(f"== phase 3: adversarial safe MSM N=2^{log2n} on 2^{log2base} bench points, c={c}")
    f, dev = ctx.fops, ctx.device
    base = bench_scalars(q, nb)
    base = [0 if j % 11 == 0 else s for j, s in enumerate(base)]
    j = torch.arange(N, device=dev) % nb
    k = torch.arange(N, device=dev) // nb
    neg = (j + k) % 5 == 1
    inf = (j + k) % 7 == 3
    x, y = pts_full.x.index_select(1, j), pts_full.y.index_select(1, j)
    y = torch.where(neg[None], f.neg(y), y)
    zero = torch.zeros_like(x)
    A = AffineBatch(torch.where(inf[None], zero, x), torch.where(inf[None], zero, y), inf)
    scalars = [base[i % nb] for i in range(N)]
    sign = torch.where(inf, 0, torch.where(neg, -1, 1)).cpu().tolist()
    coef = [0] * nb
    for i, sg in enumerate(sign):
        coef[i % nb] += sg
    limbs = ctx.scalars_to_limbs(scalars)
    counts, first, S = counted(lambda: ctx.msm_device_full(A, limbs, c, affine=True), "affine_safe")
    say(f"affine_safe adversarial launches: {counts} (first run {first:.3f} s); rounds "
        f"{ctx.aff_adapter.rounds}")
    E = WeierstrassCurve(ctx.params)
    got = ctx.proj.to_host(S)[0]
    want = closed_form(ctx.params, [s * cf % q for s, cf in zip(base, coef)], SEED_POINTS,
                       pts_full.count)
    proj = ctx.proj.to_host(ctx.msm_device_full(A, limbs, c, affine=False))[0]
    if not (E.equal(got, want) and E.equal(proj, want)):
        raise AssertionError("adversarial safe MSM differs from the closed form or the projective engine")
    say(f"adversarial safe MSM: equal to the closed form and to the projective engine "
        f"({sum(neg.tolist())} negated, {sum(inf.tolist())} infinite, "
        f"{sum(1 for s in base if s == 0)} of {nb} scalars 0)")


def phase_serve(ctx, pts_full, log2n: int, expected: dict, curve: str = "bls12-377",
                path: str = "serve"):
    """serve.compute_msm(curve=curve) at N = 2^log2n from packed bytes with
    the on-curve check, against the closed form; ingestion and the on-curve
    check timed apart, then the whole call with its launch counts (checked
    against `path`'s kernels)."""
    import numpy as np
    import torch

    from montgomery_tpu_torch import serve

    N = 1 << log2n
    say(f"== phase 3: serve.compute_msm(curve={curve!r}) N=2^{log2n} from packed bytes, "
        f"validate=True")
    f = ctx.fops
    # canonical coordinates of the bench points as little-endian bytes: the
    # first ceil(bits(p) / 32) words of each (12 of 12 limbs, 8 of 9)
    nw = -(-f.p.bit_length() // 32)
    xy = [np.ascontiguousarray(f.from_montgomery(a[:, :N]).cpu().numpy().T)[:, :nw].view("<u4")
          for a in pts_full[:2]]
    pbytes = np.concatenate(xy, axis=1).tobytes()
    raw = np.random.default_rng(SEED_SCALARS).integers(0, 256, size=N * 32, dtype=np.uint8)
    sbytes = raw.tobytes()  # unreduced: compute_msm reduces mod q, as bench_scalars does
    sctx = serve.get_curve(curve)
    t0 = time.perf_counter()
    batch = serve._points_to_batch(sctx, pbytes)
    sctx.scalars_to_limbs(sbytes)
    torch.cuda.synchronize()
    t_in = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = bool(sctx.is_on_curve(batch).all())
    t_chk = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"{curve} bench points failed the on-curve check")
    counts, t_all, got = counted(lambda: serve.compute_msm(pbytes, sbytes, curve=curve), path, f.n)
    say(f"{path} launches: {counts}")
    want = expected_sum(expected, ctx.params, N, pts_full.count)
    if got != (want.x, want.y):
        raise AssertionError(f"compute_msm({curve!r}) at full N differs from the closed form")
    say(f"compute_msm({curve!r}) N=2^{log2n}: equal to the closed form; host ingestion "
        f"{t_in:.3f} s, on-curve check {t_chk:.4f} s, whole call {t_all:.3f} s")
    return counts


# ------------------------------------------------- Twisted Edwards phases

# classes of the Edwards adds' first lanes; an "unreduced" lane holds the
# representatives v + p of its coordinates
TE_CLASSES = ("ordinary", "double", "minus", "id_a", "id_b", "id_both", "unreduced",
              "double_unreduced")


def _te_flag_lanes(te, pts, K: int, rng: random.Random):
    """K packed columns A and B [X | Y | Z | T] (Montgomery form, a random Z
    a lane) and their sign and pair planes on the card: lane i of class
    TE_CLASSES[i % 8], with (sA, sB, hp) running through all 8 combinations
    over the cycles."""
    import torch

    from montgomery_tpu_torch.bigint import EdwardsPoint

    f = te.fops
    p, R = f.p, f.R
    cols = [[] for _ in range(8)]
    sa, sb, hp = [], [], []
    for i in range(K):
        cls = TE_CLASSES[i % len(TE_CLASSES)]
        a, b = pts[i % len(pts)], pts[(7 * i + 3) % len(pts)]
        if cls.startswith("double"):
            b = a
        elif cls == "minus":
            b = EdwardsPoint((-a.x) % p, a.y)
        if cls in ("id_a", "id_both"):
            a = EdwardsPoint.zero()
        if cls in ("id_b", "id_both"):
            b = EdwardsPoint.zero()
        up = p if cls.endswith("unreduced") else 0
        for side, pt in enumerate((a, b)):
            z = rng.randrange(1, p)
            for k, v in enumerate((pt.x * z, pt.y * z, z, pt.x * pt.y * z)):
                cols[4 * side + k].append(v % p * R % p + up)
        j = i // len(TE_CLASSES)
        sa.append(j & 1)
        sb.append((j >> 1) & 1)
        hp.append(1 - ((j >> 2) & 1))
    dev = te.device

    def rows(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    A = torch.cat([f.pack_raw(c, dev) for c in cols[:4]])
    B = torch.cat([f.pack_raw(c, dev) for c in cols[4:]])
    return A, B, rows(sa), rows(sb), rows(hp)


def phase_te_kernels(te, pts, rates: dict) -> dict:
    """The Twisted Edwards path's kernels against their plain versions on
    the same tensors: the 9-limb mont_mul, mul_const (by R^2 and by 2d) and
    divstep_inv_mont at 2^16, 2^16 + 17 and 512 lanes; ed_add at 2^16,
    2^16 + 17 and the 2^20 path's first bucket-reduction level (K L / 2
    lanes); ed_dbl with k = 1 and 13, and k = 208 on 16 lanes (the 2^20
    combine's first level); ed_add_packed at 2^16, 2^16 + 17 and the first
    super-round level at 2^16 and 2^20 points, and its halves. The first
    lanes hold the classes of `_te_flag_lanes` (oracle points `pts`), the
    field kernels' first lanes 0, 1, p - 1, [p, 2p) and R mod p. The field
    kernels are also checked at the widths compute_msm's 2^20 ingestion
    gives them: mont_mul at 2^20 lanes (T = x y), mul_const at 2^21 (both
    coordinates to Montgomery form). Each is timed on the tensors it was
    checked on: mont_mul at 2^20 lanes, mul_const at 2^21, divstep_inv_mont
    at 512, ed_add and ed_dbl (k = 1) at 2^16 (like proj_add_rcb and
    proj_dbl_rcb), ed_add_packed at the 2^16 path's first level. The planar
    kernels get contiguous planes, as their wrappers hand them to the
    kernel (a strided view is copied first)."""
    import torch

    from montgomery_tpu_torch.curves.edwards import EdwardsBatch
    from montgomery_tpu_torch.ops import divstep

    say("== phase 1: Twisted Edwards kernels (9 limbs) against their plain versions")
    f, ed, dev = te.fops, te.ed, te.device
    n = f.n
    gen = torch.Generator(device=dev).manual_seed(5)
    rng = random.Random(6)
    p = f.p
    adv = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p, f.R2]
    results = {}

    def diff(a, b):
        return int((a - b).abs().max()) if a.numel() else 0

    def canon_err(a, b):
        return diff(_canon(f, a), _canon(f, b))

    def point_err(a, b):  # EdwardsBatch or packed rows: canonical, coordinate by coordinate
        a = a if isinstance(a, EdwardsBatch) else ed.unpack_rows(a)
        b = b if isinstance(b, EdwardsBatch) else ed.unpack_rows(b)
        return max(canon_err(u, v) for u, v in zip(a, b))

    c20 = te.default_c(1 << 20)
    red20 = te.num_windows(c20) * (1 << (c20 - 1)) // 2
    W16, W20 = first_level_width(te, 16), first_level_width(te, 20)
    field = {"divstep_inv_mont", "mont_mul", "mul_const"}
    plan = ((KERNEL_LANES[0], field | {"ed_add", "ed_dbl", "ed_add_packed"}, {"ed_add", "ed_dbl"}),
            (KERNEL_LANES[1], field | {"ed_add", "ed_dbl", "ed_add_packed"}, set()),
            (ROOT_LANES, {"divstep_inv_mont"}, {"divstep_inv_mont"}),
            (1 << 20, {"mont_mul"}, {"mont_mul"}), (1 << 21, {"mul_const"}, {"mul_const"}),
            (red20, {"ed_add"}, set()), (16, {"ed_dbl_combine"}, set()),
            (W16, {"ed_add_packed"}, {"ed_add_packed"}), (W20, {"ed_add_packed"}, set()))
    for M, names, timed in plan:
        cases = {}
        if names & field:
            x, y = _field_plane(f, M, gen, adv), _field_plane(f, M, gen, adv[::-1])
        if "divstep_inv_mont" in names:
            cases["divstep_inv_mont"] = (min(M, ROOT_LANES), lambda x=x: f.inv_root(x[:, :ROOT_LANES]),
                                         lambda x=x: divstep.inv_mont_plain(f, x[:, :ROOT_LANES]),
                                         lambda a, b: _raw_err([a], [b]))  # bit for bit
        if "mont_mul" in names:
            xs = x[:, 3:]  # a column slice
            cases["mont_mul"] = (M, lambda: f.mul(x, y), lambda: f.mul_plain(x, y), canon_err)
            cases["mont_mul slice"] = (M - 3, lambda: f.mul(xs, y[:, :-3]),
                                       lambda: f.mul_plain(xs, y[:, :-3]), canon_err)
        if "mul_const" in names:
            for tag, cst in (("", f.R2), (" 2d", ed.k_mont)):
                cases["mul_const" + tag] = (M, lambda c=cst: f.mul_const(x, c),
                                            lambda c=cst: f.mul_const_plain(x, c), canon_err)
        if names & {"ed_add", "ed_dbl", "ed_add_packed", "ed_dbl_combine"}:
            C = _random_planes(f, 4 * n, 2 * M, gen)
            sg = torch.randint(0, 2, (1, 2 * M), dtype=torch.int32, device=dev, generator=gen)
            hp = torch.randint(0, 2, (1, M), dtype=torch.int32, device=dev, generator=gen)
            K = min(M, 1200)
            FA, FB, fsa, fsb, fhp = _te_flag_lanes(te, pts, K, rng)
            C[:, :K], C[:, M:M + K] = FA, FB
            sg[:, :K], sg[:, M:M + K], hp[:, :K] = fsa, fsb, fhp
            A, B = C[:, :M], C[:, M:]  # a level's two halves
            sA, sB = sg[:, :M], sg[:, M:]
            PA, PB = (EdwardsBatch(*[a.contiguous() for a in ed.unpack_rows(t)]) for t in (A, B))
        if "ed_add" in names:
            cases["ed_add"] = (M, lambda: ed.add(PA, PB), lambda: ed.add_plain(PA, PB), point_err)
        if "ed_dbl" in names:
            for k in (1, 13):
                cases[f"ed_dbl k={k}"] = (M, lambda k=k: ed.double_n(PA, k),
                                          lambda k=k: ed.double_n_plain(PA, k), point_err)
        if "ed_dbl_combine" in names:
            cases[f"ed_dbl k={TE_COMBINE_K}"] = (M, lambda: ed.double_n(PA, TE_COMBINE_K),
                                                lambda: ed.double_n_plain(PA, TE_COMBINE_K),
                                                point_err)
        if "ed_add_packed" in names:
            h = M // 2
            for tag, ops in (("", (A, B, sA, sB, hp)),
                             (" halves", (A[:, :h], B[:, :h], sA[:, :h], sB[:, :h], hp[:, :h]))):
                cases["ed_add_packed" + tag] = (ops[0].shape[-1], lambda o=ops: ed.add_packed(*o),
                                                lambda o=ops: ed.add_packed_plain(*o), point_err)
        for label, (lanes, kern, plain, err_of) in cases.items():
            err = err_of(kern(), plain())
            say(f"{label} n={n} N={lanes}: max_abs_err {err}")
            if err:
                raise AssertionError(f"{label} at {n} limbs and {lanes} lanes disagrees with its "
                                     f"plain version")
            name = label.split()[0]
            r = results.setdefault(name, {"max_abs_err": 0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if label in timed or label == "ed_dbl k=1" and "ed_dbl" in timed:
                r.update(ms=cuda_time_ms(kern, KERNEL_REPS), plain_ms=cuda_time_ms(plain, 3, 1),
                         lanes=lanes)
                if name == "divstep_inv_mont":
                    r["batches"] = divstep_batches(f, x[:, :ROOT_LANES])[0]
            elif label == "ed_add_packed" and M == W20:  # the kernel alone at the 2^20 level
                r["ms_2^20_level"] = cuda_time_ms(kern, 20)
                r["bound_ms_2^20_level"] = bound(te, name, lanes, rates)[0]
                say(f"ed_add_packed at the 2^20 path's first level ({lanes} lanes): kernel "
                    f"{r['ms_2^20_level']:.4f} ms, bound {r['bound_ms_2^20_level']:.4f} ms")
        del cases
        torch.cuda.empty_cache()
    for name, r in results.items():
        r["bound_ms"], r["bound_by"] = bound(te, name, r["lanes"], rates, r.get("batches"))
        say(f"{name} (n={n}): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) per call at {r['lanes']} lanes")
    return results


def _te_windows(te, pts, K: int, rng: random.Random, lanes: int = 1):
    """K Twisted Edwards window sums of `lanes` combines as planes
    (n, lanes, K) on the card: oracle points `pts` in extended coordinates
    (x z : y z : z : x y z) with random z, a coordinate in 4 unreduced (+p),
    and the identity (0 : 1 : 1 : 0) (times z) in two windows of each lane (the
    top one among them in about half the lanes); returns (planes, the points
    on the host, lane by lane)."""
    from montgomery_tpu_torch.bigint import EdwardsPoint
    from montgomery_tpu_torch.curves.edwards import EdwardsBatch

    f = te.fops
    p, R = f.p, f.R
    cols, host = ([], [], [], []), []
    for i in range(lanes * K):
        if i % K == 0:
            ident = {rng.randrange(K), K - 1 if rng.random() < 0.5 else rng.randrange(K)}
        pt = EdwardsPoint.zero() if i % K in ident else pts[rng.randrange(len(pts))]
        z = rng.randrange(1, p)
        for col, v in zip(cols, (pt.x * z, pt.y * z, z, pt.x * pt.y % p * z)):
            col.append(v % p * R % p + (p if rng.random() < 0.25 else 0))
        host.append(pt)
    W = EdwardsBatch(*[f.pack_raw(col, te.device).reshape(f.n, lanes, K) for col in cols])
    return W, host


class HalvingCombine:
    """An adapter without `combine`: `combine_windows` then takes the halving
    combine (one ed_dbl launch and one ed_add a level), the Twisted Edwards
    path as it ran before ed_combine."""

    def __init__(self, adapter):
        self._adapter = adapter

    def __getattr__(self, name):
        if name == "combine":
            raise AttributeError(name)
        return getattr(self._adapter, name)


def redesign_te_combine(te, pts, rates: dict) -> dict:
    """The Twisted Edwards window combine ed_combine at the TE paths' shapes,
    (K, c) = TE_COMBINE_CASES, one launch on one lane for each of
    REDESIGN_REPS fresh inputs (`_te_windows`: identity windows, unreduced
    values): bit for bit against the plain Horner (`combine_plain`, one run
    over all the inputs), as affine points against the halving combine it
    replaced (`combine_halving`: ed_dbl and ed_add a level) and, for the
    first input, against Python's ints. Timed beside the halving combine:
    CUDA events and the profiler's device ms with the host ms of the same
    run; the plain Horner's host time over all the inputs at once; the bound
    (its multiplies on one lane) and the dependent-chain floor,
    3 (K - 1)(c + 1) warp products x the latency of one at 9 limbs (phase
    0). Returns ed_combine's row (the main path's shape first, both
    under "main_path")."""
    import torch

    from montgomery_tpu_torch.bigint import EdwardsPoint
    from montgomery_tpu_torch.curves.edwards import ADD_MULS, EdwardsBatch
    from montgomery_tpu_torch.msm.pippenger import combine_halving

    say("== phase 1: the Twisted Edwards window combine at the TE paths' shapes")
    f, ed = te.fops, te.ed
    n, W = f.n, 4 * f.n
    E = oracle_curve(te.params)
    rng = random.Random(13)
    rows = {}
    for K, c in TE_COMBINE_CASES:
        Wall, host = _te_windows(te, pts, K, rng, lanes=REDESIGN_REPS)
        t0 = time.perf_counter()  # the plain version's time: all the inputs in one run (launch-bound)
        want = ed.combine_plain(Wall, c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = 0
        for rep in range(REDESIGN_REPS):
            Wk = EdwardsBatch(*[a[:, rep:rep + 1].contiguous() for a in Wall])
            got = ed.combine(Wk, c)
            err = max(err, _raw_err(got, EdwardsBatch(*[a[:, rep:rep + 1] for a in want])))
            flat = EdwardsBatch(*[a.reshape(n, K) for a in Wk])
            halving = combine_halving(te.adapter, flat, c, K)
            a = ed.to_host(EdwardsBatch(*[v.reshape(n, 1) for v in got]))[0]
            b = ed.to_host(halving)[0]
            if err or not E.equal(a, b):
                raise AssertionError(f"ed_combine K={K} c={c} disagrees (rep {rep}, raw err {err})")
            if rep == 0:
                expect = EdwardsPoint.zero()
                for k, pt in enumerate(host[:K]):
                    expect = E.add(expect, E.scale(1 << (c * k), pt))
                if not E.equal(a, expect):
                    raise AssertionError(f"ed_combine K={K} c={c} differs from Python's ints")
        ms = cuda_time_ms(lambda: ed.combine(Wk, c), 20)
        half_ms = cuda_time_ms(lambda: combine_halving(te.adapter, flat, c, K), 10)
        levels = (K - 1).bit_length()  # the halving combine's levels: log2 of K padded to a power of 2
        per, busy, wall, others, _ = device_times_whole(
            lambda: [ed.combine(Wk, c) for _ in range(REDESIGN_REPS)],
            lambda r: r[0].get("ed_combine", (0,))[0] == REDESIGN_REPS)
        dev_ms = per["ed_combine"][1] / per["ed_combine"][0] if per.get("ed_combine") else None
        hper, hbusy, hwall, hothers, _ = device_times_whole(
            lambda: combine_halving(te.adapter, flat, c, K),
            lambda r: r[0].get("ed_dbl", (0,))[0] == levels and r[0].get("ed_add", (0,))[0] == levels)
        products = (K - 1) * (c + 1) * ADD_MULS
        bms, by = bound_of((K + 1) * W, products * 2 * n * n, products * n, 1, rates)
        serial = 3 * (K - 1) * (c + 1)  # warp products on the critical path
        floor = serial * rates["lat_warp_n9"] * 1e3
        rows[f"K={K}, c={c}"] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, halving_ms=half_ms, halving_device_ms=hbusy,
            halving_host_ms=hwall, halving_kernels={k: v for k, v in hper.items()}, bound_ms=bms,
            bound_by=by, floor_ms=floor, serial_products=serial, max_abs_err=err)
        say(f"ed_combine K={K} c={c}: {REDESIGN_REPS} fresh inputs bit for bit with the plain Horner and "
            f"equal to the halving combine; kernel {ms:.4f} ms (device "
            + (f"{dev_ms:.4f} ms" if dev_ms else "not measured")
            + f"), plain {plain_ms:.1f} ms (the {REDESIGN_REPS} inputs in one run); halving "
            f"{half_ms:.4f} ms (device {hbusy:.4f} ms of {hwall:.4f} ms host: " + ", ".join(f"{k} {v[0]} x, {v[1]:.4f} ms" for k, v in hper.items())
            + f"; PyTorch's own {sum(v[1] for v in hothers.values()):.4f} ms); bound {bms * 1e3:.3f} us "
            f"({by}); floor {serial} x {rates['lat_warp_n9'] * 1e6:.3f} us = {floor:.4f} ms (share "
            f"{floor / (dev_ms or ms):.3f})")
    main = rows[f"K={TE_COMBINE_CASES[0][0]}, c={TE_COMBINE_CASES[0][1]}"]
    return dict(main, lanes=1, call=f"K={TE_COMBINE_CASES[0][0]}, c={TE_COMBINE_CASES[0][1]}",
                main_path=rows)


# ------------------------------------------------- sqrt slice: kernels


def sqrt_work(f, name: str, e: int = 0, m: int = 0, last: bool = False, s_is_t: bool = False,
              w: int | None = None, two_bit: bool = False) -> tuple[float, float, float]:
    """(bytes, wide multiplies, low multiplies) per lane of one call of a
    kernel of the sqrt slice, for this call's exponent e, chain m or window:
    each plane read once and written once; the products the function needs,
    a square priced at n (n + 1) / 2 + n^2 wide multiplies. exp_ladder: the
    schedule `ladder_schedule(e, w)` walks (w: the field's window unless
    given): the table's x^2 and one product an entry after x, each step's
    squarings and its product unless its digit is 0; with two_bit, the
    parent's fixed 2-bit digits (x^2 and x^3 as products, two squarings a
    digit and a product for each nonzero one), for the old bound; sqr_n: m
    squarings; sqrt_win: one product by the r row and one by the t row
    unless `last` (the table lookup's compares are no multiplies), reading
    t, r and s and writing t, r and the digit; where the window needs no
    chain s is t itself (s_is_t), read once."""
    from montgomery_tpu_torch.ops.field import (ladder_entries, ladder_schedule, schedule_products,
                                                sqrt_window_products)

    n = f.n
    W = 4 * n
    prod, sqr = (2 * n * n, n), (n * (n + 1) // 2 + n * n, n)

    def work(nbytes, products, squarings):
        return (nbytes, products * prod[0] + squarings * sqr[0],
                products * prod[1] + squarings * sqr[1])

    if name == "exp_ladder" and two_bit:
        nd = (e.bit_length() + 1) // 2
        nonzero = sum(1 for j in range(nd - 1) if (e >> (2 * j)) & 3)
        return work(2 * W, 2 + nonzero, 2 * (nd - 1))
    if name == "exp_ladder":
        sched = ladder_schedule(e, w or f.ladder_window)
        squarings = sum(s for s, _ in sched[1:]) + (ladder_entries(sched) > 1)
        return work(2 * W, schedule_products(sched) - squarings, squarings)
    if name == "sqr_n":
        return work(2 * W, 0, m)
    return work((4 if s_is_t else 5) * W + 4, sqrt_window_products(last), 0)


def _sqrt_plane(f, N: int, gen):
    """(n, N) Montgomery planes on the card and the canonical values of the
    first lanes: 0, 1, p - 1, 2, 4, sixteen known squares and sixteen known
    non-squares (a square times the least non-residue), then the unreduced
    representatives p, p + 1, 2p - 1 and R + p, then random values below
    2^bits(p)."""
    p, R = f.p, f.R
    z = 2
    while pow(z, (p - 1) // 2, p) == 1:
        z += 1
    rng = random.Random(N + f.n)
    sq = [pow(rng.randrange(1, p), 2, p) for _ in range(16)]
    canon = [0, 1, p - 1, 2, 4] + sq + [z * s % p for s in sq]
    raw = [c * R % p for c in canon] + [p, p + 1, 2 * p - 1, f.R_mod_p + p]
    return _field_plane(f, N, gen, raw), canon


def sqrt_checks(f, N: int, gen, check) -> None:
    """exp_ladder (e = p - 2, (q - 1) / 2), sqr_n (m of SQRT_CHAINS) and one
    whole sqrt window by window on N lanes of `_sqrt_plane`, each call
    through check(label, kernel, plain, N), which holds the kernel against
    its plain version and returns the kernel's outputs; then sqrt's roots
    and flags against its windows run one by one, and on the first lanes
    against Euler's criterion and root^2 = x on the host."""
    import torch

    from montgomery_tpu_torch.ops.field import SQRT_WINDOW

    n, p, M, q = f.n, f.p, f.sqrt_M, f.sqrt_q_odd

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    x, canon = _sqrt_plane(f, N, gen)
    for tag, e in (("p-2", p - 2), ("(q-1)/2", (q - 1) // 2)):
        check(f"exp_ladder e={tag}", lambda e=e: f.exp_ladder(x, e),
              lambda e=e: f.exp_ladder_plain(x, e), N)
    for m in SQRT_CHAINS:
        check(f"sqr_n m={m}", lambda m=m: f.sqr_n(x, m), lambda m=m: f.sqr_n_plain(x, m), N)
    # one whole sqrt, window by window, on the kernels' own values
    zmask = f.is_zero(x)
    xs = f._sel(zmask, f.const_plane(f.R_mod_p, x), x).contiguous()
    w = f.exp_const(xs, (q - 1) // 2)
    t, r = f.mul(xs, f.mul(w, w)), f.mul(xs, w)
    done = k = 0
    while done < M:
        lk = min(SQRT_WINDOW, M - done)
        last, chain = done + lk >= M, M - done - lk
        s = t
        if chain:
            (s,) = check(f"sqr_n m={chain}", lambda t=t, m=chain: f.sqr_n(t, m),
                         lambda t=t, m=chain: f.sqr_n_plain(t, m), N)
        t, r, dig = check(f"sqrt_win k={k}",
                          lambda a=(t, r, s, k, lk, last): f.sqrt_window(*a),
                          lambda a=(t, r, s, k, lk, last): f.sqrt_window_plain(*a), N)
        if k == 0:
            square = (dig[0] & 1) == 0
        done, k = done + lk, k + 1
    root, ok = f.sqrt(x)
    loop_root = f._sel(square & ~zmask, r, torch.zeros_like(r))
    if diff(root, loop_root) or not torch.equal(ok, square | zmask):
        raise AssertionError(f"sqrt at {n} limbs differs from its windows run one by one")
    head = len(canon)
    roots = f.unpack(root[:, :head], from_mont=True)
    for v, y, sq in zip(canon, roots, ok[:head].tolist()):
        if sq != (v == 0 or pow(v, (p - 1) // 2, p) == 1) or (y * y % p != v if sq else y):
            raise AssertionError(f"sqrt at {n} limbs is wrong for {v}")
    say(f"exp_ladder (e = p - 2, (q - 1) / 2), sqr_n (m = {SQRT_CHAINS} and the {k - 1} "
        f"chains), sqrt_win ({k} windows, M = {M}) n={n} N={N}: equal to the plain "
        f"versions bit for bit; sqrt of 0, 1, p - 1, 16 squares and 16 non-squares right")


def sqrt_wide(f, N: int, gen, check) -> None:
    """sqrt_win at every window of one whole sqrt on N random lanes (the
    chains by sqr_n), each through check(label, kernel, plain, N); then
    FieldOps.sqrt's roots and flags against those windows run one by one,
    and on SQRT_SAMPLE sampled lanes against Euler's criterion and
    root^2 = x with Python's ints."""
    import torch

    from montgomery_tpu_torch.ops.field import SQRT_WINDOW

    n, p, M, q = f.n, f.p, f.sqrt_M, f.sqrt_q_odd
    x = _random_planes(f, n, N, gen)
    w = f.exp_const(x, (q - 1) // 2)
    t, r = f.mul(x, f.mul(w, w)), f.mul(x, w)
    done = k = 0
    while done < M:
        lk = min(SQRT_WINDOW, M - done)
        last = done + lk >= M
        s = f.sqr_n(t, M - done - lk)
        t, r, dig = check(f"sqrt_win k={k}", lambda a=(t, r, s, k, lk, last): f.sqrt_window(*a),
                          lambda a=(t, r, s, k, lk, last): f.sqrt_window_plain(*a), N)
        if bool((dig < 0).any()):
            raise AssertionError(f"sqrt_win at {n} limbs found no digit on some lane of window {k}")
        if k == 0:
            square = (dig[0] & 1) == 0
        done, k = done + lk, k + 1
    del w, s
    root, ok = f.sqrt(x)
    zmask = f.is_zero(x)
    loop_root = f._sel(square & ~zmask, r, torch.zeros_like(r))
    if _raw_err([root], [loop_root]) or not torch.equal(ok, square | zmask):
        raise AssertionError(f"sqrt at {n} limbs and {N} lanes differs from its windows run one by one")
    lanes = sorted(random.Random(N + n).sample(range(N), min(SQRT_SAMPLE, N)))
    idx = torch.tensor(lanes, dtype=torch.long, device=x.device)
    xs = f.unpack(x.index_select(1, idx), from_mont=True)
    ys = f.unpack(root.index_select(1, idx), from_mont=True)
    for v, y, sq in zip(xs, ys, ok.index_select(0, idx).tolist()):
        if sq != (v == 0 or pow(v, (p - 1) // 2, p) == 1) or (y * y % p != v if sq else y):
            raise AssertionError(f"sqrt at {n} limbs and {N} lanes is wrong for {v}")
    say(f"sqrt_win n={n} N={N}: {k} windows bit for bit with the plain version; sqrt equal to them and, "
        f"on {len(lanes)} sampled lanes, to pow() and Euler's criterion ({int(ok.sum())} squares)")


def ladder_checks(f, W: int, gen, rates: dict) -> dict:
    """exp_ladder at e = (q - 1) / 2 (sqrt's first launch) and p - 2 (inv)
    on `_sqrt_plane` at LADDER_LANES and W lanes (the path's width): bit for
    bit against exp_ladder_plain (the same schedule on 16-bit limbs; at W,
    e = p - 2 on the first LADDER_SLICE lanes); at W the plain version's
    time at e = (q - 1) / 2 (CUDA events, one call), then the ladder's
    (`in_turns`, one body), with its bound and the 2-bit ladder's. (The
    turns against the parent's 2-bit CIOS ladder and the window sweep of
    that finished redesign are in PERF.md.) Returns {"max_abs_err",
    "plain_ms": {exponent: ms}, exponent: {"turns", "bound_ms", "bound_by",
    "bound_2bit_ms"}}."""
    import torch

    from montgomery_tpu_torch.ops.field import EXP_LADDER

    n, p, q = f.n, f.p, f.sqrt_q_odd
    exps = {"(q-1)/2": (q - 1) // 2, "p-2": p - 2}
    out = {"max_abs_err": 0, "plain_ms": {}, "window": f.ladder_window}
    for N in (*LADDER_LANES, W):
        x, _ = _sqrt_plane(f, N, gen)
        for tag, e in exps.items():
            a = f.exp_ladder(x, e)
            sliced = N == W and tag == "p-2"
            if sliced:
                a = a[:, :LADDER_SLICE]
            b, plain_ms = timed_once(lambda e=e: f.exp_ladder_plain(x[:, :LADDER_SLICE] if sliced else x, e))
            err = _raw_err([a], [b])
            if err:
                raise AssertionError(f"exp_ladder at {n} limbs, {N} lanes, e = {tag}: max_abs_err {err} against "
                                     f"the plain version")
            if N == W:
                out.setdefault(tag, {})
                if not sliced:
                    out["plain_ms"][tag] = plain_ms
        del a, b
        say(f"exp_ladder n={n} N={N} (e = (q - 1) / 2, p - 2; w = {f.ladder_window}): bit for bit with the plain "
            f"version" + (f" (p - 2 on {LADDER_SLICE} lanes)" if N == W and N > LADDER_SLICE else ""))
    for tag, e in exps.items():
        turns = in_turns(EXP_LADDER, lambda: f.exp_ladder(x, e), LADDER_TURN_REPS)
        bms, by = bound_of(*sqrt_work(f, "exp_ladder", e=e), W, rates)
        old = bound_of(*sqrt_work(f, "exp_ladder", e=e, two_bit=True), W, rates)[0]
        say_turns(f"exp_ladder n={n} N={W} e={tag}", turns, bms, by)
        say(f"exp_ladder n={n} N={W} e={tag}: the 2-bit ladder's bound {old:.4f} ms")
        out[tag].update(turns=turns, bound_ms=bms, bound_by=by, bound_2bit_ms=old)
    del x
    torch.cuda.empty_cache()
    return out


def phase_sqrt_kernels(ctx, te, rates: dict) -> tuple[dict, dict]:
    """exp_ladder (e = p - 2 and (q - 1) / 2), sqr_n (m = 1, 42, 43) and every
    sqrt_win window of one whole sqrt against their plain versions, bit for
    bit, at 12 limbs (BLS12-377) and 9 (ed-on-bls12-377), at 2^16 and
    2^16 + 17 lanes of `_sqrt_plane`; sqrt's roots and flags on the first
    lanes against Euler's criterion and root^2 = x on the host; inv against
    inv_root (the divstep) in canonical values at 2^16 lanes. Then each
    kernel timed, with its plain version, at the width the generation of 2^20
    points gives it (int(2.5 2^20) + 16 candidates): exp_ladder at
    e = (q - 1) / 2, sqr_n at the first chain (M - 4), sqrt_win at window 0.
    Returns the results at 12 and at 9 limbs."""
    import torch

    from montgomery_tpu_torch.ops.field import SQRT_WINDOW

    say("== phase 1: exp_ladder, sqr_n and sqrt_win against their plain versions")
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(9)
    out = ({}, {})

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    for res, c in zip(out, (ctx, te)):
        f = c.fops
        n, p, M, q = f.n, f.p, f.sqrt_M, f.sqrt_q_odd

        def check(label, kern, plain, N):
            a, b = kern(), plain()
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            err = max(diff(u, v) for u, v in zip(a, b))
            if err:
                raise AssertionError(f"{label} at {n} limbs and {N} lanes disagrees with its plain "
                                     f"version (max_abs_err {err})")
            r = res.setdefault(label.split()[0], {"max_abs_err": 0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            return a

        for N in SQRT_LANES:
            sqrt_checks(f, N, gen, check)
        sqrt_wide(f, SQRT_WIDE, gen, check)
        torch.cuda.empty_cache()
        ladder = ladder_checks(f, SQRT_WIDE, gen, rates)
        x, _ = _sqrt_plane(f, KERNEL_LANES[0], gen)
        err = diff(_canon(f, f.inv(x)), _canon(f, f.inv_root(x)))
        if err:
            raise AssertionError(f"inv at {n} limbs differs from inv_root")
        say(f"inv (Fermat, exp_ladder) n={n} N={KERNEL_LANES[0]}: equal to inv_root (divstep) in "
            f"canonical values")

        # timing at the generation's width, on random values
        W = SQRT_WIDE
        x = _random_planes(f, n, W, gen)
        e = (q - 1) // 2
        t = f.exp_ladder(x, q)  # x^q, in the 2-Sylow subgroup
        r = f.mul(x, f.exp_ladder(x, e))
        s = f.sqr_n(t, M - SQRT_WINDOW)
        per, busy, wall, others, _ = device_times_whole(
            lambda: f.sqrt(x), lambda res_: res_[0].get("sqrt_win", (0,))[0] == -(-M // SQRT_WINDOW))
        say_device_times(f"profiled FieldOps.sqrt n={n} at {W} lanes (the solve stage's sqrt)", per, busy,
                         wall, others)
        res.setdefault("sqrt_win", {})["sqrt_profile"] = {k: list(v) for k, v in per.items()}
        ms = cuda_time_ms(lambda: f.exp_ladder(x, e), 10)
        bms, by = bound_of(*sqrt_work(f, "exp_ladder", e=e), W, rates)
        res["exp_ladder"].update(ms=ms, plain_ms=ladder["plain_ms"]["(q-1)/2"], bound_ms=bms, bound_by=by,
                                 lanes=W, call="e = (q - 1) / 2", ladder=ladder)
        res["exp_ladder"]["max_abs_err"] = max(res["exp_ladder"]["max_abs_err"], ladder["max_abs_err"])
        say(f"exp_ladder n={n} (e = (q - 1) / 2, w = {f.ladder_window}): kernel {ms:.4f} ms, plain "
            f"{ladder['plain_ms']['(q-1)/2']:.4f} ms, bound {bms:.4f} ms ({by}, share {bms / ms:.3f}) per call at "
            f"{W} lanes")
        for name, kern, plain, call, work in (
                ("sqr_n", lambda: f.sqr_n(x, M - SQRT_WINDOW),
                 lambda: f.sqr_n_plain(x, M - SQRT_WINDOW), f"m = {M - SQRT_WINDOW}",
                 sqrt_work(f, "sqr_n", m=M - SQRT_WINDOW)),
                ("sqrt_win", lambda: f.sqrt_window(t, r, s, 0, SQRT_WINDOW, False),
                 lambda: f.sqrt_window_plain(t, r, s, 0, SQRT_WINDOW, False),
                 f"window 0 (lk = {SQRT_WINDOW})", sqrt_work(f, "sqrt_win"))):
            check(name, kern, plain, W)
            ms = cuda_time_ms(kern, 10)
            pms = cuda_time_ms(plain, 1, 0)
            bms, by = bound_of(*work, W, rates)
            res[name].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, lanes=W, call=call)
            say(f"{name} n={n} ({call}): kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
                f"({by}, share {bms / ms:.3f}) per call at {W} lanes")
        del x, t, r, s
        torch.cuda.empty_cache()
    return out


# ------------------------------------------- baselines: divstep_inv, barrett_mul


def _canonical_plane(f, M: int, gen, adv: list[int]):
    """(n, M) values in [0, p) on the card: `adv` in the first lanes, then
    random values (below 2^bits(p), reduced)."""
    t = f.reduce(_random_planes(f, f.n, M, gen))
    k = min(len(adv), M)
    t[:, :k] = f.pack_raw(adv[:k], gen.device)
    return t


# the example fields whose divstep_inv and barrett_mul no curve runs: 13
# limbs (BLS12-381's base field) and the 1-3 limb fields
ALT_FIELDS = ("bls12381", "small", "babybear", "goldilocks")
ALT_FIELD_LANES = (ALT_LANES[0], (1 << 16) + 17)  # checked at both, timed and sampled at the first


def phase_alt_kernels(ctx, te, rates: dict) -> tuple[dict, dict, dict]:
    """divstep_inv and barrett_mul against their plain versions on the same
    tensors, bit for bit: at 12 limbs (BLS12-377) at 2^18 and 2^18 + 17
    lanes, divstep_inv also at 512 and barrett_mul at 2^20; at 9 limbs
    (ed-on-bls12-377) at 2^16; for each field of ALT_FIELDS (13, 1, 2 and 3
    limbs) at ALT_FIELD_LANES. Operands in [0, p): the first lanes 0, 1, 2,
    p - 1, p - 2, then for barrett_mul the squares (p - 1 - k)^2, k < 16
    (the largest products below p^2), then random values. At 2^18 lanes,
    ALT_SAMPLE lanes (the first 21 among them) against Python's
    pow(x, -1, p) and x y % p, and barrett_mul against the Montgomery route
    from_mont(mont_mul(to_mont x, to_mont y)) on every lane. Every launch
    is counted at its field's limb count. Each timed, with its plain
    version, at 2^18 lanes (9 limbs: 2^16): CUDA events, and at the new
    counts the profiler's device time a launch too; where p < 2^31 the
    int64 expression x y % p beside barrett_mul ("library_ms"). Returns the
    results at 12 limbs, at 9, and {field: results} for ALT_FIELDS."""
    import torch

    from montgomery_tpu_torch.concrete import example_fields
    from montgomery_tpu_torch.ops import alt_mul, divstep
    from montgomery_tpu_torch.ops import limbs as codec
    from montgomery_tpu_torch.ops.field import create_field_ops

    say("== phase 1: divstep_inv and barrett_mul against their plain versions")
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(11)
    rng = random.Random(12)
    fields = [("bls12377", ctx.fops, {"divstep_inv": (*ALT_LANES, ROOT_LANES), "barrett_mul": (*ALT_LANES, 1 << 20)}),
              ("edBls12377", te.fops, {"divstep_inv": (KERNEL_LANES[0],), "barrett_mul": (KERNEL_LANES[0],)})]
    fields += [(name, create_field_ops(example_fields()[name].p),
                {"divstep_inv": ALT_FIELD_LANES, "barrett_mul": ALT_FIELD_LANES}) for name in ALT_FIELDS]
    out = {}

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    for label, f, plan in fields:
        n, p = f.n, f.p
        res = out.setdefault(label, {})
        dp, bp = f.inv_params, alt_mul.barrett_params(f)
        edge, squares = [0, 1, 2, p - 1, p - 2], [p - 1 - k for k in range(16)]
        timed_at = plan["divstep_inv"][0]
        for name, widths in plan.items():
            for M in widths:
                x = _canonical_plane(f, M, gen, edge + squares)
                if name == "divstep_inv":
                    y = None
                    kern, plain = (lambda: divstep.inv_divstep(dp, x)), (lambda: divstep.inv_plain(dp, x))
                else:
                    y = _canonical_plane(f, M, gen, edge[::-1] + squares)
                    kern = lambda: alt_mul.barrett_mul(bp, x, y)  # noqa: E731
                    plain = lambda: alt_mul.barrett_mul_plain(bp, x, y)  # noqa: E731
                counts, _, a = counted(kern, "alt", n, kernels_of={name})
                err = diff(a, plain())
                say(f"{name} {label} n={n} N={M}: max_abs_err {err} (raw planes), launches {counts[name]}")
                if err:
                    raise AssertionError(f"{name} at {n} limbs and {M} lanes disagrees with its plain version")
                r = res.setdefault(name, {"max_abs_err": 0, "limbs": n})
                r["launches"] = counts[name]
                if M == ALT_LANES[0]:
                    lanes = sorted(set(range(21)) | set(rng.sample(range(21, M), ALT_SAMPLE - 21)))
                    sel = torch.tensor(lanes, dtype=torch.long, device=dev)
                    xs, got = codec.unpack(x.index_select(1, sel)), codec.unpack(a.index_select(1, sel))
                    if y is None:
                        want = [pow(v, -1, p) if v else 0 for v in xs]
                    else:
                        want = [u * v % p for u, v in zip(xs, codec.unpack(y.index_select(1, sel)))]
                    if got != want:
                        raise AssertionError(f"{name} at {n} limbs differs from Python's ints on sampled lanes")
                    if y is not None:
                        mont = f.from_montgomery(f.mul(f.to_montgomery(x), f.to_montgomery(y)))
                        if diff(a, mont):
                            raise AssertionError(f"barrett_mul at {n} limbs differs from the Montgomery route")
                    say(f"{name} {label} N={M}: {ALT_SAMPLE} lanes equal Python's "
                        f"{'pow(x, -1, p)' if y is None else 'x y % p'}"
                        + ("" if y is None else f"; every lane equals from_mont(mont_mul(to_mont x, "
                                                "to_mont y))"))
                if M == timed_at:
                    if n in (12, 9):
                        ms, dev_ms = cuda_time_ms(kern, 20 if name == "divstep_inv" else KERNEL_REPS), None
                    else:
                        ms, dev_ms = launch_times(kern, name)
                    pms = cuda_time_ms(plain, 3, 1)
                    batches = divstep_batches(f, x, mont=False)[0] if name == "divstep_inv" else None
                    bms, by = bound_of(*kernel_work(types.SimpleNamespace(fops=f), name, batches), M, rates)
                    r.update(ms=ms, device_ms=dev_ms, plain_ms=pms, bound_ms=bms, bound_by=by, lanes=M,
                             share=bms / dev_ms if dev_ms else None)
                    if y is not None and p < 1 << 31:
                        xc, yc = x[0].long(), y[0].long()
                        r["library_ms"] = cuda_time_ms(lambda: xc * yc % p, NEW_TIMING_REPS)
                    say(f"{name} {label} n={n}: kernel {ms:.4f} ms"
                        + (f" (device {dev_ms:.4f} ms, share {bms / dev_ms:.3f})" if dev_ms else "")
                        + f", plain {pms:.4f} ms, bound {bms:.4f} ms ({by})"
                        + (f", x y % p (int64) {r['library_ms']:.4f} ms" if "library_ms" in r else "")
                        + f" per call at {M} lanes")
                del x, y, a
            torch.cuda.empty_cache()
    return out.pop("bls12377"), out.pop("edBls12377"), out


def phase_micro(ctx) -> dict:
    """The micro-benchmark (`micro_bench.main`, every section, 2^18 lanes)
    and the two divstep inverses at 2^18 lanes, in one run with the launch
    counts set to 0 just before it; then, outside that run, the checks'
    references: FieldOps.inv (the Fermat ladder, timed as the third
    inverse) and the Fermat inverse of the plain values. The Barrett
    chain's final planes against the plain chain on the same operands;
    inv_divstep (plain values) and inv_mont_divstep (Montgomery form)
    against the Fermat inverses on every lane; each inverse timed (median of
    3 CUDA-event times, each run ended by a synchronize); then the
    Montgomery and the Barrett chain once more under torch.profiler (their
    device time a launch, which the chains' CUDA-event times hide behind the
    host's cost of a launch) and the memory report. Returns the launch
    counts."""
    import torch

    from montgomery_tpu_torch import micro_bench
    from montgomery_tpu_torch.ops import alt_mul, divstep
    from montgomery_tpu_torch.utils.memory import print_max_size_used
    from montgomery_tpu_torch.utils.timing import timeit

    say(f"== phase 6: micro_bench.main (every section) and the inverses at 2^{MICRO_LOG2N} lanes")
    f, dev = ctx.fops, ctx.device
    dp = f.inv_params
    torch.cuda.reset_peak_memory_stats(dev)

    def inverses(x):  # x below p: plain values and Montgomery forms alike
        return {"inv_divstep": lambda: divstep.inv_divstep(dp, x),
                "inv_mont_divstep": lambda: divstep.inv_mont_divstep(dp, x)}

    def timed(inv):
        return ({k: timeit(fn, device=dev, reps=3, events=True)[0] for k, fn in inv.items()},
                {k: fn() for k, fn in inv.items()})

    def run():
        res = micro_bench.main(None, dev, MICRO_LOG2N, log=say)
        res["inverses_s"], res["inverses"] = timed(inverses(res["altmul"]["x"]))
        return res

    counts, seconds, res = counted(run, "micro")
    x = res["altmul"]["x"]
    fermat_s, fermat = timed({"FieldOps.inv": lambda: f.inv(x)})
    res["inverses_s"].update(fermat_s)
    res["inverses"].update(fermat)
    res["inv_of_plain"] = f.from_montgomery(f.inv(f.to_montgomery(x)))
    alt = res["altmul"]
    bp = alt_mul.barrett_params(f)
    z = alt["x"]
    for _ in range(alt["chain"]):
        z = alt_mul.barrett_mul_plain(bp, z, alt["y"])
    if not torch.equal(alt["barrett_chain"], z):
        raise AssertionError("the micro-bench's Barrett chain differs from the plain chain")
    got = res["inverses"]
    if not torch.equal(got["inv_divstep"], res["inv_of_plain"]):
        raise AssertionError("inv_divstep differs from the Fermat inverse")
    if not torch.equal(_canon(f, got["inv_mont_divstep"]), _canon(f, got["FieldOps.inv"])):
        raise AssertionError("inv_mont_divstep differs from the Fermat inverse")
    say(f"altmul: the Barrett chain's {alt['chain']} products equal the plain chain's on every lane")
    x, y = alt["x"], alt["y"]
    for label, op in (("Montgomery", f.mul), ("Barrett", lambda a, b: alt_mul.barrett_mul(bp, a, b))):
        def chain(op=op):
            z = x
            for _ in range(alt["chain"]):
                z = op(z, y)
        say_device_times(f"profiled {label} chain of {alt['chain']} at 2^{MICRO_LOG2N}",
                         *device_times(chain)[:4])
    say(f"inverses at 2^{MICRO_LOG2N} lanes, every lane equal to the Fermat ladder's; median ms: "
        + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in res["inverses_s"].items()))
    print_max_size_used(dev, log=say)
    say(f"micro phase: {seconds:.1f} s")
    del res, got, alt, z
    torch.cuda.empty_cache()
    return counts


def phase_te_oracle(te):
    """EdwardsMsm and compute_msm(curve="ed-on-bls12-377") against the
    bigint oracle: N = 16 (default c, a pair round first) and N = 512 (c = 4,
    the super-round first); compute_msm from ints and bytes, byte scalars
    above q, and its ValueErrors."""
    from montgomery_tpu_torch import serve
    from montgomery_tpu_torch.bigint import msm as oracle_msm

    say("== phase 2: Twisted Edwards MSM against the bigint oracle")
    E = oracle_curve(te.params)
    q, p = te.params.order, te.fops.p
    rng = random.Random(4)
    base = [E.random_point(rng) for _ in range(24)]
    for N, c, first in ((16, None, "pair"), (1 << 9, 4, "super")):
        pts, sc = _adversarial_inputs(E, base, N, rng)
        t0 = time.perf_counter()
        got = te.msm_full(sc, pts, c=c)
        dt = time.perf_counter() - t0
        rounds = list(te.adapter.rounds)
        if rounds[0][0] != first:
            raise AssertionError(f"Edwards MSM at N={N}: first round {rounds[0]}, expected {first}")
        if not E.equal(got, oracle_msm(E, sc, pts)):
            raise AssertionError(f"Edwards MSM at N={N} differs from the oracle")
        say(f"edwards N={N} c={c or te.default_c(N)} (duplicates, negations, identity, zero "
            f"scalars): equal to the oracle, first round {rounds[0]} ({dt:.2f} s incl. first calls)")
    pts, sc = _adversarial_inputs(E, base, 16, rng)
    w = oracle_msm(E, sc, pts)
    xy = [(P.x, P.y) for P in pts]
    pbytes = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little") for x, y in xy)
    # each scalar as s + k q for the largest k that fits in 32 bytes (>= q)
    sbytes = b"".join((s + ((1 << 256) - 1 - s) // q * q).to_bytes(32, "little") for s in sc)
    for label, args in (("ints", (xy, sc)), ("bytes, scalars above q", (pbytes, sbytes))):
        if serve.compute_msm(*args, curve=TE_CURVE) != (w.x, w.y):
            raise AssertionError(f"Edwards compute_msm from {label} differs from the oracle")
        say(f"serve.compute_msm(curve={TE_CURVE!r}) from {label}, N=16: equal to the oracle")
    bad_xy = list(xy)
    bad_xy[3] = (xy[3][0], (xy[3][1] + 1) % p)
    for label, args, match in (("off-curve point", (bad_xy, sc), "not on curve"),
                               ("misaligned point bytes", (pbytes[:-1], sc), "multiple of 64"),
                               ("length mismatch", (xy, sc[:-1]), "length mismatch")):
        try:
            serve.compute_msm(*args, curve=TE_CURVE)
        except ValueError as e:
            if match not in str(e):
                raise AssertionError(f"Edwards compute_msm on a {label}: {e}") from e
            say(f"serve.compute_msm(curve={TE_CURVE!r}) on a {label}: ValueError ({e})")
        else:
            raise AssertionError(f"Edwards compute_msm accepted a {label}")


def phase_te_msm(te, log2n: int, pts_full, expected: dict):
    """The Twisted Edwards MSM at N = 2^log2n: launch counts of msm_full (the
    MSM and to_host) with the counts set to 0 just before it, the full-N
    check, 5 timed runs of msm_device_full, peak memory, the phase split and
    the round plan. Returns the launch counts."""
    import torch

    from montgomery_tpu_torch.curves.edwards import EdwardsBatch
    from montgomery_tpu_torch.utils.timing import timeit

    N = 1 << log2n
    c = te.default_c(N)
    say(f"== phase 3: Twisted Edwards MSM N=2^{log2n}, c={c}, K={te.num_windows(c)}, "
        f"n={te.fops.n} limbs of 32 bits")
    P = EdwardsBatch(*[a[..., :N] for a in pts_full])
    scalars = bench_scalars(te.params.order, N)
    limbs = te.scalars_to_limbs(scalars)
    dev = te.device
    counts, first, got = counted(lambda: te.msm_full(limbs, P, c=c), "te", te.fops.n)
    say(f"te launches: {counts} (first run {first:.3f} s)")
    top = log2n == max(MSM_LOG2N)
    if top:
        wrong = {k: (counts[k], v) for k, v in TE_PATH_LAUNCHES.items() if counts[k] != v}
        if wrong:
            raise AssertionError(f"Twisted Edwards path launches (got, expected): {wrong}")
    say(f"rounds: {te.adapter.rounds}")
    t0 = time.perf_counter()
    E = oracle_curve(te.params)
    if got.is_zero or not E.equal(got, expected_sum(expected, te.params, N, pts_full.count)):
        raise AssertionError(f"Edwards MSM at N=2^{log2n} differs from the closed form")
    say(f"full-N check: equal to the closed form ({time.perf_counter() - t0:.1f} s on the host)")

    def run():
        return te.msm_device_full(P, limbs, c)

    med, times = timeit(run, device=dev, reps=5, warmup=1)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    _, log = te.msm_phases(P, limbs, c)
    say(f"msm te N=2^{log2n}: median {med:.6f} s over 5 runs {['%.6f' % t for t in times]}; "
        f"peak memory {peak / 2**20:.1f} MiB")
    say("phase split:\n" + log.report())
    if top:  # where its device time goes, with the halving combine (before) and ed_combine
        home = te.adapter
        for label, adapter, expect in (("halving combine", HalvingCombine(home), {"ed_dbl": 6, "ed_add": 42}),
                                       ("ed_combine", home, TE_PATH_LAUNCHES)):
            te.adapter = adapter
            try:
                per, busy, wall, others, _ = device_times_whole(
                    run, lambda r, e=expect: all(r[0].get(k, (0,))[0] == v for k, v in e.items()))
            finally:
                te.adapter = home
            say_device_times(f"profiled Twisted Edwards N=2^{log2n} ({label})", per, busy, wall, others)
    return counts


# ------------------------------------------------- sqrt slice: random points


def phase_points(c, path: str, log2n: int = GEN_LOG2N, msms: bool = True) -> dict:
    """random_points_weierstrass (a Weierstrass curve, path "points") or
    random_points_edwards (ed-on-bls12-377, "te_points") at 2^log2n points
    on the card: launch counts of one generation with the counts set to 0
    just before it (exp_ladder once, sqr_n once per window but the last,
    sqrt_win once per window, the cofactor's adds and doublings and the
    normalisation where the cofactor is not 1, every launch at the curve's
    limb count) and its peak memory; the median of 3 generations after
    that one, split into its stages;
    every point on the curve and none the point at infinity (identity), on
    the card; GEN_SAMPLE_CANDIDATES candidates' success flags against Euler's
    criterion and GEN_SAMPLE_POINTS points rebuilt with the bigint oracle
    from the same candidate draw (the first N successes in candidate order,
    root^2 = rhs, the cofactor multiple equal to the output); q P = 0 on 8
    lanes; then MSMs on the points with bench_scalars: BLS12-377's safe,
    unsafe and projective engines agree at 2^20 and the safe one equals the
    oracle on the first GEN_ORACLE_N points; the Twisted Edwards MSM at the
    default c and at c - 1 agrees at 2^log2n and equals the oracle at
    GEN_ORACLE_N (without `msms`, none of these MSMs). Returns the
    generation's launch counts."""
    import statistics

    import numpy as np
    import torch

    from montgomery_tpu_torch.bigint import AffinePoint, EdwardsPoint, msm as oracle_msm
    from montgomery_tpu_torch.curves import random as rnd
    from montgomery_tpu_torch.ops.field import SQRT_WINDOW
    from montgomery_tpu_torch.utils.timing import PhaseLog

    N = 1 << log2n
    te = path.startswith("te")
    f, dev, params = c.fops, c.device, c.params
    p, q = f.p, params.order
    E = oracle_curve(params)
    to_host = c.ed.to_host if te else c.proj.affine_to_host

    def lanes_of(idx):
        return type(pts)(*[a[..., idx] for a in pts])

    say(f"== phase 4: {'random_points_edwards' if te else 'random_points_weierstrass'}"
        f"({params.label}) N=2^{log2n}, seed {GEN_SEED}, oversample {GEN_OVERSAMPLE}, "
        f"n={f.n} limbs of 32 bits")

    def generate(log=None):
        if te:
            return rnd.random_points_edwards(c.ed, N, seed=GEN_SEED, device=dev, log=log)
        return rnd.random_points_weierstrass(c.proj, N, seed=GEN_SEED, device=dev, log=log)

    windows = -(-f.sqrt_M // SQRT_WINDOW)
    need = None
    if not te and f.n != 12:  # BLS12-381 (one window, no chain) and Pallas (no cofactor)
        need = {"mul_const", "mont_mul", "exp_ladder", "sqrt_win"} | ({"sqr_n"} if windows > 1 else set())
        if params.cofactor != 1:
            need |= {"proj_add_rcb", "proj_dbl_rcb", "divstep_inv_mont"}
    torch.cuda.reset_peak_memory_stats(dev)
    counts, first, pts = counted(generate, path, f.n, need)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"exp_ladder": 1, "sqr_n": windows - 1, "sqrt_win": windows}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{path}: launches {counts}, expected {want} for the sqrt")
    say(f"{path} launches: {counts} (first run {first:.3f} s); the sqrt's as predicted: {want}")

    logs = []
    for _ in range(3):
        log = PhaseLog()
        generate(log)
        logs.append(dict(log.entries))
    split = {k: statistics.median(lg[k] for lg in logs) for k in logs[0]}
    total = statistics.median(sum(lg.values()) for lg in logs)
    say(f"generation N=2^{log2n}: median {total:.6f} s over 3 runs "
        f"{['%.6f' % sum(lg.values()) for lg in logs]}; peak memory {peak / 2**20:.1f} MiB")
    say("phase split (medians):\n" + "\n".join(f"{k:<32s} {v * 1e3:9.2f} ms" for k, v in split.items()))

    # every lane on the curve, none at infinity (the identity)
    if te:
        on, zero = c.is_on_curve(pts), c.ed.is_zero(pts)
    else:
        on, zero = c.is_on_curve(pts), pts.inf
    if not bool(on.all()) or bool(zero.any()):
        raise AssertionError(f"{path}: {int((~on).sum())} points off the curve, "
                             f"{int(zero.sum())} at infinity")

    # the host's rebuild from the same draw
    M = int(N * GEN_OVERSAMPLE) + 16
    xs = rnd._uniform_field_vals(np.random.default_rng(GEN_SEED), M, p)
    X = f.pack_raw(xs, dev)
    if te:
        _, Y, ok = rnd.solve_edwards(c.ed, X)
    else:
        _, Y, ok = rnd.solve_weierstrass(c.proj, X)
    okh = ok.cpu().numpy()
    idx = np.flatnonzero(okh)[:N]
    if len(idx) < N:
        raise AssertionError(f"{path}: only {len(idx)} successes")

    def rhs(x):
        if te:
            den = (1 - params.d * x * x) % p
            return (1 + x * x) * pow(den, -1, p) % p if den else None
        return (x * x * x + params.a * x + params.b) % p

    rng = random.Random(5)
    for i in rng.sample(range(M), GEN_SAMPLE_CANDIDATES):
        v = rhs(xs[i])
        if bool(okh[i]) != (v is not None and (v == 0 or pow(v, (p - 1) // 2, p) == 1)):
            raise AssertionError(f"{path}: candidate {i}'s success flag contradicts Euler's criterion")
    lanes = sorted(rng.sample(range(N), GEN_SAMPLE_POINTS))
    sel = torch.tensor(idx[lanes], dtype=torch.long, device=dev)
    roots = f.unpack(Y.index_select(-1, sel), from_mont=True)
    Pt = EdwardsPoint if te else AffinePoint
    for lane, i, y, g in zip(lanes, idx[lanes], roots, to_host(lanes_of(lanes))):
        x = xs[i]
        if y * y % p != rhs(x) or not E.equal(g, E.scale(params.cofactor, Pt(x, y))):
            raise AssertionError(f"{path}: point {lane} (candidate {i}) differs from the oracle's")
    head = lanes_of(slice(0, 8))
    if te:
        in_group = c.ed.is_zero(c.ed.scale(q, head))
    else:
        in_group = c.proj.is_zero(c.proj.scale(q, c.proj.from_affine(head)))
    if not bool(in_group.all()):
        raise AssertionError(f"{path}: q P != 0 on the first 8 points")
    say(f"{path}: all {N} points on the curve, none infinite; {GEN_SAMPLE_CANDIDATES} success flags "
        f"equal Euler's criterion; {GEN_SAMPLE_POINTS} points equal the oracle's cofactor multiple "
        f"of their candidate (the first {N} successes of {M}); q P = 0 on 8 points")

    if not msms:
        return counts

    # MSMs on the generated points
    scalars = bench_scalars(q, N)
    limbs = c.scalars_to_limbs(scalars)
    cN = c.default_c(N)
    # a curve without an endomorphism (P-256) through msm: host digits, no GLV
    glv = te or c.glv is not None
    msm = c.msm_full if glv else (lambda sc_, pts_, **kw: c.msm(sc_, pts_, **{"affine": True, **kw}))
    if te:
        runs = {f"c={cN}": dict(c=cN), f"c={cN - 1}": dict(c=cN - 1)}
    else:
        runs = {"affine-safe": {}, "affine-unsafe": dict(unsafe=True),
                "projective": dict(affine=False)}
    results = {k: msm(limbs if glv else scalars, pts, **kw) for k, kw in runs.items()}
    ref = next(iter(results.values()))
    if ref.is_zero or not all(E.equal(v, ref) for v in results.values()):
        raise AssertionError(f"{path}: MSMs on the generated points disagree: {list(results)}")
    head = lanes_of(slice(0, GEN_ORACLE_N))
    sc = scalars[:GEN_ORACLE_N]
    if not E.equal(msm(sc, head), oracle_msm(E, sc, to_host(head))):
        raise AssertionError(f"{path}: MSM of {GEN_ORACLE_N} generated points differs from the oracle")
    say(f"{path}: MSM at N=2^{log2n} on the generated points agrees across {list(results)}; "
        f"at N={GEN_ORACLE_N} equal to the bigint oracle")
    return counts


# ------------------------------ phase 7: the rest of the JAX package's API

# the example fields' kernel checks: every op at EXAMPLE_LANES lanes, held
# bit for bit against its plain version on the first EXAMPLE_PLAIN lanes
# and against Python's ints on EXAMPLE_SAMPLE sampled lanes
EXAMPLE_LANES = 1 << 20
EXAMPLE_PLAIN = 1 << 16
EXAMPLE_SAMPLE = 1024
EXAMPLE_SHIFTS = (0, 1, 31, 255)
EXAMPLE_REPS = {"mul": 20, "square": 20, "add_no_reduce": 20, "sub_positive": 20, "left_shift": 20,
                "inv": 3, "batch_inv": 3, "sqrt": 2}
# the kernel each op launches (None: torch's own kernels, as in the JAX
# package, where these are no Pallas kernel either)
EXAMPLE_KERNEL = {"mul": "mont_mul", "square": "mont_sqr", "add_no_reduce": None, "sub_positive": None,
                  "left_shift": "mul_const", "inv": "exp_ladder", "batch_inv": "divstep_inv_mont",
                  "sqrt": "sqrt_win"}
API_WIDE_LOG2N = 20  # the non-GLV engines, window_chunk and the predicates
NONGLV_C = 13  # the non-GLV engines at 2^20: K = 20 windows of BLS12-377's 253-bit scalars
API_LOG2N = 16  # msm, msm_glv and EdwardsMsm.msm from Python ints
SWEEP_N = ((1 << 12) - 17, (1 << 12) + 17)  # the size sweep's widths (the CPU tests run 1, 2^5, 2^9)
WINDOW_CHUNK = {"bls12-377": 4, TE_CURVE: 5}  # K = 10 GLV windows (K_pad 12) and 20 (K_pad 20)
SUBGROUP_ADV = 18  # adversarial lanes at the head of the predicates' 2^20 lanes
_NONGLV = {"proj_add_rcb", "proj_dbl_rcb", "proj_combine_rcb"}
_TO_HOST = {"mont_mul", "divstep_inv_mont"}  # to_host: one batch inversion of Z and a product
PATH_KERNELS.update({
    "fields": _SOLVE | {"mont_sqr"},
    "nonglv_projective": _NONGLV,
    "nonglv_affine_unsafe": _NONGLV | _UNSAFE | _TO_HOST,
    "nonglv_affine_safe": _NONGLV | _SAFE | _TO_HOST,
    "chunk_affine_unsafe": _AFFINE | _UNSAFE,
    "chunk_te": _EDWARDS,
    # the host entries from Python ints: to_montgomery (mul_const), the MSM, to_host
    "api_msm": _NONGLV | _TO_HOST | {"mul_const"},
    "api_msm_glv": _NONGLV | _TO_HOST | {"mul_const"},
    "api_te_msm": _EDWARDS | _TO_HOST | {"mul_const"},
    "sweep_safe": _AFFINE | _SAFE,
    "sweep_unsafe": _AFFINE | _UNSAFE,
    "sweep_msm_safe": _NONGLV | _SAFE | _TO_HOST,
    "sweep_msm_unsafe": _NONGLV | _UNSAFE | _TO_HOST,
    "on_curve": {"mont_mul"},
    "subgroup": {"proj_add_rcb", "proj_dbl_rcb"},
    "te_on_curve": {"mont_mul"},
    "te_subgroup": {"ed_add", "ed_dbl"},
})
_ALL = _WEIERSTRASS | _EDWARDS | _SOLVE | _PLANAR | _ALT
PATH_FORBIDDEN.update({
    "fields": _ALL - PATH_KERNELS["fields"],
    "nonglv_projective": _ALL - _NONGLV,
    "nonglv_affine_unsafe": _ALL - PATH_KERNELS["nonglv_affine_unsafe"],
    "nonglv_affine_safe": _ALL - PATH_KERNELS["nonglv_affine_safe"],
    "chunk_affine_unsafe": _ALL - PATH_KERNELS["chunk_affine_unsafe"],
    "chunk_te": _ALL - _EDWARDS,
    "api_msm": _ALL - PATH_KERNELS["api_msm"],
    "api_msm_glv": _ALL - PATH_KERNELS["api_msm_glv"],
    "api_te_msm": _ALL - PATH_KERNELS["api_te_msm"],
    "sweep_safe": _ALL - PATH_KERNELS["sweep_safe"],
    "sweep_unsafe": _ALL - PATH_KERNELS["sweep_unsafe"],
    "sweep_msm_safe": _ALL - PATH_KERNELS["sweep_msm_safe"],
    "sweep_msm_unsafe": _ALL - PATH_KERNELS["sweep_msm_unsafe"],
    "on_curve": _ALL - {"mont_mul"},
    "subgroup": _ALL - PATH_KERNELS["subgroup"],
    "te_on_curve": _ALL - {"mont_mul"},
    "te_subgroup": _ALL - PATH_KERNELS["te_subgroup"],
})


def _sample_lanes(N: int, head: int, k: int, seed: int) -> list[int]:
    """The first `head` lanes and k - head distinct others, drawn from seed."""
    rng = random.Random(seed)
    return list(range(head)) + sorted(rng.sample(range(head, N), k - head))


def _lanes_ints(t, lanes: list[int]) -> list[int]:
    """Raw ints of int32 planes at `lanes`."""
    import torch

    from montgomery_tpu_torch.ops import limbs as codec

    return codec.unpack(t[:, torch.tensor(lanes, device=t.device)])


def example_field(name: str, f, gen, rates: dict) -> dict:
    """One example field (1 to 13 limbs) on the card: mul, square,
    add_no_reduce, sub_positive, left_shift (k in EXAMPLE_SHIFTS), inv
    (Fermat, exp_ladder), batch_inv (its root divstep_inv_mont) and sqrt at
    EXAMPLE_LANES lanes, the first lanes 0, 1, p - 1, p, p + 1, 2p - 1,
    R mod p and R^2 mod p. Each kernel's result equals its plain version
    on the same CUDA tensors, bit for bit, on the first EXAMPLE_PLAIN lanes
    (batch_inv's root at its 512 lanes; sqrt's exp_ladder, sqr_n and
    sqrt_win through `sqrt_checks` on EXAMPLE_PLAIN lanes of `_sqrt_plane`),
    and every op equals Python's ints on EXAMPLE_SAMPLE sampled lanes. Each
    op's launches are counted with the counts set to 0 just before it and
    timed at EXAMPLE_LANES lanes (CUDA events). Returns {op: result}."""
    import torch

    from montgomery_tpu_torch.ops import divstep
    from montgomery_tpu_torch.ops.field import SQRT_WINDOW

    n, p, R, N, H = f.n, f.p, f.R, EXAMPLE_LANES, EXAMPLE_PLAIN
    Ri = f.R_inv
    adv = [0, 1, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p, f.R2]
    x = _field_plane(f, N, gen, adv)
    y = _field_plane(f, N, gen, adv[::-1])
    lanes = _sample_lanes(N, len(adv), EXAMPLE_SAMPLE, n + p % 1000)
    xs, ys = _lanes_ints(x, lanes), _lanes_ints(y, lanes)
    out = {}

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    ops = {
        "mul": (lambda: f.mul(x, y), lambda: f.mul_plain(x[:, :H], y[:, :H]),
                lambda o: all(v < 2 * p and v % p == a * b * Ri % p for v, a, b in zip(o, xs, ys))),
        "square": (lambda: f.square(x), lambda: f.square_plain(x[:, :H]),
                   lambda o: all(v < 2 * p and v % p == a * a * Ri % p for v, a in zip(o, xs))),
        "add_no_reduce": (lambda: f.add_no_reduce(x, y), None,
                          lambda o: o == [a + b for a, b in zip(xs, ys)]),
        "sub_positive": (lambda: f.sub_positive(x, y), None,
                         lambda o: o == [a - b + 2 * p for a, b in zip(xs, ys)]),
        "inv": (lambda: f.inv(x), lambda: f.exp_ladder_plain(x[:, :H], p - 2),
                lambda o: all(v < 2 * p and v * Ri % p == pow(a * Ri % p, p - 2, p) for v, a in zip(o, xs))),
        "batch_inv": (lambda: f.batch_inv(x, handle_zero=True), None,
                      lambda o: all(v * Ri % p == (pow(a * Ri % p, -1, p) if a % p else 0)
                                    for v, a in zip(o, xs))),
    }
    for k in EXAMPLE_SHIFTS:
        ops[f"left_shift k={k}"] = (lambda k=k: f.left_shift(x, k),
                                    lambda k=k: f.mul_const_plain(x[:, :H], pow(2, k, p) * R % p),
                                    lambda o, k=k: all(v < 2 * p and v % p == a * pow(2, k, p) % p
                                                       for v, a in zip(o, xs)))
    for label, (kern, plain, exact) in ops.items():
        op = label.split()[0]
        counts, _, got = counted(kern, "fields", n, kernels_of={EXAMPLE_KERNEL[op]} - {None})
        err = diff(got[:, :H], plain()) if plain is not None else 0
        if err:
            raise AssertionError(f"{name} {label}: the kernel disagrees with its plain version "
                                 f"(max_abs_err {err})")
        if not exact(_lanes_ints(got, lanes)):
            raise AssertionError(f"{name} {label}: wrong on the sampled lanes against Python's ints")
        r = out.setdefault(op, {"kernel": EXAMPLE_KERNEL[op], "max_abs_err": 0, "launches": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["launches"][label] = {k: v for k, v in counts.items() if v}
    # batch_inv's root: divstep_inv_mont on BATCH_INV_STOP lanes, bit for bit
    root = x[:, :f.BATCH_INV_STOP].contiguous()
    err = diff(f.inv_root(root), divstep.inv_mont_plain(f, root))
    if err:
        raise AssertionError(f"{name}: divstep_inv_mont disagrees with its plain version ({err})")

    # sqrt: its kernels bit for bit on H lanes, then the whole sqrt at N lanes
    def check(label, kern, plain, lanes_):
        a, b = kern(), plain()
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        e = max(diff(u, v) for u, v in zip(a, b))
        if e:
            raise AssertionError(f"{name} {label} disagrees with its plain version (max_abs_err {e})")
        return a

    sqrt_checks(f, H, gen, check)
    # sqr_n runs only where a window lies below the first (M > SQRT_WINDOW)
    chains = {"sqr_n"} if f.sqrt_M > SQRT_WINDOW else set()
    counts, _, (root_, ok) = counted(lambda: f.sqrt(x), "fields", n,
                                     kernels_of={"exp_ladder", "sqrt_win", "mont_mul"} | chains)
    roots, flags = _lanes_ints(root_, lanes), ok[torch.tensor(lanes, device=ok.device)].tolist()
    for a, r_, sq in zip(xs, roots, flags):
        v = a * Ri % p
        if sq != (v == 0 or pow(v, (p - 1) // 2, p) == 1) or (r_ * Ri % p) ** 2 % p != (v if sq else 0):
            raise AssertionError(f"{name} sqrt is wrong for {v}")
    out["sqrt"] = {"kernel": "sqrt_win", "max_abs_err": 0, "launches": {"sqrt": {k: v for k, v in counts.items() if v}},
                   "M": f.sqrt_M}

    # times at N lanes, and the kernels' bounds
    ctx_f = type("FieldCtx", (), {"fops": f})()
    work = {"mul": kernel_work(ctx_f, "mont_mul"), "square": kernel_work(ctx_f, "mont_sqr"),
            "left_shift": kernel_work(ctx_f, "mul_const"), "inv": sqrt_work(f, "exp_ladder", e=p - 2)}
    for op, fn in (("mul", lambda: f.mul(x, y)), ("square", lambda: f.square(x)),
                   ("add_no_reduce", lambda: f.add_no_reduce(x, y)),
                   ("sub_positive", lambda: f.sub_positive(x, y)), ("left_shift", lambda: f.left_shift(x, 255)),
                   ("inv", lambda: f.inv(x)), ("batch_inv", lambda: f.batch_inv(x, handle_zero=True)),
                   ("sqrt", lambda: f.sqrt(x))):
        ms = cuda_time_ms(fn, EXAMPLE_REPS[op], 1)
        out[op]["ms"] = ms
        if op in work:
            out[op]["bound_ms"], out[op]["bound_by"] = bound_of(*work[op], N, rates)
    say(f"{name} (n={n}, M={f.sqrt_M}) at {N} lanes, ms a call: "
        + ", ".join(f"{op} {r['ms']:.4f}" + (f" (bound {r['bound_ms']:.4f}, {r['bound_by']})" if "bound_ms" in r
                                              else "") for op, r in out.items())
        + f"; kernels equal their plain versions on {H} lanes, every op Python's ints on {len(lanes)} lanes")
    return out


# the widest timing of the bytes-bound field kernels at 1-3 limbs: at 2^20
# lanes their bound (4-11 us) is near a launch's own latency
EXAMPLE_WIDE = 1 << 24
# a field whose limb count no kernel has (5 limbs): every kernel op must raise
UNBUILT_P = (1 << 127) - 1


def launch_times(kern, name: str, reps: int | None = None) -> tuple[float, float | None]:
    """(CUDA-event mean ms a call of kern, the profiler's device ms a launch
    of kernel `name` over `reps` (NEW_TIMING_REPS) more calls; None where
    every profile dropped some of them). kern launches `name` once a call."""
    reps = reps or NEW_TIMING_REPS
    ms = cuda_time_ms(kern, reps)
    per = device_times_whole(lambda: [kern() for _ in range(reps)],
                             lambda res: res[0].get(name, (0,))[0] == reps)[0]
    count, dms = per.get(name, (0, 0.0))
    return ms, (dms / count if count == reps else None)


def small_field_times(name: str, f, gen, rates: dict) -> dict:
    """The field kernels at a 1-3 limb field's own instantiation, timed:
    mont_mul, mont_sqr and mul_const at EXAMPLE_LANES and EXAMPLE_WIDE
    lanes, exp_ladder (e = p - 2), sqr_n (the sqrt's first chain, where
    M > SQRT_WINDOW) and sqrt_win (window 0) at EXAMPLE_LANES, and
    divstep_inv_mont at the batch inversion's ROOT_LANES: on random planes
    below 2^bits(p), each held against its plain version on the same
    tensors (one timed call; at EXAMPLE_WIDE on its first EXAMPLE_PLAIN
    lanes), then `launch_times`, the bound from this run's work and rates,
    and share = bound / device time. Where p < 2^31 (n = 1, 2), the PyTorch
    expression x y % p on int64 canonical residues, the same field product
    in the plain domain, is timed beside mont_mul ("library_ms"; none at
    n = 3, where the product overflows int64). Returns {kernel: result}."""
    import torch

    from montgomery_tpu_torch.ops import divstep
    from montgomery_tpu_torch.ops.field import SQRT_WINDOW

    n, p, M, q = f.n, f.p, f.sqrt_M, f.sqrt_q_odd
    ctx_f = type("FieldCtx", (), {"fops": f})()
    out = {}

    def one(kname, label, kern, plain, work, lanes, wide=None):
        a = kern()
        b, plain_ms = timed_once(plain)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        cut = (lambda t: t[..., :EXAMPLE_PLAIN]) if wide else (lambda t: t)
        err = _raw_err([cut(t) for t in a], b)
        if err:
            raise AssertionError(f"{name} {kname} ({label}) disagrees with its plain version ({err})")
        ms, dev_ms = launch_times(kern, kname)
        bms, by = bound_of(*work, lanes, rates)
        r = {"lanes": lanes, "call": label, "ms": ms, "device_ms": dev_ms, "bound_ms": bms, "bound_by": by,
             "share": bms / dev_ms if dev_ms else None, "max_abs_err": err}
        if wide is None:
            r["plain_ms"] = plain_ms
            out[kname] = {**out.get(kname, {}), **r}
        else:
            out[kname][wide] = r
        say(f"{name} {kname} n={n} ({label}) at {lanes} lanes: events {ms:.4f} ms, device "
            + (f"{dev_ms * 1e3:.2f} us" if dev_ms else "not measured") + f", bound {bms * 1e3:.2f} us ({by})"
            + (f", share {bms / dev_ms:.3f}" if dev_ms else "") + ("" if wide else f", plain {plain_ms:.4f} ms"))
        return r

    for N, wide in ((EXAMPLE_LANES, None), (EXAMPLE_WIDE, "wide")):
        x, y = _random_planes(f, n, N, gen), _random_planes(f, n, N, gen)
        H = N if wide is None else EXAMPLE_PLAIN
        xh, yh = x[:, :H], y[:, :H]
        c = pow(2, 255, p) * f.R % p
        one("mont_mul", "x y", lambda: f.mul(x, y), lambda: f.mul_plain(xh, yh), kernel_work(ctx_f, "mont_mul"),
            N, wide)
        one("mont_sqr", "x^2", lambda: f.square(x), lambda: f.square_plain(xh), kernel_work(ctx_f, "mont_sqr"),
            N, wide)
        one("mul_const", "left_shift k=255", lambda: f.mul_const(x, c), lambda: f.mul_const_plain(xh, c),
            kernel_work(ctx_f, "mul_const"), N, wide)
        if p < 1 << 31:  # canonical residues fit one word: int64 holds their product
            xc, yc = f.reduce(x)[0].long(), f.reduce(y)[0].long()
            lib = cuda_time_ms(lambda: xc * yc % p, NEW_TIMING_REPS)
            (out["mont_mul"] if wide is None else out["mont_mul"][wide])["library_ms"] = lib
            say(f"{name} library x y % p (int64, canonical) at {N} lanes: {lib:.4f} ms a call")
            del xc, yc
        del x, y, xh, yh
        torch.cuda.empty_cache()
    N = EXAMPLE_LANES
    x = _random_planes(f, n, N, gen)
    one("exp_ladder", "e = p - 2", lambda: f.exp_ladder(x, p - 2), lambda: f.exp_ladder_plain(x, p - 2),
        sqrt_work(f, "exp_ladder", e=p - 2), N)
    lk = min(SQRT_WINDOW, M)
    t = f.exp_ladder(x, q)  # x^q, in the 2-Sylow subgroup
    r = f.mul(x, f.exp_ladder(x, (q - 1) // 2))
    s = f.sqr_n(t, M - lk)
    if M > lk:
        one("sqr_n", f"m = {M - lk}", lambda: f.sqr_n(t, M - lk), lambda: f.sqr_n_plain(t, M - lk),
            sqrt_work(f, "sqr_n", m=M - lk), N)
    last = lk >= M
    one("sqrt_win", f"window 0 (lk = {lk})", lambda: f.sqrt_window(t, r, s, 0, lk, last),
        lambda: f.sqrt_window_plain(t, r, s, 0, lk, last), sqrt_work(f, "sqrt_win", last=last, s_is_t=s is t), N)
    root = x[:, :ROOT_LANES].contiguous()
    batches = divstep_batches(f, root)[0]
    one("divstep_inv_mont", "the batch inversion's root", lambda: f.inv_root(root),
        lambda: divstep.inv_mont_plain(f, root), kernel_work(ctx_f, "divstep_inv_mont", batches), ROOT_LANES)
    del x, t, r, s, root
    torch.cuda.empty_cache()
    return out


def refuse_unbuilt_limbs(dev) -> None:
    """Every kernel op of a field whose limb count no kernel was built for
    (UNBUILT_P, 5 limbs) raises NotImplementedError on CUDA tensors: nothing
    runs a plain version in its place."""
    from montgomery_tpu_torch.ops import alt_mul, divstep
    from montgomery_tpu_torch.ops.field import create_field_ops

    f = create_field_ops(UNBUILT_P)
    x = f.pack_raw([1, 2, UNBUILT_P - 1], dev)
    for label, fn in (("mul", lambda: f.mul(x, x)), ("square", lambda: f.square(x)),
                      ("left_shift", lambda: f.left_shift(x, 1)), ("inv", lambda: f.inv(x)),
                      ("sqr_n", lambda: f.sqr_n(x, 3)), ("batch_inv", lambda: f.batch_inv(x)),
                      ("sqrt", lambda: f.sqrt(x)), ("sqrt_window", lambda: f.sqrt_window(x, x, x, 0, 1, True)),
                      ("inv_divstep", lambda: divstep.inv_divstep(f.inv_params, x)),
                      ("barrett_mul", lambda: alt_mul.barrett_mul(alt_mul.barrett_params(f), x, x))):
        try:
            fn()
        except NotImplementedError:
            continue
        raise AssertionError(f"{label} at {f.n} limbs on the card did not raise")
    say(f"2^127 - 1 (n={f.n}): every kernel op raises NotImplementedError on the card")


def phase_example_fields(rates: dict) -> dict:
    """Every example field of `concrete.example_fields` (1, 2, 3, 9, 12 and
    13 limbs) through `example_field`, each with its seconds; the 1-3 limb
    fields' kernels also timed (`small_field_times`); then a 5-limb field
    must raise (`refuse_unbuilt_limbs`)."""
    import torch

    from montgomery_tpu_torch.concrete import example_fields
    from montgomery_tpu_torch.ops.field import create_field_ops

    say("== phase 7: the example fields' ops on the card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for name, F in example_fields().items():
        f = create_field_ops(F.p)
        t0 = time.perf_counter()
        out[name] = {"n": f.n, **example_field(name, f, gen, rates)}
        if f.n <= 3:
            out[name]["kernels"] = small_field_times(name, f, gen, rates)
        out[name]["seconds"] = time.perf_counter() - t0
        say(f"{name}: {out[name]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    refuse_unbuilt_limbs(dev)
    return out


def _msm_stats(run, dev) -> tuple[float, list, float]:
    """Median of 5 host-clock runs (after one warm-up) and the peak memory
    (MiB) of one more run."""
    import torch

    from montgomery_tpu_torch.utils.timing import timeit

    med, times = timeit(run, device=dev, reps=5, warmup=1)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    return med, times, torch.cuda.max_memory_allocated(dev) / 2**20


def phase_api(ctx, te, pts_full, te_full, expected: dict) -> tuple[dict, dict]:
    """The JAX package's API entries that the earlier phases do not run, on
    BLS12-377 and ed-on-bls12-377 bench points, each against the closed form
    and each with its launches counted (counts set to 0 just before it):
    (b) the non-GLV engines at 2^20 through msm_device on
    signed_digits_device digits (c = 13), median of 5 and peak memory;
    (c) window_chunk None and 4 on the affine-unsafe msm_device_full, None
    and 5 on the Twisted Edwards msm_device, at 2^20, side by side;
    (d) msm, msm_glv and EdwardsMsm.msm at 2^16 from Python ints, and the
    size sweep N = 2^12 -+ 17 on the safe and the unsafe engine through
    msm_full and msm; (e) is_on_curve and is_in_subgroup at 2^20 lanes,
    lanes 0-17 adversarial. Returns (launch counts by run, results)."""
    import torch

    from montgomery_tpu_torch.curves.edwards import EdwardsBatch
    from montgomery_tpu_torch.curves.projective import AffineBatch
    from montgomery_tpu_torch.msm.api import SCALAR_W
    from montgomery_tpu_torch.scalar.device import signed_digits_device
    from montgomery_tpu_torch.scalar.slicing import num_windows

    dev, q, qe = ctx.device, ctx.params.order, te.params.order
    E, Ee = oracle_curve(ctx.params), oracle_curve(te.params)
    N = 1 << API_WIDE_LOG2N
    launches, res = {}, {}
    A = AffineBatch(*[a[..., :N] for a in pts_full])
    P = EdwardsBatch(*[a[..., :N] for a in te_full])
    limbs = ctx.scalars_to_limbs(bench_scalars(q, N))
    te_limbs = te.scalars_to_limbs(bench_scalars(qe, N))
    want, te_want = (expected_sum(expected, c.params, N, pf.count) for c, pf in ((ctx, pts_full), (te, te_full)))

    def check(label, got, E_, w):
        if got.is_zero or not E_.equal(got, w):
            raise AssertionError(f"{label} differs from the closed form")

    # (b) the non-GLV engines
    say(f"== phase 7: the non-GLV engines of BLS12-377 at N=2^{API_WIDE_LOG2N}, c={NONGLV_C}")
    for path in PATHS:
        affine, unsafe = path != "projective", path == "affine_unsafe"

        def run(affine=affine, unsafe=unsafe):
            d = signed_digits_device(limbs, SCALAR_W, ctx.scalar_bits, NONGLV_C)
            return ctx.msm_device(A, d, NONGLV_C, affine=affine, unsafe=unsafe)

        counts, first, S = counted(run, f"nonglv_{path}", ctx.fops.n)
        check(f"non-GLV {path} at 2^{API_WIDE_LOG2N}", ctx.proj.to_host(S)[0], E, want)
        med, times, peak = _msm_stats(run, dev)
        launches[f"nonglv_{path}_2^{API_WIDE_LOG2N}"] = counts
        res[f"nonglv_{path}"] = {"median_s": med, "times_s": times, "peak_mib": peak}
        say(f"non-GLV {path} N=2^{API_WIDE_LOG2N} c={NONGLV_C} K={num_windows(ctx.scalar_bits, NONGLV_C)}: equal to the closed form; "
            f"median {med:.6f} s over 5 runs {['%.6f' % t for t in times]}; peak memory {peak:.1f} MiB; "
            f"launches {dict((k, v) for k, v in counts.items() if v)}")

    # (c) window_chunk
    c_te = te.default_c(N)
    te_d = te.digits_device(te_limbs, c_te)
    for label, path, runs in (
            ("bls12-377", "chunk_affine_unsafe",
             {wc: (lambda wc=wc: ctx.msm_device_full(A, limbs, ctx.default_c(N), affine=True, unsafe=True,
                                                     window_chunk=wc)) for wc in (None, WINDOW_CHUNK["bls12-377"])}),
            (TE_CURVE, "chunk_te",
             {wc: (lambda wc=wc: te.msm_device(P, te_d, c_te, window_chunk=wc)) for wc in (None, WINDOW_CHUNK[TE_CURVE])})):
        row = {}
        for wc, run in runs.items():
            counts, first, S = counted(run, path, ctx.fops.n if label == "bls12-377" else te.fops.n)
            got = ctx.proj.to_host(S)[0] if label == "bls12-377" else te.ed.to_host(S)[0]
            check(f"{label} window_chunk={wc}", got, E if label == "bls12-377" else Ee,
                  want if label == "bls12-377" else te_want)
            med, times, peak = _msm_stats(run, dev)
            launches[f"{path}_{wc}_2^{API_WIDE_LOG2N}"] = counts
            row[str(wc)] = {"median_s": med, "times_s": times, "peak_mib": peak}
        res[path] = row
        say(f"window_chunk on {label} N=2^{API_WIDE_LOG2N} ({path}): equal to the closed form; "
            + "; ".join(f"window_chunk={wc}: median {r['median_s']:.6f} s, peak {r['peak_mib']:.1f} MiB"
                        for wc, r in row.items()))

    # (d) the host entries from Python ints, and the size sweep
    n16 = 1 << API_LOG2N
    say(f"== phase 7: msm, msm_glv and EdwardsMsm.msm at N=2^{API_LOG2N} from Python ints")
    host = ctx.proj.affine_to_host(AffineBatch(*[a[..., :n16] for a in pts_full]))
    te_host = te.ed.to_host(EdwardsBatch(*[a[..., :n16] for a in te_full]))
    sc, te_sc = bench_scalars(q, n16), bench_scalars(qe, n16)
    w16, te_w16 = expected_sum(expected, ctx.params, n16, pts_full.count), expected_sum(
        expected, te.params, n16, te_full.count)
    for path, fn, E_, w in (("api_msm", lambda: ctx.msm(sc, host), E, w16),
                            ("api_msm_glv", lambda: ctx.msm_glv(sc, host), E, w16),
                            ("api_te_msm", lambda: te.msm(te_sc, te_host), Ee, te_w16)):
        counts, secs, got = counted(fn, path, ctx.fops.n if E_ is E else te.fops.n)
        check(path, got, E_, w)
        launches[f"{path}_2^{API_LOG2N}"] = counts
        res[path] = {"seconds": secs}
        say(f"{path} N=2^{API_LOG2N}: equal to the closed form in {secs:.3f} s (host digits and "
            f"points included); launches {dict((k, v) for k, v in counts.items() if v)}")
    for n in SWEEP_N:
        An = AffineBatch(*[a[..., :n] for a in pts_full])
        scn = bench_scalars(q, n)
        wn = closed_form(ctx.params, scn, SEED_POINTS, pts_full.count)
        for unsafe in (False, True):
            kind = "unsafe" if unsafe else "safe"
            for path, fn in ((f"sweep_{kind}", lambda: ctx.msm_full(scn, An, unsafe=unsafe)),
                             (f"sweep_msm_{kind}", lambda: ctx.msm(scn, An, affine=True, unsafe=unsafe))):
                counts, secs, got = counted(fn, path, ctx.fops.n)
                check(f"{path} N={n}", got, E, wn)
                launches[f"{path}_{n}"] = counts
                res.setdefault("sweep", {})[f"{path}_{n}"] = secs
        say(f"size sweep N={n}: msm_full and msm on the safe and the unsafe engine equal the closed form")

    # (e) the predicates at 2^20 lanes
    res.update(predicates(ctx, te, A, P, launches))
    return launches, res


def _adversarial_weierstrass(E, rng) -> list:
    """(p - 1, 0) (order 2 when b = 1), 16 points (x, sqrt(x^3 + b))
    without cofactor clearing, and the point at infinity."""
    from montgomery_tpu_torch.bigint import AffinePoint

    F, out = E.field, [AffinePoint(E.field.p - 1, 0)]
    while len(out) < SUBGROUP_ADV - 1:
        x = rng.randrange(F.p)
        y = F.sqrt((x * x * x + E.b) % F.p)
        if y is not None:
            out.append(AffinePoint(x, y))
    return out + [AffinePoint.zero()]


def _adversarial_edwards(E, rng) -> list:
    """(0, -1) (order 2), (+-1 / sqrt(-1), 0) (order 4), 14 points without
    cofactor clearing, and the identity."""
    from montgomery_tpu_torch.bigint import EdwardsPoint

    F = E.field
    i = F.inv(F.sqrt(F.p - 1))
    out = [EdwardsPoint(0, F.p - 1), EdwardsPoint(i, 0), EdwardsPoint(F.p - i, 0)]
    while len(out) < SUBGROUP_ADV - 1:
        x = rng.randrange(F.p)
        den = (1 - E.d * x * x) % F.p
        y = F.sqrt((1 + x * x) * F.inv(den) % F.p) if den else None
        if y is not None:
            out.append(EdwardsPoint(x, y))
    return out + [EdwardsPoint.zero()]


def predicates(ctx, te, A, P, launches: dict) -> dict:
    """is_on_curve and is_in_subgroup at 2^20 lanes: BLS12-377's bench
    points (projective, from_affine) and the Twisted Edwards ones, lanes
    0-17 replaced by `_adversarial_weierstrass` / `_adversarial_edwards`.
    The flags equal the oracle's on those lanes and are True on every other
    lane. Each call counted and timed (one run, host clock)."""
    import torch

    from montgomery_tpu_torch.curves.edwards import EdwardsBatch
    from montgomery_tpu_torch.curves.projective import AffineBatch

    say(f"== phase 7: is_on_curve and is_in_subgroup at {A.count} lanes, lanes 0-{SUBGROUP_ADV - 1} adversarial")
    rng = random.Random(21)
    out = {}
    for label, c in (("bls12-377", ctx), (TE_CURVE, te)):
        E = oracle_curve(c.params)
        if label == "bls12-377":
            adv = _adversarial_weierstrass(E, rng)
            head = c.proj.affine_to_device(adv, c.device)
            Pt = c.proj.from_affine(AffineBatch(*[torch.cat([h, a[..., SUBGROUP_ADV:]], dim=-1)
                                                  for h, a in zip(head, A)]))
            ops, tags = c.proj, ("on_curve", "subgroup")
        else:
            adv = _adversarial_edwards(E, rng)
            head = c.ed.to_device(adv, c.device)
            Pt = EdwardsBatch(*[torch.cat([h, a[..., SUBGROUP_ADV:]], dim=-1) for h, a in zip(head, P)])
            ops, tags = c.ed, ("te_on_curve", "te_subgroup")
        row = {}
        for tag, fn, oracle in ((tags[0], ops.is_on_curve, E.is_on_curve),
                                (tags[1], ops.is_in_subgroup, E.is_in_subgroup)):
            counts, secs, flags = counted(lambda fn=fn: fn(Pt), tag, c.fops.n)
            want = [oracle(p_) for p_ in adv]
            got = flags[:SUBGROUP_ADV].tolist()
            if got != want or not bool(flags[SUBGROUP_ADV:].all()):
                raise AssertionError(f"{label} {tag}: {got} against the oracle's {want}, or a bench "
                                     "point flagged False")
            launches[f"{tag}_2^{API_WIDE_LOG2N}"] = counts
            row[tag] = {"seconds": secs, "launches": {k: v for k, v in counts.items() if v},
                        "adversarial": got}
            say(f"{label} {tag} at {A.count} lanes: {secs:.4f} s (host clock, one run); adversarial lanes "
                f"{got} equal the oracle's, the rest True; launches {row[tag]['launches']}")
        out[label] = row
    return out


# ------------------------------------ BLS12-381 and Pallas: 13 and 9 limbs

# the Weierstrass curves beside BLS12-377, by their serve labels: their base
# fields need 13 limbs of 32 bits (BLS12-381) and 9 (Pallas)
NEW_CURVES = ("bls12-381", "pallas")
# the widths every new instantiation is checked at: one lane, a ragged
# warp, the few-lane add's threshold, the widest window_sums scan, and the
# kernel table's width with a ragged edge
CHECK_LANES = (1, 17, 40, 640, 1 << 16, (1 << 16) + 17)
POINT_LANES = 640  # input lanes built from curve points; wider checks add random planes after them
NEW_TIMING_REPS = 20  # launches a timing, by CUDA events and under the profiler
NEW_SQRT_LANES = 1 << 20  # the sqrt slice's timing width at 13 and 9 limbs
COMBINE_AT = {1: COMBINE_CASES[0], 17: COMBINE_CASES[1]}  # the combine's (K, c) by width
WIDE_COMBINE = (3, 2)  # the combine's (K, c) at the other widths
NEW_MSM_LOG2N = (16, 20)
NEW_UNSAFE_LOG2N = 18  # BLS12-381's unsafe engine also at the zprize22 size, 2^18
NEW_GEN_LOG2N = 16


def new_instantiations() -> list[tuple[str, int]]:
    """(kernel, limbs) of every Weierstrass kernel (those with a 13-limb
    entry point) at BLS12-381's 13 limbs and Pallas's 9, and of every
    kernel built for the 1-3 limb example fields at those counts."""
    from montgomery_tpu_torch.ops import alt_mul, kernels  # noqa: F401 (alt_mul registers barrett_mul)

    return ([(name, n) for name, k in kernels.REGISTRY.items() if 13 in k.symbols for n in (13, 9)]
            + [(name, n) for name, k in kernels.REGISTRY.items() for n in kernels.FIELD_LIMBS if n in k.symbols])


def phase_new_ptxas() -> dict:
    """Registers, stack frame, spill and shared memory of each kernel
    function of every Weierstrass kernel at 13 and 9 limbs (a kernel with a
    few-lane body has two), of every kernel at 1, 2 and 3 limbs, and of the
    kernels redesigned last (exp_ladder at 12 limbs too, ed_add and ed_dbl
    at 9), from the build's ptxas log; each must be there."""
    from montgomery_tpu_torch.ops import kernels

    found = ptxas_by_limbs(kernels.LIBRARY.build_log)
    out = {}
    say("ptxas of the instantiations for BLS12-381 (13 limbs), Pallas (9 limbs) and the 1-3 limb example fields, "
        "and of exp_ladder at 12, ed_add and ed_dbl at 9: registers, stack frame, spill stores, spill loads, "
        "shared memory (bytes)")
    for name, n in [*new_instantiations(), ("exp_ladder", 12), ("ed_add", 9), ("ed_dbl", 9)]:
        funcs = {f: v for (f, nl), v in found.items() if nl == n and f in (name, f"{name}_few")}
        if name not in {f.removesuffix("_few") for f in funcs}:
            raise AssertionError(f"no ptxas record of {name} at {n} limbs")
        for func, (regs, stack, st, ld, smem) in sorted(funcs.items()):
            say(f"  {func} n={n}: {regs} registers, stack {stack}, spill {st} / {ld}, smem {smem}"
                + ("   <- spills" if st or ld else ""))
            out.setdefault(name, {})[f"n{n}" + ("_few" if func.endswith("_few") else "")] = dict(
                registers=regs, stack=stack, spill_stores=st, spill_loads=ld, smem=smem)
    return out


def _widen(base, N: int, rand):
    """The first N lanes of `base` (rows, L), or, for N > L, rand(N) (rows,
    N) with `base` in its first L lanes."""
    L = base.shape[-1]
    if N <= L:
        return base[..., :N].contiguous()
    t = rand(N)
    t[..., :L] = base
    return t


def phase_curve_kernels(ctx, pts, rates: dict, widths: dict) -> dict:
    """Every kernel at the curve's limb count (13 for BLS12-381, 9 for
    Pallas) against its plain version on the same tensors, bit for bit in
    raw planes, at each width of CHECK_LANES. Inputs: field planes with 0,
    1, 2, p - 1, p, p + 1, 2p - 1, R mod p and R^2 mod p in the first lanes,
    then random values below 2^bits(p); projective pairs from curve points
    (`_add_inputs`: identities, P == Q, P == -Q, unreduced values); packed
    and planar affine operands with every flag class of `_flag_lanes`
    (doubling, cancellation, each operand infinite, unpaired lanes, y = 0
    at x = p - 1, unreduced representatives); window sums with identities
    (`_window_sums`); the sqrt slice on `_sqrt_plane` (known squares and
    non-squares). Beyond POINT_LANES lanes the inputs continue with random
    planes. Both bodies of proj_add_rcb and proj_dbl_rcb (k = 1, 6, 13) are
    checked at every width against one plain run, the combine at (K, c) of
    COMBINE_AT (the 2^20 and the 2^16 path's on one lane and on 17) and at
    WIDE_COMBINE at the other widths (its plain Horner takes about 6 s a
    call, host-bound, up to 640 lanes). Then each kernel
    is timed at widths[name] lanes (the 12-limb table's width; the sqrt
    slice's at NEW_SQRT_LANES) on random planes: CUDA-event mean and the
    profiler's device time a launch over NEW_TIMING_REPS launches, its plain
    version once, the bound from the same call's rates and the share (bound
    / device time)."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch, ProjectiveBatch
    from montgomery_tpu_torch.ops import divstep, kernels
    from montgomery_tpu_torch.ops.field import SQRT_WINDOW

    f, proj, aff, dev = ctx.fops, ctx.proj, ctx.affine, ctx.device
    n, p, label = f.n, f.p, ctx.params.label
    say(f"== phase 1: {label} kernels at {n} limbs against their plain versions")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    rng = random.Random(13)
    adv = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p, f.R2]
    P0, Q0 = _add_inputs(ctx, pts, POINT_LANES, rng)
    FA, FB, fsa, fsb, fhp = _flag_lanes(ctx, pts, POINT_LANES)
    windows = {Kc: _window_sums(ctx, pts, Kc[0], rng, lanes=POINT_LANES)[0]
               for Kc in (*COMBINE_CASES, WIDE_COMBINE)}
    results = {}

    def field_rand(rows):
        return lambda N: _random_planes(f, rows, N, gen)

    def bits(N):
        return torch.randint(0, 2, (1, N), dtype=torch.int32, device=dev, generator=gen)

    def packed_rand(N):
        t = _random_planes(f, 2 * n + 1, N, gen)
        t[2 * n] = (torch.randint(0, 8, (N,), device=dev, generator=gen) == 0).to(torch.int32)
        return t

    def record(name, err):
        r = results.setdefault(name, {"max_abs_err": 0, "widths": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def check(label_, kern, plain, N):
        """kern (or each of a list of kernel calls) against one plain run."""
        b = plain()
        b = b if isinstance(b, tuple) else (b,)
        for kn in kern if isinstance(kern, list) else [kern]:
            a = kn()
            a = a if isinstance(a, tuple) else (a,)
            err = _raw_err(a, b)
            if err:
                raise AssertionError(f"{label_} at {n} limbs and {N} lanes disagrees with its plain "
                                     f"version (max_abs_err {err})")
            record(label_.split()[0], err)
        return a

    for N in CHECK_LANES:
        x, y = _field_plane(f, N, gen, adv), _field_plane(f, N, gen, adv[::-1])
        P, Q = (ProjectiveBatch(*[_widen(a, N, field_rand(n)) for a in B]) for B in (P0, Q0))
        C = torch.cat([_widen(FA, N, packed_rand), _widen(FB, N, packed_rand)], dim=1)
        A, B = C[:, :N], C[:, N:]  # a level's two halves: column slices of one array
        sA, sB, hp = (_widen(t, N, bits) for t in (fsa, fsb, fhp))
        dinv = _field_plane(f, N, gen, adv)
        G = AffineBatch(A[:n], torch.where(sA != 0, f.neg(A[n:2 * n]), A[n:2 * n]), A[2 * n] != 0)
        H = AffineBatch(B[:n], torch.where(sB != 0, f.neg(B[n:2 * n]), B[n:2 * n]), B[2 * n] != 0)
        valid = hp[0] != 0
        cases = {
            "mul_const beta": (lambda: f.mul_const(x, proj.beta_mont),
                               lambda: f.mul_const_plain(x, proj.beta_mont)),
            "mul_const R^2": (lambda: f.mul_const(x, f.R2), lambda: f.mul_const_plain(x, f.R2)),
            "mont_mul": (lambda: f.mul(x, y), lambda: f.mul_plain(x, y)),
            "mont_sqr": (lambda: f.square(x), lambda: f.square_plain(x)),
            "divstep_inv_mont": (lambda: f.inv_root(x), lambda: divstep.inv_mont_plain(f, x)),
        }
        if N > 1:  # column slices, read in place through their row strides
            xs, ys = x[:, 1:], y[:, :-1]
            cases["mont_mul slice"] = (lambda: f.mul(xs, ys), lambda: f.mul_plain(xs, ys))
            cases["mont_sqr slice"] = (lambda: f.square(xs), lambda: f.square_plain(xs))
        # both bodies of the add and the doublings against one plain run
        cases["proj_add_rcb"] = ([lambda few=few: proj.add(P, Q, few=few) for few in (False, True)],
                                 lambda: proj.add_plain(P, Q))
        for k in (1, 6, 13):
            cases[f"proj_dbl_rcb k={k}"] = ([lambda k=k, few=few: proj.double_n(P, k, few=few)
                                             for few in (False, True)], lambda k=k: proj.double_n_plain(P, k))
        for (K, c), W0 in windows.items():
            if (K, c) != COMBINE_AT.get(N, WIDE_COMBINE):
                continue
            W = ProjectiveBatch(*[_widen(a.reshape(n, -1), N * K, field_rand(n)).reshape(n, N, K)
                                  for a in W0])
            cases[f"proj_combine_rcb K={K} c={c}"] = (lambda W=W, c=c: proj.combine(W, c),
                                                      lambda W=W, c=c: proj.combine_plain(W, c))
        Ab = AffineBatch(x, y, A[2 * n] != 0)
        denom = aff.pre_packed_u(A, B, hp)
        inv1, h = f.batch_inv_parent(denom)
        _, numer, flags = aff.pre_packed(A, B, sA, sB, hp)
        _, pnumer, pflags = aff.pre(G, H)
        cases.update({
            "pack_glv": (lambda: aff.pack_rows_glv(Ab), lambda: aff.pack_rows_glv_plain(Ab)),
            "aff_pre_packed_u": (lambda: aff.pre_packed_u(A, B, hp), lambda: aff.pre_packed_u_plain(A, B, hp)),
            "aff_post_packed_u": (lambda: aff.post_packed_u(A, B, sA, sB, inv1, denom, h, hp),
                                  lambda: aff.post_packed_u_plain(A, B, sA, sB, inv1, denom, h, hp)),
            "aff_pre_packed": (lambda: aff.pre_packed(A, B, sA, sB, hp),
                               lambda: aff.pre_packed_plain(A, B, sA, sB, hp)),
            "aff_post_packed": (lambda: aff.post_packed(A, B, sA, sB, dinv, numer, flags, hp),
                                lambda: aff.post_packed_plain(A, B, sA, sB, dinv, numer, flags, hp)),
            "aff_pre": (lambda: aff.pre(G, H), lambda: aff.pre_plain(G, H)),
            "aff_post": (lambda: aff.post(G, H, dinv, pnumer, pflags),
                         lambda: aff.post_plain(G, H, dinv, pnumer, pflags)),
            "aff_pre_unsafe": (lambda: aff.pre_unsafe(G.x, H.x, valid),
                               lambda: aff.pre_unsafe_plain(G.x, H.x, valid)),
            "aff_pre_unsafe without mask": (lambda: aff.pre_unsafe(G.x, H.x),
                                            lambda: aff.pre_unsafe_plain(G.x, H.x)),
            "aff_post_unsafe": (lambda: aff.post_unsafe(G, H, dinv), lambda: aff.post_unsafe_plain(G, H, dinv)),
        })
        for label_, (kern, plain) in cases.items():
            check(label_, kern, plain, N)
        sqrt_checks(f, N, gen, check)
        for r in results.values():
            r["widths"].append(N)
        say(f"{label} n={n} N={N}: every kernel bit for bit with its plain version ({len(cases)} cases "
            f"and the sqrt slice; {time.perf_counter() - t0:.1f} s into the phase)")
        del cases, x, y, P, Q, C, A, B, G, H, denom, inv1, numer, flags, pnumer, pflags
        torch.cuda.empty_cache()
    sqrt_wide(f, NEW_SQRT_LANES, gen, check)
    results["sqrt_win"]["widths"].append(NEW_SQRT_LANES)
    torch.cuda.empty_cache()
    results["exp_ladder"]["ladder"] = ladder_checks(f, NEW_SQRT_LANES, gen, rates)

    # -- proj_add_rcb's resident blocks a SM at this count, then timing at the
    # 12-limb table's widths, on random planes
    per_sm = getattr(kernels.LIBRARY.get(), kernels.symbols("proj_add_rcb_blocks_per_sm", n)[n])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = {"six": per_sm(0), "few": per_sm(1)}
    results["proj_add_rcb"]["blocks_per_sm"] = blocks
    say(f"proj_add_rcb n={n}: resident blocks a SM {blocks} (lanes a wave: six "
        f"{blocks['six'] * 32 * sms}, few {blocks['few'] * sms})")
    M, q = f.sqrt_M, f.sqrt_q_odd
    for name in sorted(results):
        W = NEW_SQRT_LANES if name in ("exp_ladder", "sqr_n", "sqrt_win") else widths[name]
        x, y = _random_planes(f, n, W, gen), _random_planes(f, n, W, gen)
        work = None
        if name == "mul_const":
            kern, plain = lambda: f.mul_const(x, proj.beta_mont), lambda: f.mul_const_plain(x, proj.beta_mont)
        elif name == "mont_mul":
            kern, plain = lambda: f.mul(x, y), lambda: f.mul_plain(x, y)
        elif name == "mont_sqr":
            kern, plain = lambda: f.square(x), lambda: f.square_plain(x)
        elif name == "divstep_inv_mont":
            kern, plain = lambda: f.inv_root(x), lambda: divstep.inv_mont_plain(f, x)
        elif name in ("proj_add_rcb", "proj_dbl_rcb"):
            P, Q = (ProjectiveBatch(*_random_planes(f, 3 * n, W, gen).split(n)) for _ in range(2))
            if name == "proj_add_rcb":
                kern, plain = lambda: proj.add(P, Q), lambda: proj.add_plain(P, Q)
            else:
                kern, plain = lambda: proj.double_n(P, 1), lambda: proj.double_n_plain(P, 1)
        elif name == "proj_combine_rcb":
            K, c = COMBINE_CASES[0]
            W3 = ProjectiveBatch(*_random_planes(f, 3 * n, W * K, gen).reshape(3, n, W, K))
            kern, plain = lambda: proj.combine(W3, c), lambda: proj.combine_plain(W3, c)
            products = (K - 1) * (c * 9 + 14)
            work = ((K + 1) * 3 * 4 * n, products * 2 * n * n, products * n)
        elif name in ("pack_glv", "aff_pre_packed_u", "aff_post_packed_u", "aff_pre_packed", "aff_post_packed"):
            C = torch.cat([packed_rand(W), packed_rand(W)], dim=1)
            A, B = C[:, :W], C[:, W:]
            sA, sB, hp = bits(W), bits(W), bits(W)
            Ab = AffineBatch(x, y, A[2 * n] != 0)
            denom = aff.pre_packed_u(A, B, hp)
            inv1, h = f.batch_inv_parent(denom)
            _, numer, flags = aff.pre_packed(A, B, sA, sB, hp)
            kern, plain = {
                "pack_glv": (lambda: aff.pack_rows_glv(Ab), lambda: aff.pack_rows_glv_plain(Ab)),
                "aff_pre_packed_u": (lambda: aff.pre_packed_u(A, B, hp),
                                     lambda: aff.pre_packed_u_plain(A, B, hp)),
                "aff_post_packed_u": (lambda: aff.post_packed_u(A, B, sA, sB, inv1, denom, h, hp),
                                      lambda: aff.post_packed_u_plain(A, B, sA, sB, inv1, denom, h, hp)),
                "aff_pre_packed": (lambda: aff.pre_packed(A, B, sA, sB, hp),
                                   lambda: aff.pre_packed_plain(A, B, sA, sB, hp)),
                "aff_post_packed": (lambda: aff.post_packed(A, B, sA, sB, y, numer, flags, hp),
                                    lambda: aff.post_packed_plain(A, B, sA, sB, y, numer, flags, hp)),
            }[name]
        elif name in ("aff_pre", "aff_post", "aff_pre_unsafe", "aff_post_unsafe"):
            inf = torch.randint(0, 8, (2, W), device=dev, generator=gen) == 0
            G = AffineBatch(x, y, inf[0])
            H = AffineBatch(*_random_planes(f, 2 * n, W, gen).split(n), inf[1])
            valid = inf[0]
            _, numer, flags = aff.pre(G, H)
            dinv = _random_planes(f, n, W, gen)
            kern, plain = {
                "aff_pre": (lambda: aff.pre(G, H), lambda: aff.pre_plain(G, H)),
                "aff_post": (lambda: aff.post(G, H, dinv, numer, flags),
                             lambda: aff.post_plain(G, H, dinv, numer, flags)),
                "aff_pre_unsafe": (lambda: aff.pre_unsafe(G.x, H.x, valid),
                                   lambda: aff.pre_unsafe_plain(G.x, H.x, valid)),
                "aff_post_unsafe": (lambda: aff.post_unsafe(G, H, dinv),
                                    lambda: aff.post_unsafe_plain(G, H, dinv)),
            }[name]
        elif name == "exp_ladder":
            e = (q - 1) // 2
            kern, plain = lambda: f.exp_ladder(x, e), lambda: f.exp_ladder_plain(x, e)
            work = sqrt_work(f, "exp_ladder", e=e)
        elif name == "sqr_n":
            m = max(M - SQRT_WINDOW, 1)  # the first chain, or one squaring where M <= 4
            kern, plain = lambda: f.sqr_n(x, m), lambda: f.sqr_n_plain(x, m)
            work = sqrt_work(f, "sqr_n", m=m)
        elif name == "sqrt_win":
            lk = min(SQRT_WINDOW, M)
            t = f.exp_ladder(x, q)  # x^q, in the 2-Sylow subgroup
            r = f.mul(x, f.exp_ladder(x, (q - 1) // 2))
            s = f.sqr_n(t, M - lk)
            last = lk == M
            kern, plain = (lambda: f.sqrt_window(t, r, s, 0, lk, last),
                           lambda: f.sqrt_window_plain(t, r, s, 0, lk, last))
            work = sqrt_work(f, "sqrt_win", last=last, s_is_t=s is t)
        else:
            raise AssertionError(f"no timing case for {name}")
        a = kern()
        b, plain_ms = timed_once(plain)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if _raw_err(a, b):
            raise AssertionError(f"{name} at {n} limbs and {W} lanes (timing inputs) disagrees")
        ms, dev_ms = launch_times(kern, name)
        lanes = 1 if name == "proj_combine_rcb" else W
        batches = divstep_batches(f, x)[0] if name == "divstep_inv_mont" else None
        bms, by = bound_of(*work, lanes, rates) if work else bound(ctx, name, W, rates, batches)
        share = bms / dev_ms if dev_ms else None
        results[name].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             share=share, lanes=lanes)
        say(f"{name} n={n} at {lanes} lanes ({time.perf_counter() - t0:.1f} s into the phase): events "
            f"{ms:.4f} ms, device "
            + (f"{dev_ms:.4f} ms" if dev_ms else "not measured") + f", plain {plain_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})" + (f", share {share:.3f}" if share else ""))
        del kern, plain, x, y
        torch.cuda.empty_cache()
    return results


def phase_new_curves(ctx12, rates: dict, kres: dict, launches: dict, expected: dict, t_start: float) -> dict:
    """BLS12-381 (13 limbs) and Pallas (9 limbs), each on its own 2^20 bench
    points (random_points_fast(seed=42)): phase 1, every kernel at the
    curve's limb count against its plain version and timed at the 12-limb
    table's widths (`phase_curve_kernels`); phase 2, every engine and
    compute_msm against the bigint oracle (`phase_oracle`); phase 3, every
    engine at 2^16 and 2^20 (and BLS12-381's unsafe one at 2^18) against the
    closed form, with its launches (every one at the curve's limb count),
    median of 5, peak memory and phase split, the profile of affine-unsafe
    at 2^20, and compute_msm at 2^20 from bytes; phase 4,
    random_points_weierstrass at 2^16; phase 1 also holds the chord's two
    kernels against their plain versions at the main paths' shapes
    (`redesign_chord`). Launch counts go into `launches` as
    "<curve>/<run>_2^<log2 N>"; returns {curve: kernel results}."""
    import torch

    from montgomery_tpu_torch.concrete import WEIERSTRASS_CURVES
    from montgomery_tpu_torch.curves.random import random_points_fast
    from montgomery_tpu_torch.msm import WeierstrassMsm

    widths = {name: r["lanes"] for name, r in kres.items() if "lanes" in r}
    out = {}
    for label in NEW_CURVES:
        c = WeierstrassMsm(WEIERSTRASS_CURVES[label], device=torch.device("cuda", 0))
        t0 = time.perf_counter()
        pts = random_points_fast(c.proj, 1 << max(NEW_MSM_LOG2N), seed=SEED_POINTS, device=c.device,
                                 cache_dir=ROOT / "build" / "points")
        torch.cuda.synchronize()
        say(f"points ({label}): 2^{max(NEW_MSM_LOG2N)} from random_points_fast(seed={SEED_POINTS}) in "
            f"{time.perf_counter() - t0:.1f} s")
        host = c.proj.affine_to_host(type(pts)(*[a[..., :4096] for a in pts]))
        out[label] = phase_curve_kernels(c, host, rates, widths)
        say(f"[{time.perf_counter() - t_start:.1f} s] {label}: phase_curve_kernels done")
        out[label]["divstep_inv_mont"]["main_path"] = redesign_divstep(c, pts, rates)
        out[label]["proj_dbl_rcb"]["carry_chain"] = redesign_dbl(c, pts, rates)
        for name, res in redesign_chord(c, host, rates).items():
            out[label][name]["carry_chain"] = res
        say(f"[{time.perf_counter() - t_start:.1f} s] {label}: phase 1 done")
        phase_oracle(c, host, label)
        sizes = {path: NEW_MSM_LOG2N for path in PATHS}
        if label == "bls12-381":
            sizes["affine_unsafe"] = tuple(sorted({*NEW_MSM_LOG2N, NEW_UNSAFE_LOG2N}))
        for path in PATHS:
            for log2n in sizes[path]:
                launches[f"{label}/{path}_2^{log2n}"] = phase_msm(c, log2n, pts, path, expected)
        launches[f"{label}/serve_2^{max(NEW_MSM_LOG2N)}"] = phase_serve(c, pts, max(NEW_MSM_LOG2N), expected,
                                                                        label)
        del pts
        torch.cuda.empty_cache()
        launches[f"{label}/points_2^{NEW_GEN_LOG2N}"] = phase_points(c, "points", NEW_GEN_LOG2N)
        say(f"[{time.perf_counter() - t_start:.1f} s] {label}: phases 2-4 done")
    return out


# ------------------------------------------ phase 8: curves with a != 0

# the general-a witnesses (montgomery_tpu_torch/testing/curves.py): NIST P-256
# at 9 limbs of 32 bits, its engines at 2^16 and 2^20; NIST P-384 at 13, its
# engines at 2^16
GA_CHECK_LANES = (1, 17, 640, 1 << 16, (1 << 16) + 17)
GA_MSM_LOG2N = (16, 20)
GA_P384_LOG2N = 16
GA_ORACLE_N = (16, 512)  # P-256 against the bigint oracle; P-384 at the first
GA_PRED_LANES = 1 << 16
GA_PLANAR_LANES = 1 << 20
GA_SAMPLE = 1024  # planar lanes checked against the oracle
GA_TIMING_REPS = 20
# ptxas of aff_pre and aff_pre_packed before the a term (registers, stack
# frame, spill stores, spill loads, smem bytes; PR 17's build on an H100):
# the a = 0 instantiation must keep these registers
PARENT_PRE_PTXAS = {("aff_pre", 9): (96, 0, 0, 0, 0), ("aff_pre", 12): (134, 0, 0, 0, 0),
                    ("aff_pre", 13): (128, 0, 0, 0, 0), ("aff_pre_packed", 9): (96, 0, 0, 0, 0),
                    ("aff_pre_packed", 12): (132, 0, 0, 0, 0), ("aff_pre_packed", 13): (128, 8, 4, 4, 0)}
# the general-a paths: the group law on mont_mul and mont_sqr, never an RCB kernel
_GA = {"mont_mul", "mont_sqr"}
PATH_KERNELS.update({
    "ga_projective": _GA,
    "ga_affine_safe": _GA | _SAFE | {"divstep_inv_mont"},
    "ga_affine_unsafe": _GA | _UNSAFE | {"divstep_inv_mont"},
    "ga_planar": {"aff_pre", "aff_post", "mont_mul", "divstep_inv_mont"},
    "ga_on_curve": {"mont_mul"},
    "ga_subgroup": _GA,
})
_GA_FORBIDDEN = _NONGLV | _EDWARDS | _PLANAR | _ALT | {"glv_digits", "pack_glv"}
PATH_FORBIDDEN.update({
    "ga_projective": _GA_FORBIDDEN | _SAFE | _UNSAFE,
    "ga_affine_safe": _GA_FORBIDDEN | _UNSAFE,
    "ga_affine_unsafe": _GA_FORBIDDEN | _SAFE,
    "ga_planar": (_GA_FORBIDDEN | _SAFE | _UNSAFE) - PATH_KERNELS["ga_planar"],
    "ga_on_curve": _GA_FORBIDDEN | _SAFE | _UNSAFE,
    "ga_subgroup": _GA_FORBIDDEN | _SAFE | _UNSAFE,
})


# Plain16's carries on the card (the field ops between the general-a law's
# products): widths about LOOKAHEAD_LANES (add and sub carry twice their
# lanes side by side) and the plain checks' 2^20
GA_PLAIN16_LANES = (1, 17, 640, 1 << 16, (1 << 16) + 17, 1 << 17, (1 << 17) + 1, 1 << 18, (1 << 18) + 1,
                    1 << 20)


def ga_plain16(dev=None, lanes=GA_PLAIN16_LANES) -> dict:
    """Plain16's carry_up, lookahead_carry, add, sub, neg, reduce, add_lazy,
    sub_lazy and sub_positive on `dev` (the card) against the same ops on the
    limb loop (`carry`) alone, bit for bit, at 9, 12 and 13 limbs of 32 bits
    (P-256, BLS12-377, P-384) and GA_PLAIN16_LANES lanes: values below
    2^bits(p) < 2p from default_rng(SEED_SCALARS), the first lanes 0, 1,
    p - 1, p, p + 1 and 2p - 1, y the lanes of x reversed and 4p - 1 in
    sub_lazy's first lane. Returns the lanes checked by curve."""
    import numpy as np
    import torch

    from montgomery_tpu_torch.concrete import BLS12_377
    from montgomery_tpu_torch.ops.field import Plain16, create_field_ops
    from montgomery_tpu_torch.testing.curves import P256, P384

    dev = dev or torch.device("cuda", 0)
    rng = np.random.default_rng(SEED_SCALARS)
    out = {}
    for params in (P256, BLS12_377, P384):
        f = create_field_ops(params.modulus)
        F, p, L = f.plain, f.p, f.plain.L
        bits = p.bit_length()
        C = F.carry

        def k(v, x):
            return F.const(v, x)

        def lin(t, c=0):
            return C(t + k(c, t))[0]

        def add(x, y):
            z = lin(x + y)
            d, c = C(z - k(2 * p, z))
            return torch.where((c < 0)[None], z, d)

        def sub(x, y):
            d, c = C(x - y)
            return torch.where((c < 0)[None], lin(d, 2 * p), d)

        def neg(x, _):
            d = lin(k(2 * p, x) - x)
            d2, c = C(d - k(2 * p, d))
            return torch.where((c < 0)[None], d, d2)

        def reduce(x, _):
            d, c = C(x - k(p, x))
            return torch.where((c < 0)[None], x, d)

        ref = {"add_lazy": lambda x, y: lin(x + y), "sub_lazy": lambda x, y: lin(x - y, 4 * p),
               "sub_positive": lambda x, y: lin(x - y, 2 * p), "add": add, "sub": sub, "neg": neg,
               "reduce": reduce}
        for N in lanes:
            limbs = rng.integers(0, 1 << 16, size=(L, N), dtype=np.int64)
            for i in range(L):
                keep = bits - 16 * i
                if keep < 16:
                    limbs[i] &= (1 << max(keep, 0)) - 1
            for j, v in enumerate((0, 1, p - 1, p, p + 1, 2 * p - 1)[:N]):
                limbs[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(L)]
            x = torch.from_numpy(limbs).to(dev)
            y = x.flip(-1)
            y4 = y.clone()
            y4[:, 0] = torch.tensor([((4 * p - 1) >> (16 * i)) & 0xFFFF for i in range(L)], device=dev)
            for name, want in ref.items():
                b = y4 if name == "sub_lazy" else y
                got = getattr(F, name)(x) if name in ("neg", "reduce") else getattr(F, name)(x, b)
                if not torch.equal(got, want(x, b)):
                    raise AssertionError(f"Plain16.{name} ({params.label}, {N} lanes) differs from the limb loop")
            for name in ("carry_up", "lookahead_carry"):
                got, want = getattr(Plain16, name)(x + y), C(x + y)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"Plain16.{name} ({params.label}, {N} lanes) differs from the limb loop")
        out[params.label] = list(lanes)
        say(f"Plain16 on {dev} ({params.label}, {L} limbs of 16 bits): carry_up, lookahead_carry, add, "
            f"sub, neg, reduce and the lazy ops equal the limb loop at {list(lanes)} lanes "
            f"(LOOKAHEAD_LANES = {Plain16.LOOKAHEAD_LANES[dev.type]})")
    return out


def ga_scalars(q: int, N: int) -> list[int]:
    """N scalars mod q from numpy's default_rng(SEED_SCALARS): 8 bytes above
    q's own a scalar, so a 384-bit q gets full-width scalars too."""
    import numpy as np

    nb = (q.bit_length() + 7) // 8 + 8
    raw = np.random.default_rng(SEED_SCALARS).integers(0, 256, size=N * nb, dtype=np.uint8).tobytes()
    return [int.from_bytes(raw[nb * i: nb * (i + 1)], "little") % q for i in range(N)]


def ga_ptxas() -> dict:
    """ptxas of aff_pre and aff_pre_packed at 9, 12 and 13 limbs, each
    instantiation: WITH_A false (the a = 0 curves) must keep the parent's
    registers, and neither may be missing."""
    from montgomery_tpu_torch.ops import kernels

    funcs = ptxas_functions(kernels.LIBRARY.build_log)
    out = {}
    for name in ("aff_pre", "aff_pre_packed"):
        for n in (9, 12, 13):
            row = {}
            for flag in (0, 1):
                hit = [v for f_, v in funcs.items() if re.match(rf"_Z\d+{name}_kernelILi{n}ELb{flag}E", f_)]
                if len(hit) != 1:
                    raise AssertionError(f"no ptxas record of {name} at {n} limbs, WITH_A {flag}")
                row["a" if flag else "a0"] = hit[0]
            parent = PARENT_PRE_PTXAS[name, n]
            say(f"  {name} n={n}: a = 0 {row['a0']} (parent {parent}), with a {row['a']} (registers, stack, "
                "spill stores, spill loads, smem)")
            if row["a0"][0] != parent[0]:
                raise AssertionError(f"{name} at {n} limbs, a = 0: {row['a0'][0]} registers, the parent "
                                     f"{parent[0]}")
            out[f"{name}_n{n}"] = {"a0": row["a0"], "a": row["a"], "parent": parent}
    return out


def ga_kernels(ctx, host, rates: dict, widths: dict) -> dict:
    """aff_pre and aff_pre_packed with the a term at the context's limb
    count, bit for bit against their plain versions at GA_CHECK_LANES (the
    flag classes of `_flag_lanes` first: doublings, cancellations, infinite
    operands, unpaired lanes; then random planes), then timed at the 12-limb
    table's widths: CUDA-event mean and the profiler's device time a launch
    over GA_TIMING_REPS launches, the plain version once, bound and share."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch

    f, aff, dev = ctx.fops, ctx.affine, ctx.device
    n = f.n
    gen = torch.Generator(device=dev).manual_seed(19)
    FA, FB, fsa, fsb, fhp = _flag_lanes(ctx, host, POINT_LANES)

    def packed_rand(N):
        t = _random_planes(f, 2 * n + 1, N, gen)
        t[2 * n] = (torch.randint(0, 8, (N,), device=dev, generator=gen) == 0).to(torch.int32)
        return t

    def bits(N):
        return torch.randint(0, 2, (1, N), dtype=torch.int32, device=dev, generator=gen)

    def operands(N, base=True):
        if base:
            C = torch.cat([_widen(FA, N, packed_rand), _widen(FB, N, packed_rand)], dim=1)
            sA, sB, hp = (_widen(t, N, bits) for t in (fsa, fsb, fhp))
        else:
            C = torch.cat([packed_rand(N), packed_rand(N)], dim=1)
            sA, sB, hp = bits(N), bits(N), bits(N)
        A, B = C[:, :N], C[:, N:]
        G = AffineBatch(A[:n], torch.where(sA != 0, f.neg(A[n:2 * n]), A[n:2 * n]), A[2 * n] != 0)
        H = AffineBatch(B[:n], torch.where(sB != 0, f.neg(B[n:2 * n]), B[n:2 * n]), B[2 * n] != 0)
        return {"aff_pre_packed": (lambda: aff.pre_packed(A, B, sA, sB, hp),
                                   lambda: aff.pre_packed_plain(A, B, sA, sB, hp)),
                "aff_pre": (lambda: aff.pre(G, H), lambda: aff.pre_plain(G, H))}

    out = {name: {"widths": [], "max_abs_err": 0} for name in ("aff_pre", "aff_pre_packed")}
    for N in GA_CHECK_LANES:
        for name, (kern, plain) in operands(N).items():
            err = _raw_err(kern(), plain())
            if err:
                raise AssertionError(f"{name} with a at {n} limbs and {N} lanes disagrees with its plain "
                                     f"version (max_abs_err {err})")
            out[name]["widths"].append(N)
    say(f"{ctx.params.label} n={n}: aff_pre and aff_pre_packed with the a term bit for bit with their plain "
        f"versions at {list(GA_CHECK_LANES)} lanes (every flag class first)")
    for name in ("aff_pre", "aff_pre_packed"):
        W = widths[name]
        kern, plain = operands(W, base=False)[name]
        got = kern()
        want, plain_ms = timed_once(plain)
        if _raw_err(got, want):
            raise AssertionError(f"{name} with a at {n} limbs and {W} lanes (timing inputs) disagrees")
        ms = cuda_time_ms(kern, GA_TIMING_REPS)
        per = device_times_whole(lambda: [kern() for _ in range(GA_TIMING_REPS)],
                                 lambda res: res[0].get(name, (0,))[0] == GA_TIMING_REPS)[0]
        count, dms = per.get(name, (0, 0.0))
        dev_ms = dms / count if count else None
        bms, by = bound(ctx, name, W, rates)
        out[name].update(lanes=W, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         share=bms / dev_ms if dev_ms else None)
        say(f"{name} with a, n={n} at {W} lanes: events {ms:.4f} ms, device "
            + (f"{dev_ms:.4f} ms" if dev_ms else "not measured") + f", plain {plain_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})" + (f", share {bms / dev_ms:.3f}" if dev_ms else ""))
    return out


def ga_oracle(c, host):
    """The three engines through `msm` (host digits, no GLV) against the
    bigint oracle at GA_ORACLE_N (P-384: the first): the projective and the
    safe engine on `_adversarial_inputs` (duplicates, negations, infinity,
    scalars 0, 1 and q - 1), the unsafe one on distinct bench points; and
    the GLV entries refusing a curve without an endomorphism."""
    from montgomery_tpu_torch.bigint import msm as oracle_msm

    E = oracle_curve(c.params)
    q = c.params.order
    rng = random.Random(8)
    base = [E.random_point(rng) for _ in range(24)]
    sizes = GA_ORACLE_N if c.fops.n == 9 else GA_ORACLE_N[:1]
    for N in sizes:
        pts_adv, sc = _adversarial_inputs(E, base, N, rng)
        want = oracle_msm(E, sc, pts_adv)
        clean = host[:N]
        sc_clean = [rng.randrange(q) for _ in range(N)]
        sc_clean[0], sc_clean[2], sc_clean[3] = 0, 1, q - 1
        want_clean = oracle_msm(E, sc_clean, clean)
        for engine, kw, pts_, sc_, w in (("projective", dict(affine=False), pts_adv, sc, want),
                                         ("affine-safe", dict(affine=True), pts_adv, sc, want),
                                         ("affine-unsafe", dict(affine=True, unsafe=True), clean, sc_clean,
                                          want_clean)):
            t0 = time.perf_counter()
            got = c.msm(sc_, pts_, **kw)
            if not E.equal(got, w):
                raise AssertionError(f"{c.params.label} {engine} msm at N={N} differs from the oracle")
            say(f"{c.params.label} {engine} msm N={N} c={c.default_c(N)}: equal to the oracle "
                f"({time.perf_counter() - t0:.2f} s incl. host digits)")
    for label, call in (("digits_device", lambda: c.digits_device(c.scalars_to_limbs([1]), 4)),
                        ("msm_full", lambda: c.msm_full([1], host[:1]))):
        try:
            call()
        except ValueError as e:
            say(f"{c.params.label} {label}: ValueError ({e})")
        else:
            raise AssertionError(f"{c.params.label} {label} accepted a curve without an endomorphism")


def ga_msm(c, log2n: int, pts_full, path: str, expected: dict, stats: bool) -> tuple[dict, dict]:
    """One engine through msm_device on signed_digits_device digits at
    N = 2^log2n (c = default_c): launches of a run with the counts set to 0
    just before it (none of an RCB kernel) and its peak memory, the closed
    form, and with `stats` one run split into msm_device's stages and the
    median of 5 more (the first run their warm-up: a P-256 MSM takes
    seconds)."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch
    from montgomery_tpu_torch.msm.api import SCALAR_W
    from montgomery_tpu_torch.msm.pippenger import bucket_accumulate, reduce_buckets
    from montgomery_tpu_torch.scalar.device import signed_digits_device
    from montgomery_tpu_torch.scalar.slicing import num_windows
    from montgomery_tpu_torch.utils.timing import PhaseLog, timeit

    N = 1 << log2n
    cw = c.default_c(N)
    engine = path.removeprefix("ga_")
    affine, unsafe = engine != "projective", engine == "affine_unsafe"
    A = AffineBatch(*[a[..., :N] for a in pts_full])
    q = c.params.order
    key = (c.params.label, "ga", N)
    if key not in expected:
        expected[key] = closed_form(c.params, ga_scalars(q, N), SEED_POINTS, pts_full.count)
    limbs = c.scalars_to_limbs(ga_scalars(q, N))

    def run():
        d = signed_digits_device(limbs, SCALAR_W, c.scalar_bits, cw)
        return c.msm_device(A, d, cw, affine=affine, unsafe=unsafe)

    group = c.adapter if not affine else (c.aff_adapter_unsafe if unsafe else c.aff_adapter)
    log = PhaseLog()

    def staged():  # msm_device's stages, each ended by a synchronize
        with log.phase("digits (signed windows)", c.device):
            d = signed_digits_device(limbs, SCALAR_W, c.scalar_bits, cw)
        with log.phase("pack rows" if affine else "from_affine", c.device):
            P = group.pack_rows(A) if affine else group.from_points(A)
        with log.phase("accumulate", c.device):
            buckets, K, L = bucket_accumulate(group, P, d, cw)
        with log.phase("reduce+combine", c.device):
            if affine:
                buckets = group.to_projective(buckets)
            return reduce_buckets(c.adapter, buckets, cw, K, L)

    torch.cuda.reset_peak_memory_stats(c.device)
    counts, first, S = counted(run, path, c.fops.n)
    peak = torch.cuda.max_memory_allocated(c.device) / 2**20
    E = oracle_curve(c.params)
    got = c.proj.to_host(S)[0]
    if got.is_zero or not E.equal(got, expected[key]):
        raise AssertionError(f"{c.params.label} {engine} at N=2^{log2n} differs from the closed form")
    res = {"launches": {k: v for k, v in counts.items() if v}, "first_s": first, "peak_mib": peak}
    if stats:
        staged()
        med, times = timeit(run, device=c.device, reps=5, warmup=0)
        res.update(median_s=med, times_s=times, split=dict(log.entries))
        say(f"{c.params.label} {engine} N=2^{log2n} c={cw} K={num_windows(c.scalar_bits, cw)}: median "
            f"{med:.6f} s over 5 runs {['%.6f' % t for t in times]}; peak memory {peak:.1f} MiB; phase "
            "split:\n" + log.report())
    say(f"{c.params.label} {engine} N=2^{log2n}: equal to the closed form (first run {first:.3f} s); "
        f"launches {res['launches']}")
    return counts, res


def ga_adversarial(c, pts_full, log2n: int = 16, log2base: int = 12) -> dict:
    """phase_adversarial's safe set on P-256 through msm_device on
    signed_digits_device digits: 2^log2base bench points, each used
    2^(log2n - log2base) times under one scalar, negated where
    (j + k) % 5 == 1, infinite where (j + k) % 7 == 3, scalar 0 where
    j % 11 == 0; the safe and the projective engine equal the closed form.
    The duplicates double in aff_pre_packed's lanes: its a term."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch
    from montgomery_tpu_torch.msm.api import SCALAR_W
    from montgomery_tpu_torch.scalar.device import signed_digits_device

    N, nb = 1 << log2n, 1 << log2base
    cw = c.default_c(N)
    q, f, dev = c.params.order, c.fops, c.device
    base = [0 if j % 11 == 0 else s for j, s in enumerate(ga_scalars(q, nb))]
    j = torch.arange(N, device=dev) % nb
    k = torch.arange(N, device=dev) // nb
    neg, inf = (j + k) % 5 == 1, (j + k) % 7 == 3
    x, y = pts_full.x.index_select(1, j), pts_full.y.index_select(1, j)
    y = torch.where(neg[None], f.neg(y), y)
    zero = torch.zeros_like(x)
    A = AffineBatch(torch.where(inf[None], zero, x), torch.where(inf[None], zero, y), inf)
    sign = torch.where(inf, 0, torch.where(neg, -1, 1)).cpu().tolist()
    coef = [0] * nb
    for i, sg in enumerate(sign):
        coef[i % nb] += sg
    limbs = c.scalars_to_limbs([base[i % nb] for i in range(N)])
    d = signed_digits_device(limbs, SCALAR_W, c.scalar_bits, cw)
    counts, first, S = counted(lambda: c.msm_device(A, d, cw, affine=True), "ga_affine_safe", f.n)
    E = oracle_curve(c.params)
    want = closed_form(c.params, [s * cf % q for s, cf in zip(base, coef)], SEED_POINTS, pts_full.count)
    proj = c.proj.to_host(c.msm_device(A, d, cw, affine=False))[0]
    if not (E.equal(c.proj.to_host(S)[0], want) and E.equal(proj, want)):
        raise AssertionError(f"{c.params.label} adversarial safe MSM differs from the closed form")
    say(f"{c.params.label} adversarial safe MSM N=2^{log2n}: equal to the closed form and the projective "
        f"engine ({sum(neg.tolist())} negated, {sum(inf.tolist())} infinite); rounds {c.aff_adapter.rounds}; "
        f"launches {dict((k_, v) for k_, v in counts.items() if v)}")
    return counts


def ga_predicates(c, pts_full, launches: dict) -> dict:
    """is_on_curve and is_in_subgroup (projective) at GA_PRED_LANES lanes of
    P-256 bench points, lanes 0 to SUBGROUP_ADV - 2 replaced by off-curve
    points (x + 1, y) and the last of them by the point at infinity: the
    flags equal the oracle's there and are True elsewhere."""
    import torch

    from montgomery_tpu_torch.bigint import AffinePoint
    from montgomery_tpu_torch.curves.projective import AffineBatch

    E = oracle_curve(c.params)
    p = E.field.p
    host = c.proj.affine_to_host(AffineBatch(*[a[..., :SUBGROUP_ADV] for a in pts_full]))
    adv = [AffinePoint((P.x + 1) % p, P.y) for P in host[:SUBGROUP_ADV - 1]] + [AffinePoint.zero()]
    head = c.proj.affine_to_device(adv, c.device)
    N = GA_PRED_LANES
    Pt = c.proj.from_affine(AffineBatch(*[torch.cat([h, a[..., SUBGROUP_ADV:N]], dim=-1)
                                          for h, a in zip(head, pts_full)]))
    out = {}
    for tag, fn, oracle in (("ga_on_curve", c.proj.is_on_curve, E.is_on_curve),
                            ("ga_subgroup", c.proj.is_in_subgroup, E.is_in_subgroup)):
        counts, secs, flags = counted(lambda fn=fn: fn(Pt), tag, c.fops.n)
        want = [oracle(P) for P in adv]
        got = flags[:SUBGROUP_ADV].tolist()
        if got != want or not bool(flags[SUBGROUP_ADV:].all()):
            raise AssertionError(f"{c.params.label} {tag}: {got} against the oracle's {want}")
        launches[f"{c.params.label}/{tag}_2^16"] = counts
        out[tag] = {"seconds": secs, "launches": {k: v for k, v in counts.items() if v}}
        say(f"{c.params.label} {tag} at {N} lanes: {secs:.4f} s (host clock, one run); adversarial lanes "
            f"{got} equal the oracle's, the rest True; launches {out[tag]['launches']}")
    return out


def ga_planar(c, pts_full, launches: dict) -> dict:
    """The planar safe add and batch_double of P-256 at GA_PLANAR_LANES
    lanes: G the bench points, H rolled by one lane with every 8th lane a
    doubling (H = G), every 9th a cancellation (H = -G) and every 10th lane
    of G infinite; GA_SAMPLE sampled lanes of each against the oracle. The
    add counted (aff_pre with its a term, aff_post, the inversion)."""
    import torch

    from montgomery_tpu_torch.curves.projective import AffineBatch

    f, dev = c.fops, c.device
    E = oracle_curve(c.params)
    N = GA_PLANAR_LANES
    lane = torch.arange(N, device=dev)
    dbl, cancel, inf = lane % 8 == 0, lane % 9 == 0, lane % 10 == 0
    G = AffineBatch(pts_full.x[:, :N], pts_full.y[:, :N], inf)
    hx, hy = pts_full.x[:, :N].roll(1, -1), pts_full.y[:, :N].roll(1, -1)
    hx = torch.where((dbl | cancel)[None], G.x, hx)
    hy = torch.where(dbl[None], G.y, torch.where(cancel[None], f.neg(G.y), hy))
    H = AffineBatch(hx.contiguous(), hy.contiguous(), torch.zeros(N, dtype=torch.bool, device=dev))
    counts, secs, S = counted(lambda: c.affine.batch_add(G, H), "ga_planar", f.n)
    t0 = time.perf_counter()
    D = c.affine.batch_double(G)
    torch.cuda.synchronize()
    dsecs = time.perf_counter() - t0
    lanes = sorted({0, 8, 9, 10, 72, *random.Random(9).sample(range(N), GA_SAMPLE - 5)})
    pick = torch.tensor(lanes, device=dev)

    def host(B):
        return c.proj.affine_to_host(AffineBatch(B.x.index_select(1, pick), B.y.index_select(1, pick),
                                                 B.inf.index_select(0, pick)))

    g, h, s, d = host(G), host(H), host(S), host(D)
    for i, a, b, got, dd in zip(lanes, g, h, s, d):
        if not (E.equal(got, E.add(a, b)) and E.equal(dd, E.double(a))):
            raise AssertionError(f"{c.params.label} planar add or double differs from the oracle at lane {i}")
    launches[f"{c.params.label}/ga_planar_2^20"] = counts
    say(f"{c.params.label} planar batch_add and batch_double at {N} lanes ({int(dbl.sum())} doublings, "
        f"{int(cancel.sum())} cancellations, {int(inf.sum())} infinite G): {len(lanes)} sampled lanes equal "
        f"the oracle; add {secs:.4f} s, double {dsecs:.4f} s (host clock, one run each); launches "
        f"{dict((k, v) for k, v in counts.items() if v)}")
    return {"add_s": secs, "double_s": dsecs, "launches": {k: v for k, v in counts.items() if v}}


def phase_general_a(ctx12, rates: dict, kres: dict, launches: dict, expected: dict, t_start: float) -> dict:
    """Phase 8, curves with a != 0 (montgomery_tpu_torch/testing/curves.py):
    ptxas of both instantiations of the safe triage kernels; aff_pre and
    aff_pre_packed with the a term against their plain versions at 9 and 13
    limbs and timed; Plain16's carries on the card against the
    limb loop (`ga_plain16`); P-256's engines against the bigint oracle
    and, on random_points_fast(seed=42) at 2^16 and 2^20, against the closed
    form through msm_device on signed_digits_device digits (no RCB launch;
    medians, peak memory and split at 2^20), the adversarial safe set,
    random_points_weierstrass, the predicates and the planar adds; P-384's
    engines at 2^16 and the oracle at 16."""
    import torch

    from montgomery_tpu_torch.curves.random import random_points_fast
    from montgomery_tpu_torch.msm import WeierstrassMsm
    from montgomery_tpu_torch.testing.curves import P256, P384

    say("== phase 8: curves with a != 0 (NIST P-256 at 9 limbs, P-384 at 13)")
    t8 = time.perf_counter()
    widths = {name: kres[name]["lanes"] for name in ("aff_pre", "aff_pre_packed")}
    out = {"ptxas": ga_ptxas(), "plain16": ga_plain16()}
    dev = torch.device("cuda", 0)
    for params, log2ns in ((P256, GA_MSM_LOG2N), (P384, (GA_P384_LOG2N,))):
        c = WeierstrassMsm(params, device=dev)
        label = params.label
        t0 = time.perf_counter()
        pts = random_points_fast(c.proj, 1 << max(log2ns), seed=SEED_POINTS, device=dev,
                                 cache_dir=ROOT / "build" / "points")
        torch.cuda.synchronize()
        say(f"points ({label}): 2^{max(log2ns)} from random_points_fast(seed={SEED_POINTS}) in "
            f"{time.perf_counter() - t0:.1f} s")
        host = c.proj.affine_to_host(type(pts)(*[a[..., :POINT_LANES] for a in pts]))
        row = {"kernels": ga_kernels(c, host, rates, widths)}
        ga_oracle(c, host)
        for engine in PATHS:
            for log2n in log2ns:
                counts, res = ga_msm(c, log2n, pts, f"ga_{engine}", expected, stats=log2n == 20)
                launches[f"{label}/ga_{engine}_2^{log2n}"] = counts
                row[f"{engine}_2^{log2n}"] = res
        if params is P256:
            launches[f"{label}/ga_adversarial_2^16"] = ga_adversarial(c, pts)
            row["predicates"] = ga_predicates(c, pts, launches)
            row["planar"] = ga_planar(c, pts, launches)
            del pts
            torch.cuda.empty_cache()
            # the generation and its checks; the general-a engines ran above
            launches[f"{label}/points_2^{NEW_GEN_LOG2N}"] = phase_points(c, "points", NEW_GEN_LOG2N,
                                                                         msms=False)
        else:
            del pts
            torch.cuda.empty_cache()
        out[label] = row
        say(f"[{time.perf_counter() - t_start:.1f} s] {label} done")
    say(f"phase 8: {time.perf_counter() - t8:.1f} s")
    return out


def _num(v):
    """A measured float to 6 significant digits (the kernels line stays
    within the tail of the output that a caller keeps); others unchanged."""
    if isinstance(v, list):
        return [_num(x) for x in v]
    return float(f"{v:.6g}") if isinstance(v, float) else v


SMALL_FIELDS = {1: "small", 2: "babybear", 3: "goldilocks"}  # the example fields of 1-3 limbs


def small_count_entries(fields: dict, alt: dict, keys: tuple) -> dict:
    """{kernel: {"n<n>": measurements}} of the instantiations no curve runs:
    the field kernels at 1-3 limbs (phase 7's `small_field_times`, with
    EXAMPLE_WIDE's timing under "wide" and the int64 x y % p beside
    mont_mul), their launches from the first of the field's counted op runs
    that launched them; divstep_inv and barrett_mul at 13 and 1-3 limbs
    (`phase_alt_kernels`, with their launches in the counted check run)."""
    out = {}
    for n, name in SMALL_FIELDS.items():
        res = fields[name]
        for kname, r in res["kernels"].items():
            runs = [(label, c[kname]) for op in res.values() if isinstance(op, dict) and "launches" in op
                    for label, c in op["launches"].items() if c.get(kname)]
            e = {key: _num(v) for key, v in r.items() if key in keys}
            if "wide" in r:
                e["wide"] = {key: _num(v) for key, v in r["wide"].items() if key in keys}
            e["launches"], e["launches_run"] = (runs[0][1], f"fields/{name}: {runs[0][0]}") if runs else (0, None)
            e.setdefault("library_ms", None)
            out.setdefault(kname, {})[f"n{n}"] = e
    for name, res in alt.items():
        for kname, r in res.items():
            e = {key: _num(v) for key, v in r.items() if key in keys}
            e.update(launches=r["launches"], launches_run=f"alt/{name}", library_ms=_num(r.get("library_ms")))
            out.setdefault(kname, {})[f"n{r['limbs']}"] = e
    return out


def kernels_line(kres: dict, te_kres: dict, launches: dict, new_kres: dict, ptx: dict,
                 ga: dict, fields: dict, alt: dict) -> tuple[dict, dict]:
    """The {"kernels": [...]} line and the per-kernel details printed before
    it. One entry per registered kernel, its launches read from the first
    run of `home_runs` that runs it (bench.py's configuration, then the
    Twisted Edwards MSM, then the others at 2^20, then the planar adds at
    2^20); a kernel instantiated at 12 and at 9 limbs for Twisted Edwards
    carries its 9-limb measurements under "n9". BLS12-381's (13 limbs) go
    under "n13", Pallas's (9 limbs) under "n9", or "n9_weierstrass" where
    "n9" holds the Twisted Edwards ones, each with its launches from the
    first of that curve's runs that launched it. aff_pre and aff_pre_packed
    carry phase 8's times with the a term under "general_a" (P-256 at 9
    limbs, P-384 at 13). The details: every run's
    count of each kernel, the redesign phases' main-path shapes, and ptxas
    of the 13- and 9-limb instantiations. Phase 7's example fields
    (`fields`) and phase 1's ALT_FIELDS results (`alt`) add the counts no
    curve runs (`small_count_entries`): "n1", "n2", "n3", and "n13" for
    divstep_inv and barrett_mul."""
    from montgomery_tpu_torch.ops import kernels

    top = max(MSM_LOG2N)
    home_runs = [f"{run}_2^{top}" for run in (PATHS[0], "te", *PATHS[1:], "serve", "te_serve")]
    home_runs += [f"{run}_2^{GEN_LOG2N}" for run in ("points", "te_points")]
    home_runs += [f"{run}_2^{top}" for run in ("planar_safe", "planar_unsafe")]
    home_runs.append(f"micro_2^{MICRO_LOG2N}")
    new_home = {label: [f"{label}/{run}_2^{top}" for run in (*PATHS, "serve")]
                + [f"{label}/points_2^{NEW_GEN_LOG2N}"] for label in NEW_CURVES}
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "share", "lanes", "max_abs_err",
            "blocks_per_sm", "turns_ms", "bitwise_turns_ms")
    small = small_count_entries(fields, alt, (*keys, "library_ms", "call"))

    def entry(name, k):
        home = next((run for run in home_runs if launches[run][name]), home_runs[0])
        res = kres.get(name) or te_kres[name]
        e = {"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
             "launches": launches[home][name], "launches_run": home,
             "max_abs_err": max(r[name]["max_abs_err"] for r in (kres, te_kres) if name in r),
             "ms": _num(res["ms"]), "plain_ms": _num(res["plain_ms"]), "bound_ms": _num(res["bound_ms"]),
             "bound_by": res["bound_by"], "library_ms": None, "lanes": res["lanes"],
             "limbs": sorted(n for n in k.symbols if n is not None)}
        if name in kres and name in te_kres:  # instantiated at 12 and at 9 limbs
            e["n9"] = {key: _num(te_kres[name][key]) for key in keys if key in te_kres[name]}
        for label, res_n in new_kres.items():
            if name not in res_n:
                continue
            n = 13 if label == "bls12-381" else 9
            run = next((r for r in new_home[label] if launches[r][name]), None)
            e["n13" if n == 13 else "n9_weierstrass" if "n9" in e else "n9"] = {
                **{key: _num(res_n[name][key]) for key in keys if key in res_n[name]},
                "launches": launches[run][name] if run else 0, "launches_run": run}
        for count, res_n in small.get(name, {}).items():
            e.setdefault(count, res_n)
        if name in ("aff_pre", "aff_pre_packed"):
            e["general_a"] = {label: {key: _num(v) for key, v in ga[label]["kernels"][name].items()
                                      if key in keys}
                              for label in ("p-256", "p-384")}
        return e

    def detail(name):
        res = {**te_kres.get(name, {}), **kres.get(name, {})}
        d = {"launches_by_path": {run: c[name] for run, c in launches.items() if c[name]}}
        d.update({key: v for key, v in res.items()
                  if key.endswith("_level") or key in ("call", "main_path", "floor_ms", "halving_ms", "turns_ms",
                                                     "ladder", "bodies", "te_path",
                                                     "bitwise_turns_ms", "sqrt_profile", "carry_chain",
                                                     "path_profile", "path_widths")})
        d.update({f"{label}_checked_lanes": r[name]["widths"] for label, r in new_kres.items() if name in r})
        d.update({f"{label}_{key}": r[name][key] for label, r in new_kres.items()
                  for key in ("main_path", "carry_chain") if key in r.get(name, {})})
        if name in ptx:
            d["ptxas_new"] = ptx[name]
        return d

    names = list(kernels.REGISTRY)
    return ({"kernels": [entry(name, kernels.REGISTRY[name]) for name in names]},
            {"kernel_details": {name: detail(name) for name in names}})


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        say("torch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("no CUDA device: this run needs one GPU")
        return 1
    from montgomery_tpu_torch.concrete import BLS12_377, ED_ON_BLS12_377
    from montgomery_tpu_torch.curves.random import random_points_fast, random_points_fast_edwards
    from montgomery_tpu_torch.msm import EdwardsMsm, WeierstrassMsm
    from montgomery_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    last = [t_start]

    def stamp(label):  # the seconds since the start, and those of this phase
        now = time.perf_counter()
        say(f"[{now - t_start:.1f} s] {label} done ({now - last[0]:.1f} s)")
        last[0] = now

    rates = phase_env()
    ptx = phase_new_ptxas()
    stamp("phase 0")
    ctx = WeierstrassMsm(BLS12_377, device=dev)
    te = EdwardsMsm(ED_ON_BLS12_377, device=dev)
    npts = 1 << max(MSM_LOG2N)
    t0 = time.perf_counter()
    pts = random_points_fast(ctx.proj, npts, seed=SEED_POINTS, device=dev,
                             cache_dir=ROOT / "build" / "points")
    torch.cuda.synchronize()
    say(f"points: 2^{max(MSM_LOG2N)} from random_points_fast(seed={SEED_POINTS}) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    te_pts = random_points_fast_edwards(te.ed, npts, seed=SEED_POINTS, device=dev,
                                        cache_dir=ROOT / "build" / "points")
    torch.cuda.synchronize()
    say(f"points: 2^{max(MSM_LOG2N)} from random_points_fast_edwards(seed={SEED_POINTS}) in "
        f"{time.perf_counter() - t0:.1f} s")
    host_pts = ctx.proj.affine_to_host(type(pts)(*[a[..., :4096] for a in pts]))
    te_host = te.ed.to_host(type(te_pts)(*[a[..., :4096] for a in te_pts]))
    stamp("the bench points")
    kres = phase_kernels(ctx, host_pts, rates)
    stamp("phase_kernels")
    for name, res in phase_redesign(ctx, host_pts, pts, rates).items():
        kres.setdefault(name, {}).update(res)
    stamp("phase_redesign")
    kres["proj_dbl_rcb"]["path_profile"] = profile_cofactor(ctx, pts, rates)
    for name, res in redesign_chord(ctx, host_pts, rates).items():
        kres[name]["carry_chain"] = res
    kres["mul_const"]["path_widths"] = mul_const_widths(ctx, rates)
    stamp("profile_cofactor, redesign_chord, mul_const_widths")
    te_kres = phase_te_kernels(te, te_host, rates)
    te_kres["ed_add_packed"]["carry_chain"] = redesign_ed_packed(te, te_host, rates)
    te_kres["ed_combine"] = redesign_te_combine(te, te_host, rates)
    for name, res in redesign_ed_add(te, te_host, rates).items():
        te_kres[name]["bodies"] = res
    stamp("the Twisted Edwards kernels")
    sqrt12, sqrt9 = phase_sqrt_kernels(ctx, te, rates)
    kres.update(sqrt12)
    te_kres.update(sqrt9)
    stamp("phase_sqrt_kernels")
    alt12, alt9, alt_fields = phase_alt_kernels(ctx, te, rates)
    kres.update(alt12)
    te_kres.update(alt9)
    stamp("phase_alt_kernels (phase 1)")
    phase_oracle(ctx, host_pts)
    launches, expected = phase_planar_oracle(ctx, pts), {}
    phase_te_oracle(te)
    stamp("phase 2")
    for path in PATHS:
        for log2n in MSM_LOG2N:
            launches[f"{path}_2^{log2n}"] = phase_msm(ctx, log2n, pts, path, expected)
    for log2n in MSM_LOG2N:
        phase_ab(ctx, pts, log2n)
    phase_adversarial(ctx, pts)
    launches[f"serve_2^{max(MSM_LOG2N)}"] = phase_serve(ctx, pts, max(MSM_LOG2N), expected)
    for log2n in MSM_LOG2N:
        launches[f"te_2^{log2n}"] = phase_te_msm(te, log2n, te_pts, expected)
    launches[f"te_serve_2^{max(MSM_LOG2N)}"] = phase_serve(te, te_pts, max(MSM_LOG2N), expected,
                                                           TE_CURVE, "te_serve")
    te_kres["ed_add_packed"]["path_profile"] = profile_te_packed(te, te_pts, rates)
    te_kres["ed_add"]["te_path"] = profile_te_add(te, te_pts, rates)
    stamp("phase 3")
    launches.update(phase_sharded(ctx, te, pts, te_pts, host_pts, expected))
    stamp("phase 5")
    api_launches, api = phase_api(ctx, te, pts, te_pts, expected)
    launches.update(api_launches)
    stamp("phase_api (phase 7)")
    api["fields"] = phase_example_fields(rates)
    stamp("phase_example_fields (phase 7)")
    del pts, te_pts
    torch.cuda.empty_cache()
    for c, path in ((ctx, "points"), (te, "te_points")):
        launches[f"{path}_2^{GEN_LOG2N}"] = phase_points(c, path)
    stamp("phase 4")
    new_kres = phase_new_curves(ctx, rates, kres, launches, expected, t_start)
    stamp("BLS12-381 and Pallas")
    ga = phase_general_a(ctx, rates, kres, launches, expected, t_start)
    stamp("phase 8")
    launches[f"micro_2^{MICRO_LOG2N}"] = phase_micro(ctx)
    stamp("phase 6")
    line, details = kernels_line(kres, te_kres, launches, new_kres, ptx, ga, api["fields"], alt_fields)
    details["api"] = api
    details["general_a"] = ga
    say(json.dumps(details))
    say(f"total wall time {time.perf_counter() - t_start:.1f} s")
    say(json.dumps(line))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
