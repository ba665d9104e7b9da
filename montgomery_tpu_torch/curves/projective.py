"""Projective short-Weierstrass curve ops over limb planes.

Counterpart of `montgomery_tpu/curves/projective.py`. Points are
(X : Y : Z) in Montgomery form, each coordinate an (n, *B) int32 plane; the
point at infinity is any lane with Z == 0. For a = 0 (every curve of
`concrete`), `add`, `double_n` and `combine` run the complete RCB formulas
in their kernels (`csrc/proj_add_rcb.cu`, `csrc/proj_dbl_rcb.cu`,
`csrc/proj_combine_rcb.cu`) on CUDA tensors and their plain versions on CPU
tensors. For a != 0 the group law is the JAX package's: dbl-1998-cmo-2 for
a doubling and the masked add, whose products go through `FieldOps.mul_list`
(kernel `mont_mul`) and squares through `square` (`mont_sqr`); the JAX
package has no fused kernel for it, and neither has this port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..bigint.weierstrass import AffinePoint, CurveParams
from ..ops import kernels
from ..ops.field import FieldOps, MulCounter, from16, to16
from ..ops.limbs import to_words

_VP, _U32P, _INT = kernels.VP, kernels.U32P, kernels.INT

# the last C argument before the stream picks the body: 0 six threads a
# lane, 1 one block a lane (the few-lane path, below
# ProjectiveOps.FEW_ADD_LANES)
PROJ_ADD_RCB = kernels.Kernel(
    "proj_add_rcb", kernels.symbols("proj_add_rcb", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/proj_add_rcb.cu",
    "montgomery_tpu/curves/projective.py:156",
    [_VP] * 9 + [_U32P, _U32P, _U32P, _INT, _INT],
)
# the last C argument before the stream picks the body: 0 one thread a lane,
# 1 one block a lane (the few-lane path, below ProjectiveOps.FEW_LANES)
PROJ_DBL_RCB = kernels.Kernel(
    "proj_dbl_rcb", kernels.symbols("proj_dbl_rcb", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/proj_dbl_rcb.cu",
    "montgomery_tpu/curves/projective.py:258",
    [_VP] * 6 + [_INT, _U32P, _U32P, _U32P, _INT, _INT],
)
PROJ_COMBINE_RCB = kernels.Kernel(
    "proj_combine_rcb", kernels.symbols("proj_combine_rcb", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/proj_combine_rcb.cu", "montgomery_tpu/msm/pippenger.py:508",
    [_VP] * 6 + [_INT, _INT, _U32P, _U32P, _U32P, _INT],
)
# Montgomery products of the JAX formulas (MulCounter): the RCB add's 12
# and 2 by 3b, a doubling's 8 and 1 by 3b
ADD_MULS, DBL_MULS = 14, 9


class ProjectiveBatch(NamedTuple):
    """(X : Y : Z); the point at infinity is any lane with Z == 0."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor

    @property
    def count(self) -> int:
        return self.X.shape[-1]


class AffineBatch(NamedTuple):
    """Affine points in Montgomery form with an explicit infinity mask."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool (N,)

    @property
    def count(self) -> int:
        return self.x.shape[-1]


def scale_by(ops, k: int, P):
    """k P for a constant k on `ops` (a ProjectiveOps or an EdwardsOps):
    the doublings between set bits run as one `double_n` launch each."""
    if k < 0:
        return scale_by(ops, -k, ops.neg(P))
    if k == 0:
        return ops.zero_like(P)
    R, run = P, 0
    for bit in bin(k)[3:]:
        run += 1
        if bit == "1":
            R = ops.add(ops.double_n(R, run), P)
            run = 0
    return ops.double_n(R, run)


def _zero16(f: FieldOps, x16: torch.Tensor) -> torch.Tensor:
    """FieldOps.is_zero of a value given as 16-bit limbs in [0, 2p)."""
    return (f.plain.reduce(x16) == 0).all(dim=0)


def _horner(W, c: int, add, double_n):
    """acc = W_{K-1}; acc = add(double_n(acc, c), W_k) for k = K-2 .. 0, over
    the last axis of W's planes (n, *B, K); planes (n, *B, 1)."""
    K = W.X.shape[-1]
    acc = type(W)(*[a[..., K - 1:K] for a in W])
    for k in range(K - 2, -1, -1):
        acc = add(double_n(acc, c), type(W)(*[a[..., k:k + 1] for a in W]))
    return acc


class ProjectiveOps:
    """Projective Weierstrass arithmetic: the RCB kernels for a = 0, the
    general-a formulas on field products otherwise."""

    def __init__(self, fops: FieldOps, params: CurveParams):
        p = fops.p
        self.f, self.params = fops, params
        self.a_is_zero = params.a % p == 0
        self.a_mont = params.a % p * fops.R % p
        self.b_mont = params.b % p * fops.R % p
        self.b3_mont = 3 * params.b % p * fops.R % p
        beta = params.endomorphism.beta if params.endomorphism else 0
        self.beta_mont = beta % p * fops.R % p
        self._b3_words = kernels.words(to_words(self.b3_mont, fops.n))
        # -p^-1 mod R, all n words: the warp product of the few-lane bodies
        self._mu_words = kernels.words(to_words(-pow(p, -1, fops.R) % fops.R, fops.n))

    # double_n launches on fewer lanes than this take the few-lane body (one
    # block a lane, latency-bound); wider ones one thread a lane on carry-
    # chain products. Both bodies timed at k = 6 from 10 to 8,192 lanes on an
    # H100 80GB HBM3 at 700 W (device time a launch, chip_smoke.py): the
    # few-lane body is faster up to 640 lanes (41.1 against 58.5 us at 12
    # limbs, 45.1 against 71.2 at 13, 31.5 against 33.7 at 9), the
    # one-thread body from 1,024 (58.5 against 67.9 us, 71.2 against 75.4,
    # 33.7 against 47.7)
    FEW_LANES = 1024

    # add launches on fewer lanes than this take the few-lane body (a block
    # a lane), wider ones six threads a lane. Both bodies timed from 1 to
    # 2^20 lanes on an H100 80GB HBM3 at 700 W (device time a launch, two
    # calls): the few-lane body is faster up to 20 lanes (5.73-6.12 against
    # 6.84-6.85 us), the two are within the calls' spread at 40 (6.70-7.19
    # against 6.86-6.92), the six-threads body is faster from 80 (7.06
    # against 7.88)
    FEW_ADD_LANES = 40

    # ------------------------------------------------------------- structure

    def zero(self, N: int, device) -> ProjectiveBatch:
        f = self.f
        z = f.zeros((N,), device)
        return ProjectiveBatch(z, f.const_plane(f.R_mod_p, z).contiguous(), z.clone())

    def zero_like(self, P: ProjectiveBatch) -> ProjectiveBatch:
        f = self.f
        return ProjectiveBatch(torch.zeros_like(P.X), f.const_plane(f.R_mod_p, P.Y),
                               torch.zeros_like(P.Z))

    def is_zero(self, P: ProjectiveBatch) -> torch.Tensor:
        """Bool over the batch: the point at infinity (Z == 0)."""
        return self.f.is_zero(P.Z)

    def neg(self, P: ProjectiveBatch) -> ProjectiveBatch:
        return ProjectiveBatch(P.X, self.f.neg(P.Y), P.Z)

    def select(self, mask, a: ProjectiveBatch, b: ProjectiveBatch) -> ProjectiveBatch:
        s = self.f._sel
        return ProjectiveBatch(s(mask, a.X, b.X), s(mask, a.Y, b.Y), s(mask, a.Z, b.Z))

    def from_affine(self, A: AffineBatch) -> ProjectiveBatch:
        P = ProjectiveBatch(A.x, A.y, self.f.const_plane(self.f.R_mod_p, A.x))
        return self.select(torch.logical_not(A.inf), P, self.zero_like(P))

    # ------------------------------------------------------------ group law

    def add(self, P: ProjectiveBatch, Q: ProjectiveBatch, *, few: bool | None = None) -> ProjectiveBatch:
        """Complete addition (valid for P == Q, P == -Q and zero). For a = 0
        the RCB add, one launch on CUDA tensors: below FEW_ADD_LANES lanes
        the kernel's few-lane body, with equal values; `few` picks the body
        instead. For a != 0 `add_masked`."""
        if not self.a_is_zero:
            return self.add_masked(P, Q)
        MulCounter.record(P.X.shape, ADD_MULS)
        ins = [*P, *Q]
        if not kernels.on_cuda(*ins):
            return self.add_plain(P, Q)
        shape = P.X.shape
        n = self.f.n
        flat = [a.reshape(n, -1).contiguous() for a in ins]
        N = kernels.check_planes(n, *flat)
        outs = [torch.empty_like(flat[0]) for _ in range(3)]
        if few is None:
            few = N < self.FEW_ADD_LANES
        if N:
            PROJ_ADD_RCB.launch(*[kernels.ptr(t) for t in outs + flat],
                                self._b3_words, self._mu_words, self.f.field_words(PROJ_ADD_RCB),
                                N, int(few), n=self.f.n, device=outs[0].device)
        return ProjectiveBatch(*[o.reshape(shape) for o in outs])

    def add_plain(self, P: ProjectiveBatch, Q: ProjectiveBatch) -> ProjectiveBatch:
        """RCB add, 2015/1060 Alg. 7, as montgomery_tpu's _add_rcb_formula."""
        F = self.f.plain
        X1, Y1, Z1, X2, Y2, Z2 = [to16(a) for a in (*P, *Q)]
        t0, t1, t2 = F.mul(X1, X2), F.mul(Y1, Y2), F.mul(Z1, Z2)
        m0 = F.mul(F.add_lazy(X1, Y1), F.add_lazy(X2, Y2))
        m1 = F.mul(F.add_lazy(Y1, Z1), F.add_lazy(Y2, Z2))
        m2 = F.mul(F.add_lazy(X1, Z1), F.add_lazy(X2, Z2))
        t3 = F.sub_lazy(m0, F.add_lazy(t0, t1))
        t4 = F.sub_lazy(m1, F.add_lazy(t1, t2))
        t5 = F.sub_lazy(m2, F.add_lazy(t0, t2))
        t2b = F.mul_const(t2, self.b3_mont)
        Y3b = F.mul_const(t5, self.b3_mont)
        t0_3 = F.add_lazy(F.add_lazy(t0, t0), t0)
        Z3s = F.add_lazy(t1, t2b)
        t1m = F.sub_lazy(t1, t2b)
        X3 = F.sub(F.mul(t3, t1m), F.mul(t4, Y3b))
        Y3 = F.add(F.mul(t1m, Z3s), F.mul(Y3b, t0_3))
        Z3 = F.add(F.mul(Z3s, t4), F.mul(t0_3, t3))
        return ProjectiveBatch(from16(X3), from16(Y3), from16(Z3))

    def add_masked(self, P: ProjectiveBatch, Q: ProjectiveBatch) -> ProjectiveBatch:
        """Complete add for any a, the JAX package's add_masked: the chord
        formula on every lane, then per-lane selects of `double(P)` where
        P == Q, the identity where P == -Q, and the other operand where one
        is the identity."""
        f = self.f
        Y1Z2, X1Z2, Z1Z2, Y2Z1, X2Z1 = f.mul_list(
            [(P.Y, Q.Z), (P.X, Q.Z), (P.Z, Q.Z), (Q.Y, P.Z), (Q.X, P.Z)])
        u, v = f.plain.sub(to16(Y2Z1), to16(Y1Z2)), f.plain.sub(to16(X2Z1), to16(X1Z2))
        added = self._chord(u, v, X1Z2, Y1Z2, Z1Z2)
        x_eq, y_eq = _zero16(f, v), _zero16(f, u)
        res = self.select(x_eq & y_eq, self.double(P), added)
        res = self.select(x_eq & ~y_eq, self.zero_like(P), res)
        res = self.select(self.is_zero(P), Q, res)
        return self.select(self.is_zero(Q), P, res)

    def _chord(self, u16, v16, X1, Y1, Z1) -> ProjectiveBatch:
        """The chord's sum from u = Y2 Z1 - Y1 Z2 and v = X2 Z1 - X1 Z2 as
        16-bit limbs (X1, Y1, Z1 the first operand's coordinates scaled by
        Z2), as the JAX package's add_masked and add_mixed compute it. The
        sums between products run on `Plain16` limbs, each converted once
        (the same values as FieldOps' add and sub, which convert on every
        call: on the card a conversion is several launches)."""
        f, F = self.f, self.f.plain
        u, v = from16(u16), from16(v16)
        uu, vv = f.square(u), f.square(v)
        vvv, Rq, uuZ = f.mul_list([(v, vv), (vv, X1), (uu, Z1)])
        Rq16 = to16(Rq)
        A16 = F.sub(F.sub(to16(uuZ), to16(vvv)), F.add(Rq16, Rq16))
        X3, t, w1, Z3 = f.mul_list([(v, from16(A16)), (u, from16(F.sub(Rq16, A16))), (vvv, Y1), (vvv, Z1)])
        return ProjectiveBatch(X3, from16(F.sub(to16(t), to16(w1))), Z3)

    def add_mixed(self, P: ProjectiveBatch, A: AffineBatch) -> ProjectiveBatch:
        """P + an affine point (Z2 = 1), complete; an infinite A gives P.
        For a = 0 the complete add of `from_affine(A)`, for a != 0 the mixed
        chord with the selects of `add_masked`, both as in the JAX package."""
        if self.a_is_zero:
            return self.add(P, self.from_affine(A))
        f = self.f
        Y2Z1, X2Z1 = f.mul_list([(A.y, P.Z), (A.x, P.Z)])
        u, v = f.plain.sub(to16(Y2Z1), to16(P.Y)), f.plain.sub(to16(X2Z1), to16(P.X))
        added = self._chord(u, v, P.X, P.Y, P.Z)
        x_eq, y_eq = _zero16(f, v), _zero16(f, u)
        res = self.select(x_eq & y_eq, self.double(P), added)
        res = self.select(x_eq & ~y_eq, self.zero_like(P), res)
        res = self.select(self.is_zero(P), self.from_affine(A), res)
        return self.select(A.inf, P, res)

    def sub_mixed(self, P: ProjectiveBatch, A: AffineBatch) -> ProjectiveBatch:
        return self.add_mixed(P, AffineBatch(A.x, self.f.neg(A.y), A.inf))

    def double(self, P: ProjectiveBatch) -> ProjectiveBatch:
        """2 P, complete: one RCB doubling for a = 0 (`double_n`), the JAX
        package's dbl-1998-cmo-2 for a != 0 (five batched products, a point
        with Y == 0 or Z == 0 gives Z3 = 0). The sums between products run
        on `Plain16` limbs as in `_chord`; the factors w = 3 XX + a ZZ
        (< 8p), s = 2 YZ and X + R (< 4p) stay unreduced, as a product's
        factors may (the same canonical values as the JAX package's)."""
        if self.a_is_zero:
            return self.double_n(P, 1)
        f, F = self.f, self.f.plain
        XX, YZ, ZZ = f.mul_list([(P.X, P.X), (P.Y, P.Z), (P.Z, P.Z)])
        aZZ, = f.mul_list([(f.const_plane(self.a_mont, ZZ), ZZ)])
        XX16, YZ16 = to16(XX), to16(YZ)
        w = from16(F.add_lazy(F.add_lazy(F.add_lazy(XX16, XX16), XX16), to16(aZZ)))
        s = from16(F.add_lazy(YZ16, YZ16))
        ss, R = f.mul_list([(s, s), (P.Y, s)])
        XR = from16(F.add_lazy(to16(P.X), to16(R)))
        sss, RR, BB, ww = f.mul_list([(s, ss), (R, R), (XR, XR), (w, w)])
        RR16 = to16(RR)
        B16 = F.sub(F.sub(to16(BB), XX16), RR16)
        h16 = F.sub(to16(ww), F.add(B16, B16))
        X3, t = f.mul_list([(from16(h16), s), (w, from16(F.sub(B16, h16)))])
        return ProjectiveBatch(X3, from16(F.sub(to16(t), F.add(RR16, RR16))), sss)

    def double_n(self, P: ProjectiveBatch, k: int, *, few: bool | None = None) -> ProjectiveBatch:
        """k complete doublings. For a = 0 the RCB doublings in one launch
        (k at run time); below FEW_LANES lanes the kernel's few-lane body,
        with equal values; `few` picks the body instead (the one-thread body
        with few=False). For a != 0 k calls of `double`."""
        if k <= 0:
            return P
        if not self.a_is_zero:
            for _ in range(k):
                P = self.double(P)
            return P
        MulCounter.record(P.X.shape, k * DBL_MULS)
        if not kernels.on_cuda(*P):
            return self.double_n_plain(P, k)
        shape = P.X.shape
        n = self.f.n
        flat = [a.reshape(n, -1).contiguous() for a in P]
        N = kernels.check_planes(n, *flat)
        outs = [torch.empty_like(flat[0]) for _ in range(3)]
        if few is None:
            few = N < self.FEW_LANES
        if N:
            PROJ_DBL_RCB.launch(*[kernels.ptr(t) for t in outs + flat], int(k),
                                self._b3_words, self._mu_words, self.f.field_words(PROJ_DBL_RCB),
                                N, int(few), n=self.f.n, device=outs[0].device)
        return ProjectiveBatch(*[o.reshape(shape) for o in outs])

    def double_n_plain(self, P: ProjectiveBatch, k: int) -> ProjectiveBatch:
        """k RCB doublings, 2015/1060 Alg. 9, as montgomery_tpu's _dbl_rcb_formula."""
        F = self.f.plain
        X, Y, Z = [to16(a) for a in P]
        for _ in range(k):
            YY, ZZ, YZ, XY = F.mul(Y, Y), F.mul(Z, Z), F.mul(Y, Z), F.mul(X, Y)
            Z3d = F.add(YY, YY)
            Z3d = F.add(Z3d, Z3d)
            Z3d = F.add_lazy(Z3d, Z3d)
            t2 = F.mul_const(ZZ, self.b3_mont)
            Y3t = F.add_lazy(YY, t2)
            t0m = F.sub_lazy(YY, F.add(F.add(t2, t2), t2))
            X3a, Z, Y3a = F.mul(t2, Z3d), F.mul(YZ, Z3d), F.mul(t0m, Y3t)
            Y = F.add(X3a, Y3a)
            X3b = F.mul(t0m, XY)
            X = F.add(X3b, X3b)
        return ProjectiveBatch(from16(X), from16(Y), from16(Z))

    def combine(self, W: ProjectiveBatch, c: int) -> ProjectiveBatch:
        """S = sum_k 2^(c k) W_k over the last axis of planes (n, *B, K), in
        Horner order (acc = W_{K-1}; acc = 2^c acc + W_k for k = K-2 .. 0):
        for a = 0 one `proj_combine_rcb` launch on CUDA tensors,
        `combine_plain` on CPU tensors; for a != 0 the same order through
        `double_n` and `add`. Returns planes (n, *B, 1); any W_k may be the
        identity."""
        K = W.X.shape[-1]
        if K < 1 or c < 1:
            raise ValueError(f"combine needs K >= 1 windows and c >= 1, got K = {K}, c = {c}")
        if not self.a_is_zero:
            return _horner(W, c, self.add, self.double_n)
        MulCounter.record(W.X.shape[:-1], (K - 1) * (c * DBL_MULS + ADD_MULS))
        if not kernels.on_cuda(*W):
            return self.combine_plain(W, c)
        n = self.f.n
        batch = W.X.shape[1:-1]
        flat = [a.reshape(n, -1).contiguous() for a in W]
        kernels.check_planes(n, *flat)
        N = flat[0].shape[-1] // K
        outs = [torch.empty((n, N), dtype=torch.int32, device=flat[0].device) for _ in range(3)]
        if N:
            PROJ_COMBINE_RCB.launch(*[kernels.ptr(t) for t in outs + flat], K, int(c),
                                    self._b3_words, self._mu_words,
                                    self.f.field_words(PROJ_COMBINE_RCB), N, n=n,
                                    device=outs[0].device)
        return ProjectiveBatch(*[o.reshape(n, *batch, 1) for o in outs])

    def combine_plain(self, W: ProjectiveBatch, c: int) -> ProjectiveBatch:
        """The Horner combine with `double_n_plain` and `add_plain` (a = 0),
        in the kernel's order."""
        return _horner(W, c, self.add_plain, self.double_n_plain)

    def scale(self, k: int, P: ProjectiveBatch) -> ProjectiveBatch:
        """k P for a constant k, left to right: each set bit below the top
        one costs one `double_n` launch over the doublings since the last
        add, then one add of P (the cofactor of BLS12-377, 125 bits with 16
        set, is 16 doubling launches and 15 adds). The same point as the
        JAX package's double-and-add with selects."""
        return scale_by(self, k, P)

    # ------------------------------------------------------------ predicates

    def is_on_curve(self, P: ProjectiveBatch) -> torch.Tensor:
        """Bool over the batch: Y^2 Z == X^3 + a X Z^2 + b Z^3, or the point
        at infinity; three batched `mul`s and one more (`mont_mul` on the
        card), two more where a != 0."""
        f = self.f
        YY, XX, ZZ = f.mul_list([(P.Y, P.Y), (P.X, P.X), (P.Z, P.Z)])
        b = f.const_plane(self.b_mont, ZZ)
        lhs, X3, bZZ = f.mul_list([(YY, P.Z), (XX, P.X), (b, ZZ)])
        if self.a_is_zero:
            rhs = f.add(X3, f.mul(bZZ, P.Z))
        else:
            aX = f.mul(f.const_plane(self.a_mont, ZZ), P.X)
            aXZZ, bZ3 = f.mul_list([(aX, ZZ), (bZZ, P.Z)])
            rhs = f.add(f.add(X3, aXZZ), bZ3)
        return f.is_equal(lhs, rhs) | self.is_zero(P)

    def is_in_subgroup(self, P: ProjectiveBatch) -> torch.Tensor:
        """Bool over the batch: order P == 0, through `scale` (one
        `double_n` per run of doublings, one `add` per set bit). For a != 0
        the masked add is complete on every input, and the test is
        is_zero(scale(order, P)), as in the JAX package. For a = 0 the
        RCB add is complete only where no two operands differ by a point of
        order 2; a curve with even cofactor (BLS12-377) has such points, and
        there the add returns (0 : 0 : 0), which every later add and doubling
        keeps. A point of the subgroup never meets that case (its multiples
        have odd order), so a result with Y == 0 marks a point outside it:
        only a true infinity (Z == 0, Y != 0) passes."""
        R = self.scale(self.params.order, P)
        if not self.a_is_zero:
            return self.is_zero(R)
        return self.is_zero(R) & ~self.f.is_zero(R.Y)

    def eq(self, P: ProjectiveBatch, Q: ProjectiveBatch) -> torch.Tensor:
        """Bool over the batch: both at infinity, or neither with
        X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
        f = self.f
        zp, zq = self.is_zero(P), self.is_zero(Q)
        a1, a2, b1, b2 = f.mul_list([(P.X, Q.Z), (Q.X, P.Z), (P.Y, Q.Z), (Q.Y, P.Z)])
        return (zp & zq) | (~(zp | zq) & f.is_equal(a1, a2) & f.is_equal(b1, b2))

    # ------------------------------------------------------------ conversion

    def to_affine(self, P: ProjectiveBatch) -> AffineBatch:
        """Batch normalisation on the device: one batch inversion of Z
        (zeros map to zero) and one batched product; infinity gives
        x = y = 0 with the mask set."""
        f = self.f
        X, Y, Z = [a.reshape(f.n, -1) for a in P]
        zinv = f.batch_inv(Z, handle_zero=True)
        x, y = f.mul_list([(X, zinv), (Y, zinv)])
        return AffineBatch(x, y, self.is_zero(P).reshape(-1))

    def endomorphism_affine(self, A: AffineBatch) -> AffineBatch:
        """phi(x, y) = (beta x, y), through kernel 1 on a CUDA tensor."""
        return AffineBatch(self.f.mul_const(A.x, self.beta_mont), A.y, A.inf)

    # ------------------------------------------------------------------ I/O

    def affine_to_device(self, points: list[AffinePoint], device="cuda") -> AffineBatch:
        """Oracle affine points -> Montgomery-form AffineBatch on `device`."""
        f = self.f
        xs = [0 if P.is_zero else P.x for P in points]
        ys = [0 if P.is_zero else P.y for P in points]
        both = f.pack(xs + ys, device=device, to_mont=True)
        N = len(points)
        inf = torch.tensor([P.is_zero for P in points], dtype=torch.bool, device=device)
        return AffineBatch(both[:, :N], both[:, N:], inf)

    def affine_to_host(self, A: AffineBatch) -> list[AffinePoint]:
        xs = self.f.unpack(A.x, from_mont=True)
        ys = self.f.unpack(A.y, from_mont=True)
        inf = A.inf.cpu().tolist()
        return [AffinePoint.zero() if z else AffinePoint(x, y) for x, y, z in zip(xs, ys, inf)]

    def to_host_raw(self, P: ProjectiveBatch) -> list[tuple[int, int, int]]:
        """Canonical (X, Y, Z) ints, no inversion."""
        f = self.f
        return list(zip(*[f.unpack(a.reshape(f.n, -1), from_mont=True) for a in P]))

    def to_host(self, P: ProjectiveBatch) -> list[AffinePoint]:
        """Affine points, normalised on the device (`to_affine`: one batch
        inversion), as in the JAX package."""
        if not P.X.numel():
            return []
        return self.affine_to_host(self.to_affine(P))
