"""Batched affine Weierstrass additions, one shared batch inversion per
batch: on planar point batches and in the packed-row form.

Counterpart of `montgomery_tpu/curves/affine.py` (`AffineOps`). The planar
adds (`batch_add`, `batch_add_unsafe`, `batch_double`) take AffineBatch
planes (n, *batch) with bool infinity masks (*batch). The MSM engine keeps
points as ONE int32 array of rows [x (n) | y (n) | inf (1)], so every pair
round gathers one column per operand. The JAX package packed two 13-bit
limbs into each int32 row; this port's limbs are whole 32-bit words, so a
packed point is 2n + 1 rows (25 for BLS12-377, 27 for BLS12-381, 19 for
Pallas) and there is no 16-bit packing.

Kernels (`csrc/`): `aff_pre` and `aff_post` sit around `FieldOps.batch_inv`
in the planar safe (complete) add, `aff_pre_unsafe` (with an optional
validity mask) and `aff_post_unsafe` in the planar unsafe one; `pack_glv`
writes the packed rows of [P..., phi(P)...]; `aff_pre_packed` and
`aff_post_packed` are the safe packed add's, `aff_pre_packed_u` and
`aff_post_packed_u` the unsafe one's. The safe adds share their per-lane
triage and completion (`csrc/affine.cuh`), the unsafe ones their chord.
Each wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors.
"""

from __future__ import annotations

import torch

from ..bigint.weierstrass import CurveParams
from ..ops import kernels
from ..ops.field import FieldOps, MulCounter, from16, to16
from ..ops.limbs import to_words
from .projective import AffineBatch

_VP, _U32P, _INT = kernels.VP, kernels.U32P, kernels.INT

PACK_GLV = kernels.Kernel(
    "pack_glv", kernels.symbols("pack_glv", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/pack_glv.cu",
    "montgomery_tpu/curves/affine.py:261",
    [_VP, _VP, _INT, _VP, _INT, _VP, _U32P, _U32P, _INT],
)
AFF_PRE_PACKED_U = kernels.Kernel(
    "aff_pre_packed_u", kernels.symbols("aff_pre_packed_u", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_pre_packed_u.cu",
    "montgomery_tpu/curves/affine.py:341",
    [_VP, _VP, _INT, _VP, _INT, _VP, _U32P, _U32P, _INT],
)
AFF_POST_PACKED_U = kernels.Kernel(
    "aff_post_packed_u", kernels.symbols("aff_post_packed_u", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_post_packed_u.cu",
    "montgomery_tpu/curves/affine.py:345",
    [_VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _INT, _VP, _INT, _INT, _VP, _U32P, _INT],
)
# the safe pre stages take a in Montgomery form after `one`, or a null
# pointer for an a = 0 curve (the kernels' body without the a term)
AFF_PRE_PACKED = kernels.Kernel(
    "aff_pre_packed", kernels.symbols("aff_pre_packed", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_pre_packed.cu",
    "montgomery_tpu/curves/affine.py:350",
    [_VP, _VP, _VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _U32P, _U32P, _U32P, _INT],
)
AFF_POST_PACKED = kernels.Kernel(
    "aff_post_packed", kernels.symbols("aff_post_packed", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_post_packed.cu",
    "montgomery_tpu/curves/affine.py:355",
    [_VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _INT, _VP, _INT, _VP, _VP, _U32P, _INT],
)

AFF_PRE = kernels.Kernel(
    "aff_pre", kernels.symbols("aff_pre", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_pre.cu",
    "montgomery_tpu/curves/affine.py:134",
    [_VP, _VP, _VP, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _VP, _U32P, _U32P, _U32P, _INT],
)
AFF_POST = kernels.Kernel(
    "aff_post", kernels.symbols("aff_post", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_post.cu",
    "montgomery_tpu/curves/affine.py:140",
    [_VP, _VP, _VP, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _VP, _VP,
     _U32P, _INT],
)
# one kernel for both of the JAX package's unsafe pre stages: aff_pre_unsafe
# (:180) and, with a validity mask, aff_pre_masked (:184)
AFF_PRE_UNSAFE = kernels.Kernel(
    "aff_pre_unsafe", kernels.symbols("aff_pre_unsafe", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_pre_unsafe.cu",
    "montgomery_tpu/curves/affine.py:180,184",
    [_VP, _VP, _INT, _VP, _INT, _VP, _U32P, _U32P, _INT],
)
AFF_POST_UNSAFE = kernels.Kernel(
    "aff_post_unsafe", kernels.symbols("aff_post_unsafe", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/aff_post_unsafe.cu",
    "montgomery_tpu/curves/affine.py:190",
    [_VP, _VP, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _INT, _VP, _INT, _U32P, _INT],
)

# Montgomery products of the JAX formulas, recorded per launch (MulCounter):
# the GLV map's beta x, the triage's square, the completions' two products
# and a square; the unsafe pre stages have none
PACK_GLV_MULS, PRE_MULS, POST_MULS = 1, 1, 3

# flag bits of the safe pre stage (csrc/affine.cuh)
DBL, CANCEL, Y1_ZERO = 1, 2, 4


def _flat(A: AffineBatch) -> AffineBatch:
    """Planes (n, *batch) -> (n, M), masks (*batch) -> bool (M,)."""
    return AffineBatch(A.x.reshape(A.x.shape[0], -1), A.y.reshape(A.y.shape[0], -1),
                       A.inf.to(torch.bool).reshape(-1))


class AffineOps:
    """Batched-affine group ops for y^2 = x^3 + a x + b, planar and packed."""

    def __init__(self, fops: FieldOps, params: CurveParams):
        p = fops.p
        self.f, self.params = fops, params
        self.a_is_zero = params.a % p == 0
        self.a_mont = params.a % p * fops.R % p
        self.b_mont = params.b % p * fops.R % p
        # a for the safe pre stages' kernels: None (a null pointer) where a = 0
        self._a_words = None if self.a_is_zero else kernels.words(to_words(self.a_mont, fops.n))
        beta = params.endomorphism.beta if params.endomorphism else 0
        self.beta_mont = beta % p * fops.R % p
        self._beta_words = kernels.words(to_words(self.beta_mont, fops.n))
        self._one_words = kernels.words(to_words(fops.R_mod_p, fops.n))

    # ------------------------------------------------------------ packed form

    @property
    def packed_rows(self) -> int:
        return 2 * self.f.n + 1

    def pack_rows(self, A: AffineBatch) -> torch.Tensor:
        """AffineBatch (M) -> (2n+1, M) int32 packed rows."""
        return torch.cat([A.x, A.y, A.inf.to(torch.int32)[None]], dim=0)

    def unpack_rows(self, P: torch.Tensor) -> AffineBatch:
        n = self.f.n
        return AffineBatch(P[:n], P[n:2 * n], P[2 * n] != 0)

    def pack_rows_glv(self, A: AffineBatch) -> torch.Tensor:
        """AffineBatch (N) -> packed rows (2n+1, 2N) of [P..., phi(P)...],
        phi(x, y) = (beta x, y): kernel `pack_glv` on CUDA tensors."""
        MulCounter.record(A.x.shape, PACK_GLV_MULS)
        if not kernels.on_cuda(A.x, A.y, A.inf):
            return self.pack_rows_glv_plain(A)
        n, N = self.f.n, A.count
        xv, sx = kernels.lane_view(A.x, n, N)
        yv, sy = kernels.lane_view(A.y, n, N)
        inf = A.inf.to(torch.bool).contiguous()
        out = torch.empty((self.packed_rows, 2 * N), dtype=torch.int32, device=A.x.device)
        if N:
            if 2 * N >= 1 << 31:
                raise ValueError("lane count exceeds the kernels' int range")
            PACK_GLV.launch(kernels.ptr(out), kernels.ptr(xv), sx, kernels.ptr(yv), sy,
                            kernels.ptr(inf), self._beta_words, self.f.field_words(PACK_GLV), N,
                            n=self.f.n, device=out.device)
        return out

    def pack_rows_glv_plain(self, A: AffineBatch) -> torch.Tensor:
        xb = self.f.mul_const_plain(A.x, self.beta_mont)
        E = AffineBatch(xb, A.y, A.inf)
        return torch.cat([self.pack_rows(A), self.pack_rows(E)], dim=-1)

    def _split_signed(self, P: torch.Tensor, s: torch.Tensor):
        """Packed rows + sign plane -> (x, y sign-applied, inf plane), as
        16-bit limbs of the plain field arithmetic."""
        F, n = self.f.plain, self.f.n
        x, y = to16(P[:n]), to16(P[n:2 * n])
        y = torch.where(s[0][None] != 0, F.neg(y), y)
        return x, y, P[2 * n:2 * n + 1]

    # ----------------------------------------------------------- packed add

    def add_packed(self, A: torch.Tensor, B: torch.Tensor, sA: torch.Tensor, sB: torch.Tensor,
                   valid: torch.Tensor, unsafe: bool = False) -> torch.Tensor:
        """Lane-wise packed add with pass-through: out[i] = sgn(A[i]) +
        sgn(B[i]) where valid[i], else sgn(A[i]). sA, sB, valid are int32
        (1, M) planes. The safe add is complete: doubling, cancellation,
        y = 0 and infinite operands. Unsafe contract: no paired lanes share x
        and none is infinite (one zero denominator poisons every lane of the
        batch)."""
        if unsafe:
            denom = self.pre_packed_u(A, B, valid)
            inv1, h = self.f.batch_inv_parent(denom)  # the post forms the last level
            return self.post_packed_u(A, B, sA, sB, inv1, denom, h, valid)
        denom, numer, flags = self.pre_packed(A, B, sA, sB, valid)
        dinv = self.f.batch_inv(denom)  # no zero: poisoned and unpaired lanes hold 1
        return self.post_packed(A, B, sA, sB, dinv, numer, flags, valid)

    def pre_packed(self, A, B, sA, sB, hp):
        """Triage of the safe add: (denom (n, M), numer (n, M), flags (1, M)),
        denom 1 where poisoned or hp == 0: kernel `aff_pre_packed` on CUDA
        tensors."""
        MulCounter.record(A.shape, PRE_MULS)
        if not kernels.on_cuda(A, B, sA, sB, hp):
            return self.pre_packed_plain(A, B, sA, sB, hp)
        n, R, M = self.f.n, self.packed_rows, A.shape[-1]
        Av, sa = kernels.lane_view(A, R, M)
        Bv, sb = kernels.lane_view(B, R, M)
        sAv, sBv, hv = [kernels.lane_view(t, 1, M)[0] for t in (sA, sB, hp)]
        denom = torch.empty((n, M), dtype=torch.int32, device=A.device)
        numer = torch.empty_like(denom)
        flags = torch.empty((1, M), dtype=torch.int32, device=A.device)
        if M:
            AFF_PRE_PACKED.launch(kernels.ptr(denom), kernels.ptr(numer), kernels.ptr(flags),
                                  kernels.ptr(Av), sa, kernels.ptr(Bv), sb, kernels.ptr(sAv),
                                  kernels.ptr(sBv), kernels.ptr(hv), self._one_words, self._a_words,
                                  self.f.field_words(AFF_PRE_PACKED), M, n=self.f.n,
                                  device=denom.device)
        return denom, numer, flags

    def pre_packed_plain(self, A, B, sA, sB, hp):
        """aff_triage of csrc/affine.cuh on 16-bit limbs, then the hp select."""
        x1, y1, inf1 = self._split_signed(A, sA)
        x2, y2, inf2 = self._split_signed(B, sB)
        denom, numer, flags = self._triage16(x1, y1, x2, y2, inf1[0] != 0, inf2[0] != 0)
        denom = FieldOps._sel(hp[0] != 0, denom, self.f.plain.const(self.f.R_mod_p, x1))
        return from16(denom), from16(numer), flags[None]

    def _triage16(self, x1, y1, x2, y2, inf1, inf2):
        """aff_triage of csrc/affine.cuh on 16-bit limbs, bool infinity
        masks: (denom, numer, int32 flags (M,))."""
        F = self.f.plain
        sel = FieldOps._sel

        def eq(a, b):
            return (F.reduce(a) == F.reduce(b)).all(dim=0)

        xeq, yeq = eq(x1, x2), eq(y1, y2)
        finite = ~inf1 & ~inf2
        is_dbl = xeq & yeq & finite
        cancel = xeq & ~yeq & finite
        y1_zero = (F.reduce(y1) == 0).all(dim=0)
        one = F.const(self.f.R_mod_p, x1).expand_as(x1)
        denom = sel(is_dbl, F.add(y1, y1), F.sub(x2, x1))
        denom = sel(cancel | (is_dbl & y1_zero) | ~finite, one, denom)
        numer = sel(is_dbl, self._tangent16(x1), F.sub(y2, y1))
        flags = DBL * is_dbl.int() + CANCEL * cancel.int() + Y1_ZERO * y1_zero.int()
        return denom, numer, flags

    def _tangent16(self, x):
        """The tangent's numerator 3 x^2 + a on 16-bit limbs (the JAX
        package's _slope_numer_dbl)."""
        F = self.f.plain
        xx = F.mul(x, x)
        num = F.add(F.add(xx, xx), xx)
        return num if self.a_is_zero else F.add(num, F.const(self.a_mont, x))

    def post_packed(self, A, B, sA, sB, dinv, numer, flags, hp) -> torch.Tensor:
        """(2n+1, M) packed sums of the safe add, inf row live (pass-through
        where hp == 0): kernel `aff_post_packed` on CUDA tensors."""
        MulCounter.record(A.shape, POST_MULS)
        if not kernels.on_cuda(A, B, sA, sB, dinv, numer, flags, hp):
            return self.post_packed_plain(A, B, sA, sB, dinv, numer, flags, hp)
        n, R, M = self.f.n, self.packed_rows, A.shape[-1]
        Av, sa = kernels.lane_view(A, R, M)
        Bv, sb = kernels.lane_view(B, R, M)
        dv, sd = kernels.lane_view(dinv, n, M)
        nv, sn = kernels.lane_view(numer, n, M)
        sAv, sBv, fv, hv = [kernels.lane_view(t, 1, M)[0] for t in (sA, sB, flags, hp)]
        out = torch.empty((R, M), dtype=torch.int32, device=A.device)
        if M:
            AFF_POST_PACKED.launch(kernels.ptr(out), kernels.ptr(Av), sa, kernels.ptr(Bv), sb,
                                   kernels.ptr(sAv), kernels.ptr(sBv), kernels.ptr(dv), sd,
                                   kernels.ptr(nv), sn, kernels.ptr(fv), kernels.ptr(hv),
                                   self.f.field_words(AFF_POST_PACKED), M, n=self.f.n,
                                   device=out.device)
        return out

    def post_packed_plain(self, A, B, sA, sB, dinv, numer, flags, hp) -> torch.Tensor:
        """aff_complete of csrc/affine.cuh on 16-bit limbs, then the hp select."""
        x1, y1, inf1 = self._split_signed(A, sA)
        x2, y2, inf2 = self._split_signed(B, sB)
        x3, y3, inf3 = self._complete16(x1, y1, x2, y2, to16(dinv), to16(numer), flags[0],
                                        inf1[0] != 0, inf2[0] != 0)
        sel = FieldOps._sel
        paired = hp[0] != 0
        out_inf = torch.where(paired[None], inf3.to(torch.int32)[None], inf1)
        return torch.cat([from16(sel(paired, x3, x1)), from16(sel(paired, y3, y1)), out_inf])

    def _complete16(self, x1, y1, x2, y2, dinv, numer, flags, inf1, inf2):
        """aff_complete of csrc/affine.cuh on 16-bit limbs: (x3, y3, bool
        inf3)."""
        F = self.f.plain
        sel = FieldOps._sel
        lam = F.mul(numer, dinv)
        x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        only1, only2 = inf1 & ~inf2, inf2 & ~inf1
        x3, y3 = sel(only1, x2, x3), sel(only1, y2, y3)
        x3, y3 = sel(only2, x1, x3), sel(only2, y1, y3)
        inf3 = ((flags & CANCEL) != 0) | (((flags & DBL) != 0) & ((flags & Y1_ZERO) != 0)) | (inf1 & inf2)
        return x3, y3, inf3

    def pre_packed_u(self, A, B, hp) -> torch.Tensor:
        """(n, M) denominators x_B - x_A, R mod p where hp == 0: kernel
        `aff_pre_packed_u` on CUDA tensors."""
        if not kernels.on_cuda(A, B, hp):
            return self.pre_packed_u_plain(A, B, hp)
        n, R, M = self.f.n, self.packed_rows, A.shape[-1]
        Av, sa = kernels.lane_view(A, R, M)
        Bv, sb = kernels.lane_view(B, R, M)
        hv, _ = kernels.lane_view(hp, 1, M)
        out = torch.empty((n, M), dtype=torch.int32, device=A.device)
        if M:
            AFF_PRE_PACKED_U.launch(kernels.ptr(out), kernels.ptr(Av), sa, kernels.ptr(Bv), sb,
                                    kernels.ptr(hv), self._one_words,
                                    self.f.field_words(AFF_PRE_PACKED_U), M, n=self.f.n,
                                    device=out.device)
        return out

    def pre_packed_u_plain(self, A, B, hp) -> torch.Tensor:
        F, n = self.f.plain, self.f.n
        d = F.sub(to16(B[:n]), to16(A[:n]))
        one = F.const(self.f.R_mod_p, d).expand_as(d)
        return from16(torch.where(hp[0][None] != 0, d, one))

    def post_packed_u(self, A, B, sA, sB, inv1, denom, h: int, hp) -> torch.Tensor:
        """(2n+1, M) packed sums (pass-through where hp == 0) from the batch
        inversion's parent level (`FieldOps.batch_inv_parent(denom)`: inv1,
        h) and the denominators: kernel `aff_post_packed_u` on CUDA tensors,
        which forms each lane's inverse as the last descent level would."""
        MulCounter.record(A.shape, POST_MULS + (h > 0))
        if not kernels.on_cuda(A, B, sA, sB, inv1, denom, hp):
            return self.post_packed_u_plain(A, B, sA, sB, inv1, denom, h, hp)
        n, R, M = self.f.n, self.packed_rows, A.shape[-1]
        _check_parent(inv1, M, h)
        Av, sa = kernels.lane_view(A, R, M)
        Bv, sb = kernels.lane_view(B, R, M)
        iv, si = kernels.lane_view(inv1, n, inv1.shape[-1])
        dv, sd = kernels.lane_view(denom, n, M)
        sAv, sBv, hv = [kernels.lane_view(t, 1, M)[0] for t in (sA, sB, hp)]
        out = torch.empty((R, M), dtype=torch.int32, device=A.device)
        if M:
            AFF_POST_PACKED_U.launch(kernels.ptr(out), kernels.ptr(Av), sa, kernels.ptr(Bv), sb,
                                     kernels.ptr(sAv), kernels.ptr(sBv), kernels.ptr(iv), si,
                                     kernels.ptr(dv), sd, int(h), kernels.ptr(hv),
                                     self.f.field_words(AFF_POST_PACKED_U), M, n=self.f.n,
                                     device=out.device)
        return out

    def post_packed_u_plain(self, A, B, sA, sB, inv1, denom, h: int, hp) -> torch.Tensor:
        """The lanes' inverses from (inv1, h) and denom with plain products,
        as `FieldOps._descend` forms them, then the chord (aff_chord of
        csrc/affine.cuh on 16-bit limbs)."""
        f = self.f
        M = A.shape[-1]
        _check_parent(inv1, M, h)
        dinv = inv1
        if h:
            lo = f.mul_plain(inv1[:, :h], denom[:, h:2 * h])
            hi = f.mul_plain(inv1[:, :h], denom[:, :h])
            dinv = torch.cat([lo, hi, inv1[:, h:h + (M & 1)]], dim=-1)
        x1, y1, inf1 = self._split_signed(A, sA)
        x2, y2, _ = self._split_signed(B, sB)
        x3, y3 = self._chord16(x1, y1, x2, y2, to16(dinv))
        paired = hp[0][None] != 0
        out_x = from16(torch.where(paired, x3, x1))
        out_y = from16(torch.where(paired, y3, y1))
        out_inf = torch.where(hp != 0, torch.zeros_like(inf1), inf1)
        return torch.cat([out_x, out_y, out_inf], dim=0)

    def _chord16(self, x1, y1, x2, y2, dinv):
        """aff_chord of csrc/affine.cuh on 16-bit limbs: (x3, y3)."""
        F = self.f.plain
        lam = F.mul(F.sub(y2, y1), dinv)
        x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
        return x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1)

    # ------------------------------------------------------------ planar ops

    def zero(self, N: int, device) -> AffineBatch:
        """N points at infinity (x = y = 0)."""
        z = self.f.zeros((N,), device)
        return AffineBatch(z, z, torch.ones((N,), dtype=torch.bool, device=device))

    def select(self, mask: torch.Tensor, a: AffineBatch, b: AffineBatch) -> AffineBatch:
        """a where mask, else b, lane by lane."""
        s = self.f._sel
        return AffineBatch(s(mask, a.x, b.x), s(mask, a.y, b.y), torch.where(mask, a.inf, b.inf))

    def neg(self, A: AffineBatch) -> AffineBatch:
        return AffineBatch(A.x, self.f.neg(A.y), A.inf)

    def batch_add(self, G: AffineBatch, H: AffineBatch) -> AffineBatch:
        """Lane-wise G[i] + H[i], complete: infinite operands, doubling
        (x1 == x2, y1 == y2) and cancellation (x1 == x2, y1 == -y2). Planes
        (n, *batch) of one shape, bool masks (*batch). One batch inversion
        shared by every lane between kernels `aff_pre` and `aff_post`; a
        poisoned lane's denominator is 1, so none brings a zero into it."""
        shape = _same_shape(G, H)
        g, h = _flat(G), _flat(H)
        denom, numer, flags = self.pre(g, h)
        dinv = self.f.batch_inv(denom)
        x3, y3, inf3 = self.post(g, h, dinv, numer, flags)
        return AffineBatch(x3.reshape(shape), y3.reshape(shape), inf3.reshape(shape[1:]))

    def pre(self, G: AffineBatch, H: AffineBatch):
        """Triage of the planar safe add over (n, M) planes and bool (M,)
        masks: (denom (n, M), numer (n, M), flags (1, M)): kernel `aff_pre`
        on CUDA tensors."""
        n, M = self.f.n, G.count
        i1, i2 = _lane_mask(G.inf, M), _lane_mask(H.inf, M)
        MulCounter.record(G.x.shape, PRE_MULS)
        if not kernels.on_cuda(*G, *H):
            return self.pre_plain(G, H)
        (x1, sx1), (y1, sy1), (x2, sx2), (y2, sy2) = [kernels.lane_view(a, n, M) for a in (*G[:2], *H[:2])]
        denom = torch.empty((n, M), dtype=torch.int32, device=G.x.device)
        numer = torch.empty_like(denom)
        flags = torch.empty((1, M), dtype=torch.int32, device=G.x.device)
        if M:
            AFF_PRE.launch(kernels.ptr(denom), kernels.ptr(numer), kernels.ptr(flags), kernels.ptr(x1),
                           sx1, kernels.ptr(y1), sy1, kernels.ptr(x2), sx2, kernels.ptr(y2), sy2,
                           kernels.ptr(i1), kernels.ptr(i2), self._one_words, self._a_words,
                           self.f.field_words(AFF_PRE), M, n=n, device=denom.device)
        return denom, numer, flags

    def pre_plain(self, G: AffineBatch, H: AffineBatch):
        denom, numer, flags = self._triage16(to16(G.x), to16(G.y), to16(H.x), to16(H.y), G.inf, H.inf)
        return from16(denom), from16(numer), flags[None]

    def post(self, G: AffineBatch, H: AffineBatch, dinv, numer, flags) -> AffineBatch:
        """Completion of the planar safe add: the sums as (n, M) planes and
        a bool (M,) mask: kernel `aff_post` on CUDA tensors."""
        n, M = self.f.n, G.count
        i1, i2 = _lane_mask(G.inf, M), _lane_mask(H.inf, M)
        MulCounter.record(G.x.shape, POST_MULS)
        if not kernels.on_cuda(*G, *H, dinv, numer, flags):
            return self.post_plain(G, H, dinv, numer, flags)
        (x1, sx1), (y1, sy1), (x2, sx2), (y2, sy2), (dv, sd), (nv, sn) = [
            kernels.lane_view(a, n, M) for a in (*G[:2], *H[:2], dinv, numer)]
        fv, _ = kernels.lane_view(flags, 1, M)
        x3 = torch.empty((n, M), dtype=torch.int32, device=G.x.device)
        y3 = torch.empty_like(x3)
        inf3 = torch.empty((M,), dtype=torch.bool, device=G.x.device)
        if M:
            AFF_POST.launch(kernels.ptr(x3), kernels.ptr(y3), kernels.ptr(inf3), kernels.ptr(x1), sx1,
                            kernels.ptr(y1), sy1, kernels.ptr(x2), sx2, kernels.ptr(y2), sy2,
                            kernels.ptr(dv), sd, kernels.ptr(nv), sn, kernels.ptr(fv), kernels.ptr(i1),
                            kernels.ptr(i2), self.f.field_words(AFF_POST), M, n=n, device=x3.device)
        return AffineBatch(x3, y3, inf3)

    def post_plain(self, G: AffineBatch, H: AffineBatch, dinv, numer, flags) -> AffineBatch:
        x3, y3, inf3 = self._complete16(to16(G.x), to16(G.y), to16(H.x), to16(H.y), to16(dinv),
                                        to16(numer), flags[0], G.inf, H.inf)
        return AffineBatch(from16(x3), from16(y3), inf3)

    def batch_add_unsafe(self, G: AffineBatch, H: AffineBatch, valid=None) -> AffineBatch:
        """Lane-wise G[i] + H[i] for valid lanes whose operands are finite
        with x1 != x2 (the caller's contract: one zero denominator poisons
        every lane). `valid`, an optional bool mask (*batch), excludes lanes
        from the shared inversion; their output is unspecified. The result's
        infinity mask is all False, as in the JAX package."""
        shape = _same_shape(G, H)
        if valid is not None and valid.shape != shape[1:]:
            raise ValueError(f"validity mask of shape {tuple(valid.shape)} for a batch {tuple(shape[1:])}")
        g, h = _flat(G), _flat(H)
        v = None if valid is None else valid.to(torch.bool).reshape(-1)
        dinv = self.f.batch_inv(self.pre_unsafe(g.x, h.x, v))
        x3, y3 = self.post_unsafe(g, h, dinv)
        return AffineBatch(x3.reshape(shape), y3.reshape(shape), torch.zeros_like(G.inf, dtype=torch.bool))

    def pre_unsafe(self, x1, x2, valid=None) -> torch.Tensor:
        """(n, M) denominators x2 - x1, R mod p where `valid` (bool (M,),
        optional) is False: kernel `aff_pre_unsafe` on CUDA tensors."""
        n, M = self.f.n, x1.shape[-1]
        if valid is not None:
            valid = _lane_mask(valid, M)
        if not kernels.on_cuda(x1, x2, *([] if valid is None else [valid])):
            return self.pre_unsafe_plain(x1, x2, valid)
        (a, sa), (b, sb) = kernels.lane_view(x1, n, M), kernels.lane_view(x2, n, M)
        vptr = None if valid is None else kernels.ptr(valid)
        out = torch.empty((n, M), dtype=torch.int32, device=x1.device)
        if M:
            AFF_PRE_UNSAFE.launch(kernels.ptr(out), kernels.ptr(a), sa, kernels.ptr(b), sb, vptr,
                                  self._one_words, self.f.field_words(AFF_PRE_UNSAFE), M, n=n,
                                  device=out.device)
        return out

    def pre_unsafe_plain(self, x1, x2, valid=None) -> torch.Tensor:
        F = self.f.plain
        d = F.sub(to16(x2), to16(x1))
        if valid is not None:
            d = FieldOps._sel(valid, d, F.const(self.f.R_mod_p, d))
        return from16(d)

    def post_unsafe(self, G: AffineBatch, H: AffineBatch, dinv) -> tuple[torch.Tensor, torch.Tensor]:
        """The chord of the planar unsafe add, (x3, y3) (n, M) planes:
        kernel `aff_post_unsafe` on CUDA tensors."""
        MulCounter.record(G.x.shape, POST_MULS)
        if not kernels.on_cuda(*G[:2], *H[:2], dinv):
            return self.post_unsafe_plain(G, H, dinv)
        n, M = self.f.n, G.count
        (x1, sx1), (y1, sy1), (x2, sx2), (y2, sy2), (dv, sd) = [
            kernels.lane_view(a, n, M) for a in (*G[:2], *H[:2], dinv)]
        x3 = torch.empty((n, M), dtype=torch.int32, device=G.x.device)
        y3 = torch.empty_like(x3)
        if M:
            AFF_POST_UNSAFE.launch(kernels.ptr(x3), kernels.ptr(y3), kernels.ptr(x1), sx1,
                                   kernels.ptr(y1), sy1, kernels.ptr(x2), sx2, kernels.ptr(y2), sy2,
                                   kernels.ptr(dv), sd, self.f.field_words(AFF_POST_UNSAFE), M, n=n,
                                   device=x3.device)
        return x3, y3

    def post_unsafe_plain(self, G: AffineBatch, H: AffineBatch, dinv):
        x3, y3 = self._chord16(to16(G.x), to16(G.y), to16(H.x), to16(H.y), to16(dinv))
        return from16(x3), from16(y3)

    def batch_double(self, G: AffineBatch) -> AffineBatch:
        """Lane-wise 2 G[i] with one shared inversion, tangent slope
        (3 x^2 + a) / 2y; infinity and y = 0 give infinity."""
        f = self.f
        bad = G.inf | f.is_zero(G.y)
        denom = f._sel(bad, f.const_plane(f.R_mod_p, G.x), f.add(G.y, G.y))
        dinv = f.batch_inv(denom)
        xx = f.square(G.x)
        num = f.add(f.add(xx, xx), xx)
        if not self.a_is_zero:
            num = f.add(num, f.const_plane(self.a_mont, num))
        lam = f.mul(num, dinv)
        x3 = f.sub(f.sub(f.square(lam), G.x), G.x)
        y3 = f.sub(f.mul(lam, f.sub(G.x, x3)), G.y)
        return AffineBatch(x3, y3, bad)

    def is_on_curve(self, A: AffineBatch) -> torch.Tensor:
        """Bool (N,): y^2 == x^3 + a x + b; the point at infinity passes.
        Two `mont_sqr` launches and one `mont_mul` on CUDA tensors, and a
        `mul_const` by a where a != 0."""
        f = self.f
        rhs = f.mul(f.square(A.x), A.x)
        if not self.a_is_zero:
            rhs = f.add(rhs, f.mul_const(A.x, self.a_mont))
        rhs = f.add(rhs, f.const_plane(self.b_mont, A.x))
        return f.is_equal(f.square(A.y), rhs) | A.inf


def _check_parent(inv1: torch.Tensor, M: int, h: int) -> None:
    """inv1 must be what `FieldOps.batch_inv_parent` gives for M lanes."""
    want = (M + 1) // 2 if h else M
    if h not in (0, M // 2) or inv1.shape[-1] != want:
        raise ValueError(f"parent inverses of width {inv1.shape[-1]} with h = {h} do not fit "
                         f"{M} lanes")


def _lane_mask(m: torch.Tensor, M: int) -> torch.Tensor:
    """A bool (M,) mask, contiguous, as the kernels read it (one byte a
    lane); ValueError for another dtype or shape."""
    if m.dtype != torch.bool or tuple(m.shape) != (M,):
        raise ValueError(f"expected a bool ({M},) mask, got {m.dtype} {tuple(m.shape)}")
    return m.contiguous()


def _same_shape(G: AffineBatch, H: AffineBatch) -> torch.Size:
    """The planes' common shape (n, *batch); ValueError unless both batches
    have it and masks of shape (*batch)."""
    shape = G.x.shape
    if any(a.shape != shape for a in (G.y, H.x, H.y)) or G.inf.shape != shape[1:] \
            or H.inf.shape != shape[1:]:
        raise ValueError(f"point batches of different shapes: {[tuple(a.shape) for a in (*G, *H)]}")
    return shape
