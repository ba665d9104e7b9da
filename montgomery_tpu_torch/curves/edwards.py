"""Twisted Edwards curve ops (a = -1) in extended coordinates over limb planes.

Counterpart of `montgomery_tpu/curves/edwards.py`. Points are
(X : Y : Z : T) with x = X/Z, y = Y/Z, T = XY/Z, each coordinate an
(n, *B) int32 plane in Montgomery form; the identity is (0 : 1 : 1 : 0). The
add is add-2008-hwcd-3, strongly unified (valid for P == Q and the
identity), so it is also the doubling and needs no masks.

Kernels (`csrc/`): `ed_add` (the planar add) and `ed_dbl` (k doublings in
one launch, the TPU's fori_loop of `ed_add`) in `ed_add.cu`, each with a
one-thread body for wide launches and a narrow-launch body (four threads
a lane) below `EdwardsOps.FEW_ADD_LANES` / `FEW_DBL_LANES` lanes,
`ed_add_packed` (the sign-applied add with pass-through on packed rows, every
accumulation round of the MSM) in `ed_add_packed.cu`, and `ed_combine` (the
MSM's window combine in one Horner launch, a block of cooperating warps) in
`ed_combine.cu`, over the shared device functions of `edwards.cuh`. Each
wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors.

The packed form keeps a point as ONE column of 4n int32 rows [X | Y | Z | T]
of whole 32-bit limbs (36 rows for ed-on-bls12-377, n = 9). The JAX package
packed two 13-bit limbs per row (40 rows); whole limbs need no 16-bit
packing, as in the affine packed rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..bigint.twisted_edwards import EdwardsParams, EdwardsPoint
from ..ops import kernels
from ..ops.field import FieldOps, MulCounter, from16, to16
from ..ops.limbs import to_words
from .projective import scale_by

_VP, _U32P, _INT = kernels.VP, kernels.U32P, kernels.INT

# planes out and in, k = 2d, the field words, the lane count and the body
# (few: 1 the narrow-launch body, four threads a lane)
ED_ADD = kernels.Kernel(
    "ed_add", {9: "msm_ed_add_n9"}, "montgomery_tpu_torch/csrc/ed_add.cu",
    "montgomery_tpu/curves/edwards.py:87",
    [_VP] * 12 + [_U32P, _U32P, _INT, _INT],
)
# the doubling of EdwardsAdapter.double_n, which the TPU ran as a fori_loop
# of the "ed_add" kernel
ED_DBL = kernels.Kernel(
    "ed_dbl", {9: "msm_ed_dbl_n9"}, "montgomery_tpu_torch/csrc/ed_add.cu",
    "montgomery_tpu/curves/edwards.py:87",
    [_VP] * 8 + [_INT, _U32P, _U32P, _INT, _INT],
)
ED_ADD_PACKED = kernels.Kernel(
    "ed_add_packed", {9: "msm_ed_add_packed_n9"}, "montgomery_tpu_torch/csrc/ed_add_packed.cu",
    "montgomery_tpu/curves/edwards.py:184",
    [_VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _U32P, _U32P, _INT],
)
ED_COMBINE = kernels.Kernel(
    "ed_combine", {9: "msm_ed_combine_n9"}, "montgomery_tpu_torch/csrc/ed_combine.cu",
    "montgomery_tpu/msm/pippenger.py:508",
    [_VP] * 8 + [_INT, _INT, _U32P, _U32P, _U32P, _INT],
)
# Montgomery products of one add (the JAX formula's 8 and 1 by k = 2d), for
# MulCounter
ADD_MULS = 9


class EdwardsBatch(NamedTuple):
    """Extended coordinates (X : Y : Z : T)."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor

    @property
    def count(self) -> int:
        return self.X.shape[-1]


class EdwardsOps:
    """a = -1 twisted Edwards arithmetic (every concrete Edwards curve)."""

    def __init__(self, fops: FieldOps, params: EdwardsParams):
        p = fops.p
        self.f, self.params = fops, params
        self.d_mont = params.d % p * fops.R % p
        self.k_mont = 2 * params.d % p * fops.R % p  # k = 2d
        self._k_words = kernels.words(to_words(self.k_mont, fops.n))
        # mu = -p^-1 mod R, all n words: the warp product's (csrc/coop.cuh)
        self._mu_words = kernels.words(to_words(-pow(p, -1, fops.R) % fops.R, fops.n))

    # ------------------------------------------------------------- structure

    def zero(self, N: int, device) -> EdwardsBatch:
        f = self.f
        z = f.zeros((N,), device)
        one = f.const_plane(f.R_mod_p, z).contiguous()
        return EdwardsBatch(z, one, one.clone(), z.clone())

    def zero_like(self, P: EdwardsBatch) -> EdwardsBatch:
        f = self.f
        one = f.const_plane(f.R_mod_p, P.Y)
        return EdwardsBatch(torch.zeros_like(P.X), one, one, torch.zeros_like(P.T))

    def is_zero(self, P: EdwardsBatch) -> torch.Tensor:
        """X == 0 and Y == Z."""
        return self.f.is_zero(P.X) & self.f.is_equal(P.Y, P.Z)

    def neg(self, P: EdwardsBatch) -> EdwardsBatch:
        f = self.f
        return EdwardsBatch(f.neg(P.X), P.Y, P.Z, f.neg(P.T))

    def select(self, mask, a: EdwardsBatch, b: EdwardsBatch) -> EdwardsBatch:
        s = self.f._sel
        return EdwardsBatch(*[s(mask, u, v) for u, v in zip(a, b)])

    # ------------------------------------------------------------ group law

    def _add16(self, P16, Q16):
        """add-2008-hwcd-3 on 16-bit limbs, as montgomery_tpu's _add_formula
        and csrc/edwards.cuh (the same lazy sums, so the same products)."""
        F = self.f.plain
        X1, Y1, Z1, T1 = P16
        X2, Y2, Z2, T2 = Q16
        A = F.mul(F.sub_lazy(Y1, X1), F.sub_lazy(Y2, X2))
        B = F.mul(F.add_lazy(Y1, X1), F.add_lazy(Y2, X2))
        ZZ = F.mul(Z1, Z2)
        C = F.mul(F.mul_const(T1, self.k_mont), T2)
        D = F.add_lazy(ZZ, ZZ)
        E, Fd = F.sub_lazy(B, A), F.sub_lazy(D, C)
        G, H = F.add_lazy(D, C), F.add_lazy(B, A)
        return F.mul(E, Fd), F.mul(G, H), F.mul(Fd, G), F.mul(E, H)

    # ed_add and ed_dbl launches on fewer lanes than these take the kernel's
    # narrow-launch body (csrc/ed_add.cu: four threads a lane), wider ones
    # the one-thread body. On an H100 the two cross between 20,480 lanes
    # (add 10.30 against 10.43 us, the doubling at k = 6 45.0 against 46.9)
    # and 40,960 (18.0 against 15.1; 83.9 against 70.7), PERF.md row 19
    FEW_ADD_LANES = 1 << 15
    FEW_DBL_LANES = 1 << 15

    def _launch(self, kernel, ins, extra, few: bool | None, threshold: int) -> EdwardsBatch:
        """One launch of a planar kernel over flattened planes; 4 planes out.
        Below `threshold` lanes the kernel's narrow-launch body unless `few`
        says otherwise."""
        shape = ins[0].shape
        n = self.f.n
        flat = [a.reshape(n, -1).contiguous() for a in ins]
        N = kernels.check_planes(n, *flat)
        outs = [torch.empty_like(flat[0]) for _ in range(4)]
        if few is None:
            few = N < threshold
        if N:
            kernel.launch(*[kernels.ptr(t) for t in outs + flat], *extra, self._k_words,
                          self.f.field_words(kernel), N, int(few), n=n, device=outs[0].device)
        return EdwardsBatch(*[o.reshape(shape) for o in outs])

    def add(self, P: EdwardsBatch, Q: EdwardsBatch, *, few: bool | None = None) -> EdwardsBatch:
        """Unified add (valid for P == Q and the identity): kernel `ed_add`
        on CUDA tensors, `add_plain` on CPU tensors. Below FEW_ADD_LANES
        lanes the kernel's narrow-launch body, with equal values; `few`
        picks the body instead."""
        MulCounter.record(P.X.shape, ADD_MULS)
        if not kernels.on_cuda(*P, *Q):
            return self.add_plain(P, Q)
        return self._launch(ED_ADD, [*P, *Q], (), few, self.FEW_ADD_LANES)

    def add_plain(self, P: EdwardsBatch, Q: EdwardsBatch) -> EdwardsBatch:
        P16 = [to16(a) for a in P]
        Q16 = [to16(a) for a in Q]
        return EdwardsBatch(*[from16(a) for a in self._add16(P16, Q16)])

    def double(self, P: EdwardsBatch) -> EdwardsBatch:
        return self.double_n(P, 1)

    def double_n(self, P: EdwardsBatch, k: int, *, few: bool | None = None) -> EdwardsBatch:
        """k doublings P <- P + P in one launch (k at run time): kernel
        `ed_dbl` on CUDA tensors, `double_n_plain` on CPU tensors. Below
        FEW_DBL_LANES lanes the kernel's narrow-launch body, with equal
        values; `few` picks the body instead."""
        if k <= 0:
            return P
        MulCounter.record(P.X.shape, k * ADD_MULS)
        if not kernels.on_cuda(*P):
            return self.double_n_plain(P, k)
        return self._launch(ED_DBL, list(P), (int(k),), few, self.FEW_DBL_LANES)

    def double_n_plain(self, P: EdwardsBatch, k: int) -> EdwardsBatch:
        P16 = [to16(a) for a in P]
        for _ in range(k):
            P16 = self._add16(P16, P16)
        return EdwardsBatch(*[from16(a) for a in P16])

    def combine(self, W: EdwardsBatch, c: int) -> EdwardsBatch:
        """S = sum_k 2^(c k) W_k over the last axis of planes (n, *B, K), in
        Horner order (acc = W_{K-1}; acc = 2^c acc + W_k for k = K-2 .. 0,
        each doubling the unified add of (P, P)): one `ed_combine` launch on
        CUDA tensors, `combine_plain` on CPU tensors. Returns planes
        (n, *B, 1); any W_k may be the identity."""
        K = W.X.shape[-1]
        if K < 1 or c < 1:
            raise ValueError(f"combine needs K >= 1 windows and c >= 1, got K = {K}, c = {c}")
        MulCounter.record(W.X.shape[:-1], (K - 1) * (c + 1) * ADD_MULS)
        if not kernels.on_cuda(*W):
            return self.combine_plain(W, c)
        n = self.f.n
        batch = W.X.shape[1:-1]
        flat = [a.reshape(n, -1).contiguous() for a in W]
        kernels.check_planes(n, *flat)
        N = flat[0].shape[-1] // K
        outs = [torch.empty((n, N), dtype=torch.int32, device=flat[0].device) for _ in range(4)]
        if N:
            ED_COMBINE.launch(*[kernels.ptr(t) for t in outs + flat], K, int(c), self._k_words,
                              self._mu_words, self.f.field_words(ED_COMBINE), N, n=n,
                              device=outs[0].device)
        return EdwardsBatch(*[o.reshape(n, *batch, 1) for o in outs])

    def combine_plain(self, W: EdwardsBatch, c: int) -> EdwardsBatch:
        """The Horner combine over `_add16`, in the kernel's order (the
        accumulator first in every add)."""
        K = W.X.shape[-1]
        acc = [to16(a[..., K - 1:K]) for a in W]
        for k in range(K - 2, -1, -1):
            for _ in range(c):
                acc = self._add16(acc, acc)
            acc = self._add16(acc, [to16(a[..., k:k + 1]) for a in W])
        return EdwardsBatch(*[from16(a) for a in acc])

    def sub(self, P: EdwardsBatch, Q: EdwardsBatch) -> EdwardsBatch:
        return self.add(P, self.neg(Q))

    def scale(self, k: int, P: EdwardsBatch) -> EdwardsBatch:
        """k P for a constant k: the doublings between set bits as one
        `ed_dbl` launch each (the cofactor 4 of ed-on-bls12-377 is one launch
        of two doublings). The same point as the JAX package's
        double-and-add with selects."""
        return scale_by(self, k, P)

    # ------------------------------------------------------------ packed form

    @property
    def packed_rows(self) -> int:
        return 4 * self.f.n

    def pack_rows(self, P: EdwardsBatch) -> torch.Tensor:
        """EdwardsBatch (M) -> (4n, M) int32 packed rows [X | Y | Z | T]."""
        return torch.cat(list(P), dim=0)

    def unpack_rows(self, A: torch.Tensor) -> EdwardsBatch:
        n = self.f.n
        return EdwardsBatch(A[:n], A[n:2 * n], A[2 * n:3 * n], A[3 * n:])

    def add_packed(self, A: torch.Tensor, B: torch.Tensor, sA: torch.Tensor, sB: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
        """Lane-wise packed add with pass-through: out[i] = sgn(A[i]) +
        sgn(B[i]) where valid[i], else sgn(A[i]); sgn negates X and T where
        the sign plane is set. sA, sB, valid: int32 (1, M) planes. Kernel
        `ed_add_packed` on CUDA tensors (one launch: the add is complete and
        needs no inversion)."""
        MulCounter.record(A.shape, ADD_MULS)
        if not kernels.on_cuda(A, B, sA, sB, valid):
            return self.add_packed_plain(A, B, sA, sB, valid)
        R, M = self.packed_rows, A.shape[-1]
        Av, sa = kernels.lane_view(A, R, M)
        Bv, sb = kernels.lane_view(B, R, M)
        sAv, sBv, hv = [kernels.lane_view(t, 1, M)[0] for t in (sA, sB, valid)]
        out = torch.empty((R, M), dtype=torch.int32, device=A.device)
        if M:
            ED_ADD_PACKED.launch(kernels.ptr(out), kernels.ptr(Av), sa, kernels.ptr(Bv), sb,
                                 kernels.ptr(sAv), kernels.ptr(sBv), kernels.ptr(hv), self._k_words,
                                 self.f.field_words(ED_ADD_PACKED), M, n=self.f.n,
                                 device=out.device)
        return out

    def _split_signed16(self, A: torch.Tensor, s: torch.Tensor):
        """Packed rows + sign plane -> the sign-applied point as 16-bit limbs."""
        F = self.f.plain
        X, Y, Z, T = [to16(a) for a in self.unpack_rows(A)]
        neg = s[0][None] != 0
        return torch.where(neg, F.neg(X), X), Y, Z, torch.where(neg, F.neg(T), T)

    def add_packed_plain(self, A, B, sA, sB, valid) -> torch.Tensor:
        P16 = self._split_signed16(A, sA)
        Q16 = self._split_signed16(B, sB)
        S16 = self._add16(P16, Q16)
        paired = valid[0][None] != 0
        return torch.cat([from16(torch.where(paired, s, p)) for s, p in zip(S16, P16)])

    # ---------------------------------------------------------- predicates

    def is_on_curve(self, P: EdwardsBatch) -> torch.Tensor:
        """Bool over the batch: (-X^2 + Y^2) Z^2 == Z^4 + d X^2 Y^2 and
        T Z == X Y, from three batched `mul`s (`mont_mul` on the card)."""
        f = self.f
        XX, YY, ZZ, TZ, XY = f.mul_list([(P.X, P.X), (P.Y, P.Y), (P.Z, P.Z), (P.T, P.Z), (P.X, P.Y)])
        d = f.const_plane(self.d_mont, XX)
        lhs, Z4, dXX = f.mul_list([(f.sub(YY, XX), ZZ), (ZZ, ZZ), (d, XX)])
        rhs = f.add(Z4, f.mul(dXX, YY))
        return f.is_equal(lhs, rhs) & f.is_equal(TZ, XY)

    def is_in_subgroup(self, P: EdwardsBatch) -> torch.Tensor:
        """Bool over the batch: order P == 0, through `scale` (the unified
        add is complete, so every point of the curve takes it)."""
        return self.is_zero(self.scale(self.params.order, P))

    def eq(self, P: EdwardsBatch, Q: EdwardsBatch) -> torch.Tensor:
        f = self.f
        a1, a2, b1, b2 = f.mul_list([(P.X, Q.Z), (Q.X, P.Z), (P.Y, Q.Z), (Q.Y, P.Z)])
        return f.is_equal(a1, a2) & f.is_equal(b1, b2)

    # ------------------------------------------------------------------ I/O

    def from_affine_arrays(self, x_mont: torch.Tensor, y_mont: torch.Tensor) -> EdwardsBatch:
        """Montgomery-form affine planes -> (x : y : 1 : x y); one `mul`."""
        f = self.f
        one = f.const_plane(f.R_mod_p, x_mont).contiguous()
        return EdwardsBatch(x_mont, y_mont, one, f.mul(x_mont, y_mont))

    def to_device(self, points: list[EdwardsPoint], device="cuda") -> EdwardsBatch:
        """Oracle points -> Montgomery-form EdwardsBatch on `device` (one
        to-Montgomery launch over both coordinates)."""
        N = len(points)
        both = self.f.pack([P.x for P in points] + [P.y for P in points], device=device, to_mont=True)
        return self.from_affine_arrays(both[:, :N], both[:, N:])

    def to_affine(self, P: EdwardsBatch) -> tuple[torch.Tensor, torch.Tensor]:
        """(x, y) = (X / Z, Y / Z) as (n, M) Montgomery planes on the device:
        one batch inversion of Z and one batched product."""
        f = self.f
        n = f.n
        X, Y, Z = [a.reshape(n, -1) for a in P[:3]]
        zinv = f.batch_inv(Z)
        x, y = f.mul_list([(X, zinv), (Y, zinv)])
        return x, y

    def to_host(self, P: EdwardsBatch) -> list[EdwardsPoint]:
        """Affine oracle points, normalised on the device (`to_affine`)."""
        if not P.X.numel():
            return []
        x, y = self.to_affine(P)
        xs = self.f.unpack(x, from_mont=True)
        ys = self.f.unpack(y, from_mont=True)
        return [EdwardsPoint(a, b) for a, b in zip(xs, ys)]

    def to_host_raw(self, P: EdwardsBatch) -> list[tuple[int, int, int, int]]:
        """Canonical (X, Y, Z, T) ints, no inversion."""
        f = self.f
        return list(zip(*[f.unpack(a.reshape(f.n, -1), from_mont=True) for a in P]))
