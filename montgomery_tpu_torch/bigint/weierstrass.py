"""Pure-Python short-Weierstrass curve oracle (affine + projective).

A copy of `montgomery_tpu/bigint/weierstrass.py`.

Mirrors reference `src/bigint/affine-weierstrass.ts` and
`src/bigint/projective-weierstrass.ts`: complete, slow, obviously-correct
add/double/scale/is_on_curve/random used as ground truth for curve kernels.

Curves supported here have a = 0 (y^2 = x^3 + b), matching all concrete curves
in the reference (BLS12-377/381, Pallas), though general `a` is handled.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass

from .field import Field


@dataclass(frozen=True)
class AffinePoint:
    """Affine point; is_zero marks the point at infinity (x, y ignored)."""

    x: int
    y: int
    is_zero: bool = False

    @staticmethod
    def zero() -> "AffinePoint":
        return AffinePoint(0, 0, True)


@dataclass(frozen=True)
class Endomorphism:
    beta: int  # cube root of 1 in F_p:  phi(x, y) = (beta x, y)
    lam: int  # cube root of 1 in F_q:  phi(P) = lambda * P


@dataclass(frozen=True)
class CurveParams:
    """Weierstrass curve parameter record (reference bigint/affine-weierstrass.ts:8-20)."""

    label: str
    modulus: int  # base field p
    order: int  # subgroup order q
    cofactor: int
    a: int
    b: int
    generator: tuple[int, int]
    endomorphism: Endomorphism | None = None


class WeierstrassCurve:
    """y^2 = x^3 + a x + b over F_p, affine oracle arithmetic."""

    def __init__(self, params: CurveParams):
        self.params = params
        self.field = Field(params.modulus)
        self.scalar_field = Field(params.order)
        self.a = params.a % params.modulus
        self.b = params.b % params.modulus
        gx, gy = params.generator
        self.generator = AffinePoint(gx, gy)
        self.cofactor = params.cofactor

    # --- predicates ---
    def is_on_curve(self, P: AffinePoint) -> bool:
        if P.is_zero:
            return True
        F = self.field
        lhs = F.square(P.y)
        rhs = F.add(F.add(F.mul(F.square(P.x), P.x), F.mul(self.a, P.x)), self.b)
        return lhs == rhs

    def is_in_subgroup(self, P: AffinePoint) -> bool:
        return self.scale(self.params.order, P).is_zero

    def equal(self, P: AffinePoint, Q: AffinePoint) -> bool:
        if P.is_zero or Q.is_zero:
            return P.is_zero and Q.is_zero
        return P.x == Q.x and P.y == Q.y

    # --- group law ---
    def neg(self, P: AffinePoint) -> AffinePoint:
        if P.is_zero:
            return P
        return AffinePoint(P.x, self.field.neg(P.y))

    def double(self, P: AffinePoint) -> AffinePoint:
        if P.is_zero:
            return P
        F = self.field
        if P.y == 0:
            return AffinePoint.zero()
        m = F.div(F.add(F.mul(3, F.square(P.x)), self.a), F.mul(2, P.y))
        x3 = F.sub(F.square(m), F.mul(2, P.x))
        y3 = F.sub(F.mul(m, F.sub(P.x, x3)), P.y)
        return AffinePoint(x3, y3)

    def add(self, P: AffinePoint, Q: AffinePoint) -> AffinePoint:
        if P.is_zero:
            return Q
        if Q.is_zero:
            return P
        F = self.field
        if P.x == Q.x:
            if F.equal(P.y, F.neg(Q.y)):
                return AffinePoint.zero()
            return self.double(P)
        m = F.div(F.sub(Q.y, P.y), F.sub(Q.x, P.x))
        x3 = F.sub(F.sub(F.square(m), P.x), Q.x)
        y3 = F.sub(F.mul(m, F.sub(P.x, x3)), P.y)
        return AffinePoint(x3, y3)

    def sub(self, P: AffinePoint, Q: AffinePoint) -> AffinePoint:
        return self.add(P, self.neg(Q))

    def scale(self, k: int, P: AffinePoint) -> AffinePoint:
        """double-and-add scalar multiplication (reference affine-weierstrass scale)."""
        if k < 0:
            return self.scale(-k, self.neg(P))
        R = AffinePoint.zero()
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.double(P)
            k >>= 1
        return R

    def endomorphism(self, P: AffinePoint) -> AffinePoint:
        """GLV endomorphism (x, y) -> (beta x, y) = lambda * (x, y)."""
        endo = self.params.endomorphism
        assert endo is not None, "curve has no endomorphism params"
        if P.is_zero:
            return P
        return AffinePoint(self.field.mul(endo.beta, P.x), P.y)

    # --- random points (sqrt trial + cofactor clearing),
    #     reference curve-affine.ts:155-190 ---
    def random_point(self, rng: _random.Random | None = None) -> AffinePoint:
        rng = rng or _random
        F = self.field
        while True:
            x = F.random(rng)
            y2 = F.add(F.add(F.mul(F.square(x), x), F.mul(self.a, x)), self.b)
            y = F.sqrt(y2)
            if y is None:
                continue
            if rng.random() < 0.5:
                y = F.neg(y)
            P = AffinePoint(x, y)
            if self.cofactor != 1:
                P = self.scale(self.cofactor, P)
                if P.is_zero:
                    continue
            return P

    def random_points(self, n: int, rng: _random.Random | None = None):
        return [self.random_point(rng) for _ in range(n)]


# --- projective oracle (X:Y:Z), reference bigint/projective-weierstrass.ts ---


@dataclass(frozen=True)
class ProjectivePoint:
    X: int
    Y: int
    Z: int

    @staticmethod
    def zero() -> "ProjectivePoint":
        return ProjectivePoint(0, 1, 0)

    @property
    def is_zero(self) -> bool:
        return self.Z == 0


class ProjectiveWeierstrass:
    """Projective-coordinate oracle over the same curve, for testing the
    projective kernel's coordinate-level semantics."""

    def __init__(self, curve: WeierstrassCurve):
        self.curve = curve
        self.field = curve.field

    def from_affine(self, P: AffinePoint) -> ProjectivePoint:
        if P.is_zero:
            return ProjectivePoint.zero()
        return ProjectivePoint(P.x, P.y, 1)

    def to_affine(self, P: ProjectivePoint) -> AffinePoint:
        if P.is_zero:
            return AffinePoint.zero()
        F = self.field
        zinv = F.inv(P.Z)
        return AffinePoint(F.mul(P.X, zinv), F.mul(P.Y, zinv))

    def equal(self, P: ProjectivePoint, Q: ProjectivePoint) -> bool:
        F = self.field
        if P.is_zero or Q.is_zero:
            return P.is_zero and Q.is_zero
        return F.mul(P.X, Q.Z) == F.mul(Q.X, P.Z) and F.mul(P.Y, Q.Z) == F.mul(
            Q.Y, P.Z
        )

    def add(self, P: ProjectivePoint, Q: ProjectivePoint) -> ProjectivePoint:
        # oracle semantics via affine round-trip (slow but trivially correct)
        A = self.curve.add(self.to_affine(P), self.to_affine(Q))
        return self.from_affine(A)

    def double(self, P: ProjectivePoint) -> ProjectivePoint:
        return self.from_affine(self.curve.double(self.to_affine(P)))

    def scale(self, k: int, P: ProjectivePoint) -> ProjectivePoint:
        return self.from_affine(self.curve.scale(k, self.to_affine(P)))
