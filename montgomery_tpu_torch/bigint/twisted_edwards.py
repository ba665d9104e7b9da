"""Pure-Python twisted-Edwards curve oracle (a = -1).

A copy of `montgomery_tpu/bigint/twisted_edwards.py`.

Mirrors reference `src/bigint/twisted-edwards.ts`: -x^2 + y^2 = 1 + d x^2 y^2
with complete (strongly unified) addition; zero element is (0, 1).
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass

from .field import Field


@dataclass(frozen=True)
class EdwardsPoint:
    x: int
    y: int

    @staticmethod
    def zero() -> "EdwardsPoint":
        return EdwardsPoint(0, 1)

    @property
    def is_zero(self) -> bool:
        return self.x == 0 and self.y == 1


@dataclass(frozen=True)
class EdwardsParams:
    """(reference bigint/twisted-edwards.ts:8-15)"""

    label: str
    modulus: int
    order: int
    cofactor: int
    d: int
    generator: tuple[int, int]


class TwistedEdwardsCurve:
    """a = -1 twisted Edwards oracle. Addition is complete: no special cases."""

    def __init__(self, params: EdwardsParams):
        self.params = params
        self.field = Field(params.modulus)
        self.scalar_field = Field(params.order)
        self.d = params.d % params.modulus
        gx, gy = params.generator
        self.generator = EdwardsPoint(gx, gy)
        self.cofactor = params.cofactor

    def is_on_curve(self, P: EdwardsPoint) -> bool:
        F = self.field
        x2, y2 = F.square(P.x), F.square(P.y)
        lhs = F.sub(y2, x2)  # a = -1
        rhs = F.add(1, F.mul(self.d, F.mul(x2, y2)))
        return lhs == rhs

    def is_in_subgroup(self, P: EdwardsPoint) -> bool:
        return self.scale(self.params.order, P).is_zero

    def equal(self, P: EdwardsPoint, Q: EdwardsPoint) -> bool:
        return P.x == Q.x and P.y == Q.y

    def neg(self, P: EdwardsPoint) -> EdwardsPoint:
        return EdwardsPoint(self.field.neg(P.x), P.y)

    def add(self, P: EdwardsPoint, Q: EdwardsPoint) -> EdwardsPoint:
        F = self.field
        x1x2 = F.mul(P.x, Q.x)
        y1y2 = F.mul(P.y, Q.y)
        x1y2 = F.mul(P.x, Q.y)
        y1x2 = F.mul(P.y, Q.x)
        dxxyy = F.mul(self.d, F.mul(x1x2, y1y2))
        x3 = F.div(F.add(x1y2, y1x2), F.add(1, dxxyy))
        # a = -1:  y3 = (y1 y2 - a x1 x2) / (1 - d x1 x2 y1 y2)
        y3 = F.div(F.add(y1y2, x1x2), F.sub(1, dxxyy))
        return EdwardsPoint(x3, y3)

    def double(self, P: EdwardsPoint) -> EdwardsPoint:
        return self.add(P, P)

    def sub(self, P: EdwardsPoint, Q: EdwardsPoint) -> EdwardsPoint:
        return self.add(P, self.neg(Q))

    def scale(self, k: int, P: EdwardsPoint) -> EdwardsPoint:
        if k < 0:
            return self.scale(-k, self.neg(P))
        R = EdwardsPoint.zero()
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.double(P)
            k >>= 1
        return R

    def random_point(self, rng: _random.Random | None = None) -> EdwardsPoint:
        """Solve y^2 = (1 + x^2) / (1 - d x^2) for random x
        (reference curve-twisted-edwards.ts:269-312), then clear cofactor."""
        rng = rng or _random
        F = self.field
        while True:
            x = F.random(rng)
            x2 = F.square(x)
            denom = F.sub(1, F.mul(self.d, x2))
            if denom == 0:
                continue
            y2 = F.div(F.add(1, x2), denom)
            y = F.sqrt(y2)
            if y is None:
                continue
            if rng.random() < 0.5:
                y = F.neg(y)
            P = EdwardsPoint(x, y)
            if self.cofactor != 1:
                P = self.scale(self.cofactor, P)
                if P.is_zero:
                    continue
            return P

    def random_points(self, n: int, rng: _random.Random | None = None):
        return [self.random_point(rng) for _ in range(n)]
