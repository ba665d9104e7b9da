"""Pure-Python big-integer finite field — the correctness oracle.

A copy of `montgomery_tpu/bigint/field.py`.

Slow, obviously-correct arithmetic mod p used as the ground truth for every
fast JAX/Pallas kernel, mirroring the role of the reference's bigint layer
(`src/bigint/field.ts`): every fast implementation is tested for equivalence
against this layer (reference bigint/README.md:7-11).
"""

from __future__ import annotations

import random as _random
from functools import cached_property

from .util import mod


class Field:
    """Finite field F_p with plain python-int arithmetic.

    API parity with reference src/bigint/field.ts (createField): mod, add, sub,
    negate, multiply, square, inverse, exp, sqrt, isSquare, random, equal.
    """

    def __init__(self, p: int):
        if p <= 1:
            raise ValueError("modulus must be > 1")
        self.p = p
        self.size_in_bits = p.bit_length()

    # --- basic ops ---
    def mod(self, x: int) -> int:
        return mod(x, self.p)

    def add(self, x: int, y: int) -> int:
        return (x + y) % self.p

    def sub(self, x: int, y: int) -> int:
        return (x - y) % self.p

    def neg(self, x: int) -> int:
        return (-x) % self.p

    def mul(self, x: int, y: int) -> int:
        return (x * y) % self.p

    def square(self, x: int) -> int:
        return (x * x) % self.p

    def inv(self, x: int) -> int:
        """Modular inverse; raises ZeroDivisionError on x == 0 (mod p).
        (reference bigint/field.ts `inverse`, via egcd — here python pow.)"""
        x = x % self.p
        if x == 0:
            raise ZeroDivisionError("inverse of 0")
        return pow(x, -1, self.p)

    def div(self, x: int, y: int) -> int:
        return self.mul(x, self.inv(y))

    def exp(self, x: int, k: int) -> int:
        return pow(x % self.p, k, self.p) if k >= 0 else pow(self.inv(x), -k, self.p)

    def equal(self, x: int, y: int) -> bool:
        return (x - y) % self.p == 0

    # --- square roots (Tonelli-Shanks), reference bigint/field.ts:94-156 ---
    @cached_property
    def _sqrt_params(self):
        # p - 1 = q * 2^M with q odd
        M, q = 0, self.p - 1
        while q % 2 == 0:
            q //= 2
            M += 1
        # find a non-square z
        z = 2
        while self.is_square(z):
            z += 1
        c = pow(z, q, self.p)  # generator of the 2-sylow subgroup
        return M, q, c

    def is_square(self, x: int) -> bool:
        x = x % self.p
        if x == 0:
            return True
        if self.p == 2:
            return True
        return pow(x, (self.p - 1) // 2, self.p) == 1

    def sqrt(self, x: int):
        """Square root of x, or None if x is a non-square.
        Returns the root r with r = min(r, p-r) for determinism in tests."""
        p = self.p
        x = x % p
        if x == 0:
            return 0
        if p == 2:
            return x
        if not self.is_square(x):
            return None
        if p % 4 == 3:
            r = pow(x, (p + 1) // 4, p)
        else:
            M, q, c = self._sqrt_params
            t = pow(x, q, p)
            r = pow(x, (q + 1) // 2, p)
            m = M
            while t != 1:
                # find least i with t^(2^i) = 1
                i, t2 = 0, t
                while t2 != 1:
                    t2 = (t2 * t2) % p
                    i += 1
                b = pow(c, 1 << (m - i - 1), p)
                m = i
                c = (b * b) % p
                t = (t * c) % p
                r = (r * b) % p
        return min(r, p - r)

    # --- randomness ---
    def random(self, rng: _random.Random | None = None) -> int:
        rng = rng or _random
        return rng.randrange(self.p)

    def __repr__(self):
        return f"Field(p=0x{self.p:x})"


def create_field(p: int) -> Field:
    return Field(p)
