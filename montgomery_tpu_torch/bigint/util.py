"""Big-integer helpers of the oracle layer (the subset of
`montgomery_tpu/bigint/util.py` that the port uses)."""

from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def mod(x: int, p: int) -> int:
    """x mod p, always in [0, p)."""
    return x % p


def to_limbs(x: int, w: int, n: int) -> list[int]:
    """Split x into n w-bit limbs, little-endian."""
    mask = (1 << w) - 1
    return [(x >> (w * i)) & mask for i in range(n)]


def round_half_to_even_div(a: int, b: int) -> int:
    """round(a / b) with exact rational rounding (ties away from zero),
    for signed a, positive b. Used by GLV decomposition."""
    assert b > 0
    q, r = divmod(a, b)
    if 2 * r >= b:
        q += 1
    return q
