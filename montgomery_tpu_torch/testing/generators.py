"""Adversarial random generators for field/scalar tests (a copy of
`montgomery_tpu/testing/generators.py`, which imports no JAX).

Mirror of the reference's `src/testing/random.ts` distributions
(random.ts:484-526): uniform values mixed with special/boundary values —
0, 1, 2, p-1, p-2, small uints, powers of two — plus an "unreduced" variant
drawing from [0, 2p) to exercise the lazy-reduction representation.
"""

from __future__ import annotations

import random as _random


def _special_values(p: int) -> list[int]:
    vals = [0, 1, 2, p - 1, p - 2, p // 2, p // 2 + 1]
    b = p.bit_length()
    vals += [1 << k for k in range(0, b, max(1, b // 8)) if (1 << k) < p]
    vals += [(1 << k) - 1 for k in range(1, b, max(1, b // 8)) if (1 << k) - 1 < p]
    return [v % p for v in vals]


def sample_field_elements(
    p: int, count: int, rng: _random.Random, unreduced: bool = False
) -> list[int]:
    """Draw `count` elements, ~60% uniform from [0, bound), ~40% adversarial.
    With unreduced=True the bound is 2p (lazy-reduced representation range)."""
    bound = 2 * p if unreduced else p
    specials = _special_values(p)
    if unreduced:
        specials = specials + [p + v for v in _special_values(p)] + [2 * p - 1, p]
    out = []
    for _ in range(count):
        if rng.random() < 0.4:
            out.append(specials[rng.randrange(len(specials))])
        else:
            out.append(rng.randrange(bound))
    return out


def sample_scalars(order: int, count: int, rng: _random.Random) -> list[int]:
    specials = [0, 1, 2, order - 1, order - 2]
    out = []
    for _ in range(count):
        if rng.random() < 0.25:
            out.append(specials[rng.randrange(len(specials))] % order)
        else:
            out.append(rng.randrange(order))
    return out


def glv_edge_scalars(gd, q: int, tol_bits: int = 20, per_constant: int = 4) -> list[int]:
    """Scalars in [0, q) at the edges of the device GLV decomposition `gd`
    (a scalar.device.GlvDevice): 0, 1, q - 1, q - 2, 2^252 (where below q),
    and for each of g1 and g2 the `per_constant` largest s < q whose
    s g / 2^m lies within 2^-tol_bits of an integer, from above or below:
    there the truncated product's guard limbs decide floor(s g / 2^m). They
    are denominators of the continued fraction of g / 2^m."""
    m = gd.m_limbs * gd.w
    mod = 1 << m
    out = [s for s in (0, 1, q - 1, q - 2, 1 << 252) if 0 <= s < q]
    for limbs in (gd.g1_limbs, gd.g2_limbs):
        g = sum(int(x) << (gd.w * j) for j, x in enumerate(limbs))
        near, num, den, prev, cur = [], g, mod, 0, 1
        while num and cur < q:
            a, (num, den) = den // num, (den % num, num)
            if (cur * g) % mod and min((cur * g) % mod, mod - (cur * g) % mod) < mod >> tol_bits:
                near.append(cur)
            prev, cur = cur, a * cur + prev
        out += near[-per_constant:]
    return out
