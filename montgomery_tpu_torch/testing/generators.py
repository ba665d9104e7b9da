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
