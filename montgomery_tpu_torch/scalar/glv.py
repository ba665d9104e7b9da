"""GLV scalar decomposition: s = s0 + s1*lambda (mod q), |s0|,|s1| ~ sqrt(q).

A copy of `montgomery_tpu/scalar/glv.py`: that package's `scalar/__init__.py`
imports its JAX device module, so the port carries the pure-Python lattice
precompute itself.

Re-implementation of the reference's lattice method (glv/glv.ts:21-50
egcdStopEarly + wasm/glv.ts glvGeneral): a half-GCD yields a short basis
V = [[v00, v01], [v10, v11]] with v0j + lambda*v1j = 0 (mod q); decomposition
rounds the rational solution of V c = (s, 0) and takes the residual.

Decomposition currently runs on host (python ints, vectorized batching is a
later optimization); the MSM consumes the halved digits plus the curve
endomorphism phi(P) = (beta x, y) = lambda * P.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bigint.util import round_half_to_even_div


def egcd_stop_early(l: int, q: int):
    """Half-GCD stopping when r^2 <= q; returns 2x2 short basis
    (reference glv/glv.ts:21-50)."""
    assert 0 < l < q
    r0, r1 = q, l
    t0, t1 = 0, 1
    while r1 * r1 > q:
        quotient = r0 // r1
        r0, r1 = r1, r0 - quotient * r1
        t0, t1 = t1, t0 - quotient * t1
    quotient = r0 // r1
    r2 = r0 - quotient * r1
    t2 = t0 - quotient * t1
    v00, v10 = r1, -t1
    if max(r0, abs(t0)) <= max(r2, abs(t2)):
        v01, v11 = r0, -t0
    else:
        v01, v11 = r2, -t2
    return (v00, v01), (v10, v11)


@dataclass(frozen=True)
class GlvParams:
    q: int
    lam: int
    v00: int
    v01: int
    v10: int
    v11: int
    det: int
    max_bits: int  # rigorous bound on bit length of |s0|, |s1|

    @property
    def half_bits(self) -> int:
        return self.max_bits


def glv_params(q: int, lam: int) -> GlvParams:
    (v00, v01), (v10, v11) = egcd_stop_early(lam, q)
    det = v00 * v11 - v01 * v10
    assert abs(det) == q, "short basis determinant must be +-q"
    # residual bound: |s0| <= (|v00| + |v01|) / 2 + 1, similarly s1
    # (rounding error of each c_j is <= 1/2; reference wasm/glv.ts:216-227)
    b0 = (abs(v00) + abs(v01)) // 2 + 1
    b1 = (abs(v10) + abs(v11)) // 2 + 1
    max_bits = max(b0.bit_length(), b1.bit_length())
    return GlvParams(q, lam, v00, v01, v10, v11, det, max_bits)


def decompose(g: GlvParams, s: int) -> tuple[int, int]:
    """s -> (s0, s1) with s0 + s1*lam = s (mod q), |si| < 2^max_bits."""
    s = s % g.q
    if g.det > 0:
        c1 = round_half_to_even_div(s * g.v11, g.det)
        c2 = round_half_to_even_div(-s * g.v10, g.det)
    else:
        c1 = round_half_to_even_div(-s * g.v11, -g.det)
        c2 = round_half_to_even_div(s * g.v10, -g.det)
    s0 = s - c1 * g.v00 - c2 * g.v01
    s1 = -c1 * g.v10 - c2 * g.v11
    return s0, s1


def decompose_batch(g: GlvParams, scalars) -> tuple[list[int], list[int]]:
    s0s, s1s = [], []
    for s in scalars:
        a, b = decompose(g, s)
        s0s.append(a)
        s1s.append(b)
    return s0s, s1s


def signed_digits_glv(g: GlvParams, scalars, c: int) -> np.ndarray:
    """(K, 2N) signed digits for the GLV-expanded point list [P..., phi(P)...]:
    column i carries digits of s0_i, column N+i carries digits of s1_i
    (signs folded into the digits; negating a scalar negates every digit)."""
    from .slicing import signed_digits

    s0s, s1s = decompose_batch(g, scalars)
    halves = s0s + s1s
    signs = np.array([-1 if v < 0 else 1 for v in halves], dtype=np.int32)
    mags = [abs(v) for v in halves]
    d = signed_digits(mags, g.max_bits, c)  # (K, 2N)
    return d * signs[None, :]
