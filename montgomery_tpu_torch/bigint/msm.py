"""Oracle multi-scalar multiplication (reference `src/bigint/msm.ts`).

A copy of `montgomery_tpu/bigint/msm.py`.

Simple Pippenger over any oracle curve exposing add/double/neg/scale and a
zero element — used as ground truth for all fast MSM paths.
"""

from __future__ import annotations


def msm_naive(curve, scalars, points):
    """Sum of scale(s_i, P_i); the most obviously correct MSM."""
    acc = type(points[0]).zero() if points else None
    assert acc is not None, "empty msm"
    for s, P in zip(scalars, points):
        acc = curve.add(acc, curve.scale(s, P))
    return acc


def msm(curve, scalars, points, c: int | None = None):
    """Unsigned-window Pippenger (reference bigint/msm.ts:8-53).

    curve: oracle curve (WeierstrassCurve or TwistedEdwardsCurve)
    scalars: list[int], points: list of that curve's point type.
    """
    assert len(scalars) == len(points) and len(points) > 0
    zero = type(points[0]).zero()
    b = max(s.bit_length() for s in scalars) or 1
    n = len(points)
    if c is None:
        # rough window heuristic, same spirit as reference msm-common windowSize
        c = max(1, min(16, n.bit_length() - 1 or 1))
    K = -(-b // c)  # number of windows
    L = (1 << c) - 1  # buckets per window (bucket 0 unused)

    window_sums = []
    for k in range(K):
        buckets = [zero] * (L + 1)
        shift = k * c
        for s, P in zip(scalars, points):
            digit = (s >> shift) & L
            if digit:
                buckets[digit] = curve.add(buckets[digit], P)
        # triangle + row: sum_l l * B_l via suffix sums
        run = zero
        total = zero
        for l in range(L, 0, -1):
            run = curve.add(run, buckets[l])
            total = curve.add(total, run)
        window_sums.append(total)

    # horner combine: S = sum_k 2^(ck) S_k
    acc = window_sums[-1]
    for k in range(K - 2, -1, -1):
        for _ in range(c):
            acc = curve.double(acc)
        acc = curve.add(acc, window_sums[k])
    return acc
