"""Scalar window slicing with signed digits (a copy of
`montgomery_tpu/scalar/slicing.py`, which has no JAX dependency).

Host/numpy implementation of the reference's extractBitSlice + signed-digit
carry loop (wasm/field-helpers.ts:307-358, msm-batched-affine.ts:180-203):
scalars are cut into K windows of c bits; digits d > 2^(c-1) are replaced by
d - 2^c with a carry into the next window, so every digit lies in
[-2^(c-1), 2^(c-1)] and bucket count halves (signed buckets).

K = ceil((b+1)/c) windows cover b-bit scalars including the final carry
(reference msm-batched-affine.ts:90-92).
"""

from __future__ import annotations

import numpy as np


def num_windows(b_bits: int, c: int) -> int:
    return -(-(b_bits + 1) // c)


def unsigned_digits(scalars: list[int], b_bits: int, c: int) -> np.ndarray:
    """(K, N) int32 array of c-bit windows, little-endian windows."""
    K = num_windows(b_bits, c)
    N = len(scalars)
    out = np.empty((K, N), dtype=np.int32)
    mask = (1 << c) - 1
    for k in range(K):
        sh = k * c
        out[k] = np.fromiter(
            ((s >> sh) & mask for s in scalars), dtype=np.int32, count=N
        )
    return out


def signed_digits(scalars: list[int], b_bits: int, c: int) -> np.ndarray:
    """(K, N) int32 signed digits in [-2^(c-1), 2^(c-1)]."""
    d = unsigned_digits(scalars, b_bits, c)
    K, N = d.shape
    half = 1 << (c - 1)
    full = 1 << c
    carry = np.zeros(N, dtype=np.int32)
    for k in range(K):
        d[k] += carry
        carry = (d[k] > half).astype(np.int32)  # digits in (2^(c-1), 2^c]
        d[k] -= carry * full
    assert not carry.any(), "scalar overflow: need K = ceil((b+1)/c) windows"
    return d


def digits_to_scalar(digits: np.ndarray, c: int) -> list[int]:
    """Inverse of signed_digits (for tests)."""
    K, N = digits.shape
    return [sum(int(digits[k, j]) << (k * c) for k in range(K)) for j in range(N)]
